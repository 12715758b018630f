// ALPH chunk decode, native host layer: the inverse of the alpha plane's
// spatial filter (WebP container spec, "Alpha": none, horizontal,
// vertical, gradient), in place, mod 256.  The gradient filter is a
// per-pixel raster recurrence (each pixel's predictor reads its
// reconstructed left neighbour), so it runs here rather than in numpy.
//
// Build: g++ -O3 -fPIC -shared (see native_loader.py).

#include <cstdint>

extern "C" {

// data: (height, width) uint8, filtered on input, reconstructed on
// output.  method: 1 horizontal, 2 vertical, 3 gradient (the header's
// two filter bits; 0, none, needs no call).
void wtpu_alpha_unfilter(uint8_t* data, int width, int height, int method) {
  for (int x = 1; x < width; x++) data[x] = (uint8_t)(data[x] + data[x - 1]);
  for (int y = 1; y < height; y++) {
    uint8_t* row = data + (int64_t)y * width;
    const uint8_t* above = row - width;
    if (method == 2) {                       // vertical: from above
      for (int x = 0; x < width; x++) row[x] = (uint8_t)(row[x] + above[x]);
      continue;
    }
    row[0] = (uint8_t)(row[0] + above[0]);   // first column: from above
    if (method == 1) {                       // horizontal: from the left
      for (int x = 1; x < width; x++) row[x] = (uint8_t)(row[x] + row[x - 1]);
    } else {                                 // gradient, clipped
      for (int x = 1; x < width; x++) {
        int g = row[x - 1] + above[x] - above[x - 1];
        g = g < 0 ? 0 : (g > 255 ? 255 : g);
        row[x] = (uint8_t)(row[x] + g);
      }
    }
  }
}

}  // extern "C"
