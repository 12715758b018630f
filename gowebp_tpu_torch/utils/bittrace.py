"""Bit accounting of a WebP stream by syntax class (libwebp's BITTRACE).

``bit_accounting(data)`` parses the file's image once on the host and
reports how many bits each syntax class consumed, for debugging rate
control and comparing encoders::

    from gowebp_tpu_torch.utils.bittrace import bit_accounting
    report = bit_accounting(webp_bytes)
    # {'format': 'lossy', 'total_bits': ..., 'classes': {...}, ...}

Host parsing only (the Python MB parse of models/vp8/decoder.py, the
VP8L header parse and native pixel loop): no device.
"""

from __future__ import annotations

from ..constants import CHUNK_VP8, CHUNK_VP8L
from ..container.riff import parse_riff


def _trace_vp8(payload: bytes) -> dict:
    from ..models.vp8.decoder import (_bitpos, _parse_frame_mbs,
                                      parse_frame_header)

    st, bd = parse_frame_header(payload)
    trace = {"frame_header": _bitpos(bd), "intra_modes": 0,
             "residuals": [0] * len(st.partition_bytes)}
    _parse_frame_mbs(st, bd, trace)
    classes = {
        "frame_header": trace["frame_header"],
        "intra_modes": trace["intra_modes"],
        "residuals": sum(trace["residuals"]),
    }
    return {
        "format": "lossy",
        "total_bits": 8 * len(payload),
        "classes": classes,
        "residuals_per_partition": trace["residuals"],
    }


def _trace_vp8l(payload: bytes) -> dict:
    from ..entropy.bitio import BitReader
    from ..models.vp8l import decoder as d

    width, height, _ = d.decode_vp8l_header(payload)
    br = BitReader(payload[1:])
    br.skip_bits(14 + 14 + 1 + 3)
    trace: dict = {}
    hdr = d._parse_stream_header(br, width, height, top_level=True,
                                 trace=trace)
    p0 = br.bit_pos
    d._decode_pixels(br, hdr.cur_xsize, height, hdr.lengths,
                     hdr.huffman_image, hdr.huffman_bits, hdr.cache_bits)
    classes = {
        "image_header": 8 + 32,   # signature byte + size, alpha, version
        "transforms": trace["transforms"],
        "meta_huffman": trace["meta_huffman"],
        "huffman_codes": trace["huffman_codes"],
        "pixel_data": br.bit_pos - p0,
    }
    return {
        "format": "lossless",
        "total_bits": 8 * len(payload),
        "classes": classes,
    }


def bit_accounting(data: bytes) -> dict:
    """Account the bits of a .webp file's image by syntax class.

    Lossy: frame_header, intra_modes, residuals (and, apart, the
    residuals of each token partition).  Lossless: image_header,
    transforms, meta_huffman, huffman_codes, pixel_data.  Values are
    the bits the decoder consumed; the rest of ``total_bits`` (the image
    chunk's payload) is padding.  A file with no VP8 or VP8L chunk
    raises ValueError.
    """
    parsed = parse_riff(data)
    vp8l = parsed.find(CHUNK_VP8L)
    if vp8l is not None:
        return _trace_vp8l(vp8l.payload)
    vp8 = parsed.find(CHUNK_VP8)
    if vp8 is not None:
        return _trace_vp8(vp8.payload)
    raise ValueError("no VP8/VP8L image chunk to trace")


__all__ = ["bit_accounting"]
