"""Tests of the benchmark harness.  Run from the repo root:

    python -m pytest webpbench/tests -q

Tests marked ``cuda`` need the card and skip without one."""

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

LIBWEBP = {"encoder": "libwebp (Pillow)", "libwebp_version": "1.6.0",
           "quality": 75, "method": 4}
# tiny pools of the files a configuration can now state, as overrides of a
# decode cell's configuration and mix: (config_override, traffic_override)
POOLS = {
    "mixed-sizes": ({"image": {"sizes": [[48, 64], [17, 9], [33, 50]],
                               "channels": 3}},
                    {"pool": 3, "batch": 9}),
    "rgba-cutout": ({"image": {"height": 48, "width": 64, "channels": 4,
                               "alpha": "cutout"},
                     "decode_files": {**LIBWEBP, "alpha_quality": 100}},
                    {"pool": 2, "batch": 4}),
    "lossless": ({"image": {"height": 48, "width": 64, "channels": 3},
                  "decode_files": {**LIBWEBP, "lossless": True}},
                 {"pool": 2, "batch": 4}),
}


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs a CUDA card (skips without one)")
