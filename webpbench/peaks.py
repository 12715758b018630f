"""The card's ceilings that a kernel's roofline share is taken against.

HBM bandwidth of one H100 SXM at its full 700 W (NVIDIA's data sheet).  The
32-bit integer ceiling is computed from the card: an H100 SM executes 64 int32
operations a clock, half its 128 FP32 lanes (NVIDIA's Hopper whitepaper), at
the card's maximum SM clock as nvidia-smi reads it.  The codec's kernels are
integer code, so these two bound them.
"""

from __future__ import annotations

import functools

from .bench import nvidia_smi

PEAK_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64


@functools.lru_cache(maxsize=None)
def int32_ops_per_s() -> float:
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(nvidia_smi("clocks.max.sm"))
    return sms * INT32_LANES_PER_SM * mhz * 1e6


def bound_s(ops: float, nbytes: float, ops_per_s: float | None = None):
    """(least seconds the card could take, "operations" or "bytes")."""
    t_ops = ops / (ops_per_s or int32_ops_per_s())
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
