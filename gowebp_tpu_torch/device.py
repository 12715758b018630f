"""Device policy and per-stage device timing shared by the entry points."""

from __future__ import annotations

import time

import torch


def resolve_device(device=None) -> torch.device:
    """None means CUDA.  A CUDA device without CUDA raises: the CPU runs
    only when the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "torch versions of the kernels")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class StageClock:
    """Stage boundaries of one batch: CUDA events on the current stream
    (device time), or the host clock on the CPU (which computes
    synchronously)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.names, self.stamps = [], []
        self("start")

    def __call__(self, name: str) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.stamps.append(ev)
        else:
            self.stamps.append(time.perf_counter())
        self.names.append(name)

    def spans_ms(self) -> dict:
        """Milliseconds per stage; call once the stream passed the last
        mark."""
        if self.cuda:
            self.stamps[-1].synchronize()
            ms = [a.elapsed_time(b) for a, b in zip(self.stamps, self.stamps[1:])]
        else:
            ms = [(b - a) * 1e3 for a, b in zip(self.stamps, self.stamps[1:])]
        return dict(zip(self.names[1:], ms))


__all__ = ["StageClock", "resolve_device"]
