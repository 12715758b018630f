"""The codec's parameters as the port's tensors.

The codec has no learned weights.  What the dense device stage takes
besides pixels is: the token cost tables (tp0, tp1, tval), per-image
quantizer steps (B, 4, 6), per-MB segment maps (B, mh, mw) and
per-image, per-segment i4 RD penalties (B, 4).  The host computes them
as NumPy arrays; this turns them into int32 tensors on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a, np.int32))
    if torch.device(device).type == "cuda":
        # from pinned memory the h2d is enqueued without waiting for the
        # work already on the stream
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def params_from_numpy(tables, qsteps, seg_maps, pens, *, device):
    """NumPy (tables, qsteps, seg_maps, pens) → int32 tensors on device.

    Returns ((tp0, tp1, tval), qsteps (B,4,6), seg_maps (B,mh,mw),
    pens (B,4)).
    """
    qsteps = np.asarray(qsteps)
    seg_maps = np.asarray(seg_maps)
    pens = np.asarray(pens)
    if qsteps.ndim != 3 or qsteps.shape[1:] != (4, 6):
        raise ValueError(f"qsteps must be (B, 4, 6), got {qsteps.shape}")
    B = qsteps.shape[0]
    if seg_maps.ndim != 3 or seg_maps.shape[0] != B:
        raise ValueError(f"seg_maps must be (B, mh, mw), got {seg_maps.shape}")
    if pens.shape != (B, 4):
        raise ValueError(f"pens must be ({B}, 4), got {pens.shape}")
    return (tuple(_t(t, device) for t in tables), _t(qsteps, device),
            _t(seg_maps, device), _t(pens, device))


__all__ = ["params_from_numpy"]
