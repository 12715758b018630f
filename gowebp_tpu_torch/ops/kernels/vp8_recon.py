"""The lossy decode's reconstruction and loop filter: the Hopper kernel,
its binding and its plain version.

``recon_filter_mb`` turns dequantized coefficients, modes and filter
parameters into the reconstructed, deblocked uint8 planes: residual iDCT,
intra prediction and the in-loop filter over the MB wavefront, each MB
filtered right after its recon.  On a CUDA tensor it launches the one
kernel in ``vp8_recon.cu`` (replacing the XLA ``recon_wavefront`` and
``loop_filter_wavefront`` of gowebp_tpu/ops/vp8_recon_jax.py); on a CPU
tensor it runs its plain version, ``recon_mb_plain`` followed by
``loop_filter_mb_plain`` (the torch loops of ops/vp8_recon.py).

``recon_filter_mb_stripe`` decodes one stripe of MB rows of a frame split
over devices (parallel/shard.py ``sharded_recon_frame``): below another
stripe, its MB row 0 predicts from that stripe's unfiltered bottom row
and filters its top edge against that stripe's 4 filtered bottom rows,
and it returns the 3 of those rows its filters changed (to send back up)
and its own bottom rows (the halo of the stripe below).

Layout:
  coeffs   (B, N, 24, 16) int16 dequantized raster coefficients,
           N = mb_h * mb_w
  modes    (B, N, 18) uint8: is_i4, uvmode, imodes x16 (``pack_modes``)
  fparams  (B, N, 4) or (B, mb_h, mb_w, 4) int: limit, ilevel, hev_t, inner
  y        (B, 16 mb_h, 16 mb_w) uint8; u, v (B, 8 mb_h, 8 mb_w) uint8
"""

from __future__ import annotations

import ctypes

import torch

from .. import vp8_recon as plain
from .cuda_build import CudaLibrary, check_tensor, stream_handle

U8, I16, I32 = torch.uint8, torch.int16, torch.int32
MODE_BYTES = 18


def _configure(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.recon_filter_mb_launch.restype = ctypes.c_int
    lib.recon_filter_mb_launch.argtypes = [p] * 8 + [i] * 5 + [p] * 3


LIBRARY = CudaLibrary("vp8_recon.cu", _configure)


def pack_modes(is_i4, imodes, uvmode):
    """(B, N) is_i4, (B, N, 16) imodes, (B, N) uvmode → the kernel's
    (B, N, 18) uint8 modes."""
    return torch.cat([is_i4[..., None], uvmode[..., None], imodes],
                     dim=-1).to(U8).contiguous()


def _check_recon(coeffs, modes, mb_w: int, mb_h: int) -> None:
    if mb_w <= 0 or mb_h <= 0:
        raise ValueError(f"recon_filter_mb: bad MB grid {mb_w}x{mb_h}")
    N = mb_w * mb_h
    if coeffs.dim() != 4 or coeffs.shape[1:] != (N, 24, 16):
        raise ValueError(f"recon_filter_mb: coeffs must be (B, {N}, 24, 16), "
                         f"got {tuple(coeffs.shape)}")
    if modes.shape != (coeffs.shape[0], N, MODE_BYTES):
        raise ValueError(f"recon_filter_mb: modes must be (B, {N}, "
                         f"{MODE_BYTES}), got {tuple(modes.shape)}")


def _planes(B: int, mb_w: int, mb_h: int, dev):
    return (torch.empty((B, 16 * mb_h, 16 * mb_w), dtype=U8, device=dev),
            torch.empty((B, 8 * mb_h, 8 * mb_w), dtype=U8, device=dev),
            torch.empty((B, 8 * mb_h, 8 * mb_w), dtype=U8, device=dev))


def _sync(rows: int, dev):
    """Zeroed progress counters (one per MB row) and the row ticket."""
    return torch.zeros(rows + 1, dtype=I32, device=dev)


def recon_mb_plain(coeffs, modes, mb_w: int, mb_h: int):
    """The plain version's first half (any device): the residual iDCT and
    ops/vp8_recon.py's ``recon_wavefront`` → the unfiltered (Y, U, V)."""
    _check_recon(coeffs, modes, mb_w, mb_h)
    dg = plain.Diagonals(mb_w, mb_h, coeffs.device)
    m = modes.to(I32)
    PY, PC = plain.recon_wavefront(*plain.residual_blocks(coeffs.to(I32)),
                                   m[..., 0], m[..., 2:], m[..., 1], dg)
    return plain.crop_planes(PY, PC, mb_w)


def _check_fparams(fparams, B: int, mb_w: int, mb_h: int,
                   filter_type: int) -> None:
    if filter_type not in (0, 1, 2):
        raise ValueError(f"recon_filter_mb: filter_type must be 0, 1 or 2, "
                         f"got {filter_type}")
    if fparams.numel() != B * mb_h * mb_w * 4 or fparams.shape[-1] != 4:
        raise ValueError(f"recon_filter_mb: fparams {tuple(fparams.shape)} "
                         f"is not (B, {mb_h}, {mb_w}, 4)")


def _check_filter(y, u, v, fparams, mb_w: int, mb_h: int, filter_type: int):
    B = y.shape[0]
    if y.shape != (B, 16 * mb_h, 16 * mb_w):
        raise ValueError(f"loop_filter_mb_plain: y {tuple(y.shape)} is not "
                         f"(B, {16 * mb_h}, {16 * mb_w})")
    for name, c in (("u", u), ("v", v)):
        if c.shape != (B, 8 * mb_h, 8 * mb_w):
            raise ValueError(f"loop_filter_mb_plain: {name} "
                             f"{tuple(c.shape)} is not (B, {8 * mb_h}, "
                             f"{8 * mb_w})")
    _check_fparams(fparams, B, mb_w, mb_h, filter_type)


def loop_filter_mb_plain(y, u, v, fparams, mb_w: int, mb_h: int,
                         filter_type: int):
    """The plain version's second half (any device): ops/vp8_recon.py's
    ``loop_filter_wavefront`` on bordered copies, written back into the
    planes.  Returns (y, u, v)."""
    _check_filter(y, u, v, fparams, mb_w, mb_h, filter_type)
    if filter_type == 0:
        return y, u, v
    B, P, dev = y.shape[0], plain.PAD, y.device
    PY = plain._bordered(B, 16 * mb_h, 16 * mb_w, dev)
    PC = plain._bordered(2 * B, 8 * mb_h, 8 * mb_w, dev)
    PY[:, P:, P:P + 16 * mb_w] = y
    PC[:B, P:, P:P + 8 * mb_w] = u
    PC[B:, P:, P:P + 8 * mb_w] = v
    plain.loop_filter_wavefront(
        PY, PC, fparams.reshape(B, mb_h, mb_w, 4),
        plain.Diagonals(mb_w, mb_h, dev), filter_type)
    Y, U, V = plain.crop_planes(PY, PC, mb_w)
    y.copy_(Y)
    u.copy_(U)
    v.copy_(V)
    return y, u, v


def _check(coeffs, modes, fparams, mb_w: int, mb_h: int,
           filter_type: int) -> None:
    _check_recon(coeffs, modes, mb_w, mb_h)
    _check_fparams(fparams, coeffs.shape[0], mb_w, mb_h, filter_type)


def recon_filter_mb_plain(coeffs, modes, fparams, mb_w: int, mb_h: int,
                          filter_type: int):
    """Plain torch version of the kernel (any device): the recon, then the
    filter over the whole frame → (Y, U, V) uint8 planes."""
    _check(coeffs, modes, fparams, mb_w, mb_h, filter_type)
    return loop_filter_mb_plain(*recon_mb_plain(coeffs, modes, mb_w, mb_h),
                                fparams, mb_w, mb_h, filter_type)


def _launch(coeffs, modes, fparams, mb_w: int, mb_h: int, filter_type: int,
            stripe: bool = False, above=None):
    """One launch of the kernel (its stripe form with ``stripe``) → the
    planes (y, u, v), the top-samples buffer and, with ``above``, the
    filtered rows buffer the kernel wrote back into."""
    dev = coeffs.device
    if dev.type != "cuda":
        raise ValueError(f"recon_filter_mb: unsupported device {dev}")
    _check(coeffs, modes, fparams, mb_w, mb_h, filter_type)
    B = coeffs.shape[0]
    check_tensor("coeffs", coeffs, I16, coeffs.shape, dev)
    check_tensor("modes", modes, U8, modes.shape, dev)
    fp = fparams.reshape(B, mb_h * mb_w, 4).to(I16).contiguous()
    check_tensor("fparams", fp, I16, fp.shape, dev)
    lib = LIBRARY.load()
    y, u, v = _planes(B, mb_w, mb_h, dev)
    # top samples: each MB row's unfiltered bottom row, Y then U then V
    ts = torch.empty(B * mb_h * 32 * mb_w, dtype=U8, device=dev)
    sync = _sync(B * mb_h, dev)
    hts = hf = None
    if above is not None:
        hts, hf = _halo_buffers(above, B, mb_w, dev)
    err = lib.recon_filter_mb_launch(
        coeffs.data_ptr(), modes.data_ptr(), fp.data_ptr(), y.data_ptr(),
        u.data_ptr(), v.data_ptr(), ts.data_ptr(), sync.data_ptr(), B, mb_h,
        mb_w, int(filter_type), int(stripe),
        None if hts is None else hts.data_ptr(),
        None if hf is None else hf.data_ptr(), stream_handle(dev))
    if err != 0:
        raise RuntimeError(
            f"recon_filter_mb kernel launch failed: CUDA error {err}")
    recon_filter_mb.launches += 1
    recon_filter_mb.stripe_launches += stripe
    return (y, u, v), ts, hf


def recon_filter_mb(coeffs, modes, fparams, mb_w: int, mb_h: int,
                    filter_type: int):
    """Kernel on a CUDA tensor, plain version on a CPU tensor → the
    filtered (Y, U, V) uint8 planes.  ``filter_type`` 0 filters nothing.
    ``recon_filter_mb.launches`` counts kernel launches (one per call on
    CUDA)."""
    if coeffs.device.type == "cpu":
        return recon_filter_mb_plain(coeffs, modes, fparams, mb_w, mb_h,
                                     filter_type)
    return _launch(coeffs, modes, fparams, mb_w, mb_h, filter_type)[0]


def _halo_buffers(above, B: int, mb_w: int, dev):
    """The stripe above's edge → the kernel's ``hts`` (its unfiltered
    bottom rows, Y then U then V) and ``hf`` (its 4 filtered bottom rows
    of each plane), fresh buffers the launch may write into."""
    ty, tu, tv, fy, fu, fv = above
    W, Wc = 16 * mb_w, 8 * mb_w
    for name, t, shape in (("ts y", ty, (B, W)), ("ts u", tu, (B, Wc)),
                           ("ts v", tv, (B, Wc)), ("rows y", fy, (B, 4, W)),
                           ("rows u", fu, (B, 4, Wc)),
                           ("rows v", fv, (B, 4, Wc))):
        if t.dtype != U8 or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"recon_filter_mb_stripe: above {name} must be "
                             f"{shape} uint8 on {dev}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    hts = torch.cat([t.reshape(-1) for t in (ty, tu, tv)])
    hf = torch.cat([t.reshape(-1) for t in (fy, fu, fv)])
    return hts, hf


def _edge(y, u, v, ts_rows):
    """A stripe's edge for the stripe below: its unfiltered bottom rows
    (ty, tu, tv) and its 4 filtered bottom rows of each plane."""
    return (*ts_rows, *(p[:, -4:].contiguous() for p in (y, u, v)))


def recon_filter_mb_stripe_plain(coeffs, modes, fparams, mb_w: int,
                                 mb_h: int, filter_type: int, above=None):
    """Plain torch version of the kernel's stripe form (any device): the
    recon, then the filter over the whole stripe, on bordered planes whose
    border rows hold the stripe above's rows → as
    ``recon_filter_mb_stripe``."""
    _check(coeffs, modes, fparams, mb_w, mb_h, filter_type)
    B, P, dev = coeffs.shape[0], plain.PAD, coeffs.device
    W, Wc = 16 * mb_w, 8 * mb_w
    dg = plain.Diagonals(mb_w, mb_h, dev, top=above is not None)
    m = modes.to(I32)
    PY, PC = plain.recon_wavefront(
        *plain.residual_blocks(coeffs.to(I32)), m[..., 0], m[..., 2:],
        m[..., 1], dg,
        above=None if above is None else (above[0], torch.cat(above[1:3])))
    ts_rows = (PY[:, -1, P:P + W].to(U8), PC[:B, -1, P:P + Wc].to(U8),
               PC[B:, -1, P:P + Wc].to(U8))
    if above is not None:
        PY[:, :P, P:P + W] = above[3].to(I32)
        PC[:, :P, P:P + Wc] = torch.cat(above[4:6]).to(I32)
    plain.loop_filter_wavefront(PY, PC, fparams.reshape(B, mb_h, mb_w, 4),
                                dg, filter_type)
    y, u, v = plain.crop_planes(PY, PC, mb_w)
    back = None
    if above is not None:
        back = (PY[:, 1:P, P:P + W].to(U8), PC[:B, 1:P, P:P + Wc].to(U8),
                PC[B:, 1:P, P:P + Wc].to(U8))
    return (y, u, v), _edge(y, u, v, ts_rows), back


def recon_filter_mb_stripe(coeffs, modes, fparams, mb_w: int, mb_h: int,
                           filter_type: int, above=None):
    """One stripe of MB rows of a frame split over devices → ((Y, U, V),
    edge, back).

    ``above`` is None for the frame's top stripe, else the ``edge`` of
    the stripe above: its unfiltered bottom rows ty (B, 16*mb_w), tu, tv
    (B, 8*mb_w) and its 4 filtered bottom rows fy (B, 4, 16*mb_w), fu, fv
    (B, 4, 8*mb_w), uint8.  ``edge`` is this stripe's own, for the stripe
    below.  ``back`` (None without ``above``) holds rows 1-3 of fy, fu, fv
    after this stripe's top-edge filters: the stripe above's last 3 rows
    of each plane, which it takes in place of its own.  The kernel's
    stripe form on a CUDA tensor (counted in
    ``recon_filter_mb.stripe_launches`` as well as ``launches``), the
    plain version on a CPU tensor.
    """
    if coeffs.device.type == "cpu":
        return recon_filter_mb_stripe_plain(coeffs, modes, fparams, mb_w,
                                            mb_h, filter_type, above)
    (y, u, v), ts, hf = _launch(coeffs, modes, fparams, mb_w, mb_h,
                                filter_type, stripe=True, above=above)
    B, W, Wc = coeffs.shape[0], 16 * mb_w, 8 * mb_w
    n = B * mb_h
    last = torch.arange(mb_h - 1, n, mb_h, device=ts.device)  # each image's
    ts_rows = (ts[:n * W].view(n, W)[last],
               ts[n * W:n * (W + Wc)].view(n, Wc)[last],
               ts[n * (W + Wc):].view(n, Wc)[last])
    back = None
    if hf is not None:
        fy = hf[:B * 4 * W].view(B, 4, W)
        fu = hf[B * 4 * W:B * 4 * (W + Wc)].view(B, 4, Wc)
        fv = hf[B * 4 * (W + Wc):].view(B, 4, Wc)
        back = tuple(f[:, 1:].contiguous() for f in (fy, fu, fv))
    return (y, u, v), _edge(y, u, v, ts_rows), back


recon_filter_mb.launches = 0
recon_filter_mb.stripe_launches = 0

__all__ = ["LIBRARY", "loop_filter_mb_plain", "pack_modes", "recon_filter_mb",
           "recon_filter_mb_plain", "recon_filter_mb_stripe",
           "recon_filter_mb_stripe_plain", "recon_mb_plain"]
