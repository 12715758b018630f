"""Exact full-search wavefront: the Hopper kernel, its binding and its
plain version.

``wavefront_search`` is the exact engine (``engine="wavefront"``): every
macroblock's modes are searched inside the closed loop, from the recon of
the MBs coded before it, in anti-diagonal order, and the MB is then coded
with them, so its levels, modes and recon equal the host encoder's.  Per
MB:

- i16: the SSE argmin over the 4 whole-block predictions (ties to the
  lowest mode), then FDCT, Y2 WHT, quantization and the decoder's recon;
- with ``try_i4``: the i16 score s16 = d16 + (pen * rate16) >> 16, with
  d16 the SSE of the source against the i16 recon and rate16 the type-1
  rate of the Y2 levels plus the type-0 rate of the 16 AC blocks (every
  block with ctx0 = 1); the 16-sub-block Gauss-Seidel walk over the 10
  B-modes of each (``i4_walk_plain``), whose summed score s4 adopts i4
  when s4 < s16 (an equal score keeps i16; an adopted MB has no Y2);
- uv: the argmin of the U SSE + V SSE over DC/TM/VE/HE, then the chroma
  code with the UV DC error-diffusion chain when ``use_derr`` is set.

The trellis form (``lams`` given: the host encoder's second pass at
method 6) refines every block's levels right after its quantization with
``trellis_refine`` (each non-zero level kept or lowered by one, by the
least distortion + lambda * exact token rate): the 16 i16 AC blocks and
the Y2 block before the i16 recon and rate, each of the 10 candidates of
every i4 sub-block before it is scored, and the 8 chroma blocks after
the DC error diffusion.  Its rate tables are those of the first pass's
adapted probabilities, for the search's rate model as for the trellis.

``wavefront_search_stripe`` codes one stripe of MB rows of a frame split
over devices (parallel/shard.py ``sharded_wavefront_encode``): below
another stripe, its MB row 0 reads its top context from the halo the
stripe above sent (the kernel's stripe form), and it returns its own last
row's halo for the stripe below.

On CUDA tensors it runs the kernel in ``wavefront_search.cu``, one
persistent launch (it replaces gowebp_tpu/ops/encode_wavefront_jax.py
``_wavefront_impl`` with ``modes=None``, which the JAX package ran in
XLA, not in a Pallas kernel); on CPU tensors ``wavefront_search_plain``,
the fixed-mode wavefront's per-diagonal torch loop with the search as its
decider.

Inputs: y (B, H, W) uint8 and u, v (B, H/2, W/2) uint8 with H, W
multiples of 16; seg (B, mh, mw) int32; qsteps (B, 4, 6) int32; pens
(B, 4) int32 per-segment RD lambdas (below 2**19); ``rate`` the
per-position rate tables of ``search_tables``; ``lams`` (B, 4) int32 the
trellis form's per-segment lambdas, or None.  Returns uint8 ymode,
uvmode, is_i4 (B, mh, mw) and imodes (B, mh, mw, 16) (an i16 MB's imodes
repeat its ymode); int16 zigzag y_levels (B, mh, mw, 16, 16), y2_levels
(B, mh, mw, 16), uv_levels (B, mh, mw, 8, 16); and with ``want_recon``
the uint8 recon planes recon_y/recon_u/recon_v.
"""

from __future__ import annotations

import ctypes

import torch

from ..rate import mul_shr16, position_tables, rate_by_position
from .cuda_build import CudaLibrary, check_tensor, stream_handle
from .i4_search import i4_search_plain, i4_walk_plain
from .wavefront_fixed import Trellis, wavefront_plain

I32 = torch.int32
U8 = torch.uint8
# token types of the rate tables, in their order in ``search_tables``:
# luma AC after a Y2 block, Y2, i4 luma, and (the trellis form) chroma
RATE_TYPES = (0, 1, 3, 2)
MODE_KEYS = ("ymode", "uvmode", "is_i4", "imodes")


def _configure(lib) -> None:
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.wavefront_search_launch.restype = i
    lib.wavefront_search_launch.argtypes = [p] * 22 + [i] * 5 + [p] * 5
    lib.wavefront_search_occupancy.restype = i
    lib.wavefront_search_occupancy.argtypes = [i, i] + [
        ctypes.POINTER(ctypes.c_int)] * 2


LIBRARY = CudaLibrary("wavefront_search.cu", _configure)


def search_tables(tables, trellis: bool = False):
    """(p0, p1, val) cost tables → the rate tables by position of types 0,
    1 and 3 (and 2 for the trellis form), stacked: p0 (T, 16, 3, 2), p1
    (T, 16, 3, 2), val (T, 16, 3, 68) int32, T = 3 (4)."""
    rows = [position_tables(tables, t) for t in RATE_TYPES[:3 + trellis]]
    return tuple(torch.stack([r[i] for r in rows]).contiguous()
                 for i in range(3))


def search_trellis(rate, lams):
    """``wavefront_plain``'s ``Trellis`` of the trellis form's inputs
    (``search_tables(..., trellis=True)`` and (B, 4) lambdas); None
    without ``lams``."""
    if lams is None:
        return None
    return Trellis({t: tuple(tab[k] for tab in rate)
                    for k, t in enumerate(RATE_TYPES)}, lams)


def occupancy(try_i4: bool = True, trellis: bool = False):
    """(SMs, blocks an SM holds at once) of the kernel's launch on the
    current card: the ticket grid is their product, or the MB rows if
    fewer.  Needs the card."""
    lib = LIBRARY.load()
    sms, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.wavefront_search_occupancy(int(bool(try_i4)), int(bool(trellis)),
                                         ctypes.byref(sms),
                                         ctypes.byref(per_sm))
    if err != 0:
        raise RuntimeError(f"wavefront_search occupancy: CUDA error {err}")
    return sms.value, per_sm.value


def _sse(a, b, dims):
    d = a - b
    return (d * d).sum(dim=dims, dtype=I32)


class SearchModes:
    """The exact engine's in-loop decisions, for ``wavefront_plain``.

    ``search`` scores each walk substep's sub-blocks (``i4_walk_plain``'s
    argument of that name); ``lams`` (B, 4), the trellis form's lambdas,
    trellis-refine every walk candidate.
    """

    def __init__(self, pens, rate, try_i4: bool, search=i4_search_plain,
                 lams=None):
        self.pens, self.try_i4, self.search = pens, try_i4, search
        self.lams = lams
        if try_i4:
            self.t0, self.t1, self.t3 = (tuple(t[k] for t in rate)
                                         for k in range(3))

    def ymode(self, mb, src, pred4):
        return torch.argmin(_sse(src[None], pred4, (-1, -2)), dim=0)

    def i4(self, mb, sg, src, ctx, q, iq, y_lv, y2_lv, recon16):
        if not self.try_i4:
            return None
        s16, s4, bmodes = self.scores(mb, sg, src, ctx, q, iq, y_lv, y2_lv,
                                      recon16)
        return s4 < s16, bmodes

    def scores(self, mb, sg, src, ctx, q, iq, y_lv, y2_lv, recon16):
        """The i16 score s16, the walk's summed score s4 and its B-modes
        (M, 16) of the diagonal's M MBs."""
        d16 = _sse(src, recon16, (-1, -2))
        rate16 = rate_by_position(y2_lv, *self.t1, first=0, ctx0=1)
        rate16 = rate16 + rate_by_position(y_lv, *self.t0, first=1,
                                           ctx0=1).sum(dim=-1, dtype=I32)
        pen = self.pens[mb[0], sg]
        s16 = d16 + mul_shr16(pen, rate16)
        lam = None if self.lams is None else self.lams[mb[0], sg][None]
        bmodes, s4 = i4_walk_plain(
            src[None], *(c[None] for c in ctx), q[None], iq[None], pen[None],
            self.t3, search=self.search, lam=lam)
        return s16, s4[0], bmodes[0].long()

    def uvmode(self, mb, csrc, cpred4):
        return torch.argmin(_sse(csrc[None], cpred4, (-1, -2)).sum(
            dim=1, dtype=I32), dim=0)


def wavefront_search_plain(y, u, v, seg, qsteps, pens, rate, *,
                           try_i4: bool, use_derr: bool, want_recon: bool,
                           lams=None):
    """Per-diagonal torch loop (any device); same contract as the kernel.

    It calls only plain pieces (``i4_walk_plain``, never the i4 kernels),
    so on CUDA tensors it is the kernel's independent yardstick.
    """
    out = wavefront_plain(y, u, v, seg, qsteps,
                          SearchModes(pens, rate, try_i4, lams=lams),
                          use_derr=use_derr, want_recon=want_recon,
                          trellis=search_trellis(rate, lams))
    for k in MODE_KEYS:
        out[k] = out[k].to(U8)
    return out


def _launch(y, u, v, seg, qsteps, pens, rate, *, try_i4: bool,
            use_derr: bool, lams=None, above=None):
    """One launch of the kernel (the stripe form with ``above``) → (out,
    (ry, ru, rv, dtop)): the outputs without the recon, and the kernel's
    recon planes and DC carries."""
    dev = y.device
    if dev.type != "cuda":
        raise ValueError(f"wavefront_search: unsupported device {dev}")
    B, H, W = y.shape
    if H % 16 or W % 16 or H == 0 or W == 0:
        raise ValueError(f"wavefront_search: planes must be MB multiples, "
                         f"got {H}x{W}")
    mh, mw = H // 16, W // 16
    check_tensor("y", y, U8, (B, H, W), dev)
    check_tensor("u", u, U8, (B, H // 2, W // 2), dev)
    check_tensor("v", v, U8, (B, H // 2, W // 2), dev)
    check_tensor("seg", seg, I32, (B, mh, mw), dev)
    check_tensor("qsteps", qsteps, I32, (B, 4, 6), dev)
    trellis = lams is not None
    if trellis and above is not None:
        raise ValueError("wavefront_search: the stripe form has no trellis")
    ptrs = [None] * 5
    if try_i4:
        check_tensor("pens", pens, I32, (B, 4), dev)
        ptrs[0] = pens.data_ptr()
    if try_i4 or trellis:
        T = 3 + trellis
        for name, tab, shape in zip(("p0", "p1", "val"), rate,
                                    ((T, 16, 3, 2), (T, 16, 3, 2),
                                     (T, 16, 3, 68))):
            check_tensor(name, tab, I32, shape, dev)
        ptrs[1:4] = [t.data_ptr() for t in rate]
    if trellis:
        check_tensor("lams", lams, I32, (B, 4), dev)
        ptrs[4] = lams.data_ptr()
    lib = LIBRARY.load()
    I16 = torch.int16
    ry = torch.empty((B, H, W), dtype=U8, device=dev)
    ru = torch.empty((B, H // 2, W // 2), dtype=U8, device=dev)
    rv = torch.empty_like(ru)
    dtop = torch.empty((B, mh, mw, 4), dtype=I16, device=dev)
    # per-row progress counters, then the row ticket (the kernel's sync)
    sync = torch.zeros(B * mh + 1, dtype=I32, device=dev)
    ylv = torch.empty((B, mh, mw, 16, 16), dtype=I16, device=dev)
    y2lv = torch.empty((B, mh, mw, 16), dtype=I16, device=dev)
    uvlv = torch.empty((B, mh, mw, 8, 16), dtype=I16, device=dev)
    modes = {k: torch.empty((B, mh, mw), dtype=U8, device=dev)
             for k in MODE_KEYS[:3]}
    modes["imodes"] = torch.empty((B, mh, mw, 16), dtype=U8, device=dev)
    planes = [t.data_ptr() for t in (y, u, v, seg, qsteps)]
    outs = [t.data_ptr() for t in (ry, ru, rv, dtop, ylv, y2lv, uvlv)]
    outs += [modes[k].data_ptr() for k in MODE_KEYS] + [sync.data_ptr()]
    halo = [None] * 4
    if above is not None:
        hy, hu, hv, hdt = above
        check_tensor("above y", hy, U8, (B, W), dev)
        check_tensor("above u", hu, U8, (B, W // 2), dev)
        check_tensor("above v", hv, U8, (B, W // 2), dev)
        check_tensor("above dtop", hdt, I16, (B, mw, 4), dev)
        halo = [t.data_ptr() for t in above]
    err = lib.wavefront_search_launch(
        *planes, *ptrs, *outs, B, mh, mw, int(bool(use_derr)),
        int(bool(try_i4)) | trellis << 1, *halo, stream_handle(dev))
    if err != 0:
        raise RuntimeError(
            f"wavefront_search kernel launch failed: CUDA error {err}")
    if trellis:
        wavefront_search.trellis_launches += 1
    else:
        wavefront_search.launches += 1
        wavefront_search.stripe_launches += above is not None
    return (dict(modes, y_levels=ylv, y2_levels=y2lv, uv_levels=uvlv),
            (ry, ru, rv, dtop))


def wavefront_search(y, u, v, seg, qsteps, pens, rate, *, try_i4: bool,
                     use_derr: bool, want_recon: bool, lams=None):
    """Kernel on CUDA tensors, plain version on CPU tensors.

    ``wavefront_search.launches`` counts kernel launches (one per call on
    CUDA: the whole wavefront, search included, is one persistent
    launch) of the method <= 5 form, ``wavefront_search.trellis_launches``
    those of the trellis form (``lams`` given).  With ``try_i4`` False,
    ``pens`` is not read
    and may be None, and so may ``rate`` unless ``lams`` is given (the
    trellis form reads all 4 of its types).
    """
    if y.device.type == "cpu":
        return wavefront_search_plain(y, u, v, seg, qsteps, pens, rate,
                                      try_i4=try_i4, use_derr=use_derr,
                                      want_recon=want_recon, lams=lams)
    out, (ry, ru, rv, _) = _launch(y, u, v, seg, qsteps, pens, rate,
                                   try_i4=try_i4, use_derr=use_derr,
                                   lams=lams)
    if want_recon:
        out.update(recon_y=ry, recon_u=ru, recon_v=rv)
    return out


def wavefront_search_stripe_plain(y, u, v, seg, qsteps, pens, rate, *,
                                  try_i4: bool, use_derr: bool, above=None):
    """Plain torch version of the kernel's stripe form (any device), with
    ``wavefront_search_stripe``'s contract."""
    out = wavefront_plain(y, u, v, seg, qsteps,
                          SearchModes(pens, rate, try_i4),
                          use_derr=use_derr, want_recon=False,
                          above=above, want_edge=True)
    for k in MODE_KEYS:
        out[k] = out[k].to(U8)
    return out, out.pop("edge")


def wavefront_search_stripe(y, u, v, seg, qsteps, pens, rate, *,
                            try_i4: bool, use_derr: bool, above=None):
    """One stripe of MB rows of a frame split over devices → (out, edge).

    ``above`` is None for the frame's top stripe, else the halo of the
    stripe above: its ``edge``.  ``out`` is ``wavefront_search``'s without
    the recon; ``edge`` = (its last recon rows y (B, W), u, v (B, W/2)
    uint8, its last MB row's UV DC carries (B, mw, 4) int16), the halo of
    the stripe below.  The kernel on CUDA tensors (the stripe form when
    ``above`` is given, counted in ``wavefront_search.stripe_launches``
    as well as ``launches``), the plain version on CPU tensors.
    """
    if y.device.type == "cpu":
        return wavefront_search_stripe_plain(
            y, u, v, seg, qsteps, pens, rate, try_i4=try_i4,
            use_derr=use_derr, above=above)
    out, (ry, ru, rv, dtop) = _launch(y, u, v, seg, qsteps, pens, rate,
                                      try_i4=try_i4, use_derr=use_derr,
                                      above=above)
    return out, (ry[:, -1].contiguous(), ru[:, -1].contiguous(),
                 rv[:, -1].contiguous(), dtop[:, -1].contiguous())


wavefront_search.launches = 0
wavefront_search.trellis_launches = 0
wavefront_search.stripe_launches = 0

__all__ = ["LIBRARY", "RATE_TYPES", "SearchModes", "occupancy",
           "search_tables", "search_trellis", "wavefront_search",
           "wavefront_search_plain", "wavefront_search_stripe",
           "wavefront_search_stripe_plain"]
