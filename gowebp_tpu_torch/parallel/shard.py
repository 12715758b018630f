"""Sharded codec steps: each rank computes its shard, with halo exchange.

torch.distributed runs one process a device, so each step is SPMD: every
rank calls it with the same arguments, computes its own shard (from a
DTensor's ``to_local()``, or its slice of a plain array, on the rank's
device) and returns DTensors placed over the (data, tile) mesh as the
reference's ``out_specs`` (gowebp_tpu/parallel/shard.py); ``full_tensor()``
gives the global arrays.  The steps:

- ``sharded_encode_plane_step``: the open-loop plane encode split over
  (batch, width tiles); each tile's last source column goes to its right
  neighbour, whose MB column 0 predicts from it (the plane kernels' halo
  forms).
- ``sharded_wavefront_encode``: the exact closed-loop wavefront split over
  (batch, MB-row stripes).  The stripes run in turn: a stripe waits for
  the whole halo of the stripe above (its last recon rows and UV DC
  carries), runs (``wavefront_search``'s stripe form), then sends its own
  halo down.
- ``sharded_recon_frame``: the decode's recon and loop filter split over
  (batch, MB-row stripes), in turn the same way: a stripe gets the stripe
  above's unfiltered bottom row and its 4 filtered bottom rows, sends its
  own down, and sends the 3 rows its top-edge filters changed back up,
  where they replace the upper stripe's last rows.
- ``sharded_recon_step`` and ``sharded_lossless_inverse``: the decode
  recon and the VP8L predictor inverse plus add-green, split over the
  batch on the flattened mesh; no exchange.

Halos travel by point-to-point sends inside the mesh's "tile" group.  A
gloo group takes CPU tensors only, so on a CUDA mesh over gloo (several
ranks on one card) a halo is staged through host memory: copied to the
host, sent, received and copied back, nothing computed there;
``send_halo.staged_bytes`` and ``recv_halo.staged_bytes`` count those
bytes.  ``full_tensor`` gathers a result's global value on any mesh, as bytes
(neither gloo nor NCCL gathers int16) and, on a CUDA mesh over gloo,
from host copies.  Where the reference needs divisibility (MB rows over
the tile axis, the batch over the mesh), a ValueError says so; no shard
is uneven.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..device import resolve_device
from .mesh import batch_sharding

I16, I32, U8 = torch.int16, torch.int32, torch.uint8

ROWS = (Shard(0), Shard(1))        # P("data", "tile", ...)
BATCH = (Shard(0), Shard(0))       # P(("data", "tile")): the flat batch
PER_IMAGE = (Shard(0), Replicate())  # P("data", None, ...)


def _rank_device(mesh) -> torch.device:
    """This rank's device on ``mesh``: its current card on a CUDA mesh
    (raises without CUDA), else the CPU."""
    dev = resolve_device(mesh.device_type)
    if dev.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _tensor(x):
    """A DTensor or tensor as it is; an array as a tensor (uint32 bits as
    int32)."""
    if isinstance(x, torch.Tensor):
        return x.view(I32) if x.dtype == torch.uint32 else x
    a = np.ascontiguousarray(np.asarray(x))
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def _split(mesh, placements, shape) -> list:
    """The shard count of each dim of a global ``shape`` under
    ``placements``."""
    parts = [1] * len(shape)
    for mesh_dim, p in enumerate(placements):
        if isinstance(p, Shard):
            parts[p.dim] *= mesh.size(mesh_dim)
    return parts


def _check_even(name: str, mesh, placements, shape) -> None:
    for d, (n, k) in enumerate(zip(shape, _split(mesh, placements, shape))):
        if n % k:
            raise ValueError(f"{name}: dim {d} of size {n} does not split "
                             f"evenly over {k} shards")


def _local(name: str, x, mesh, placements, dev):
    """This rank's shard of ``x`` (a DTensor is redistributed to
    ``placements`` first; a plain tensor or array is the global value,
    which every rank holds) on ``dev``, contiguous."""
    t = _tensor(x)
    _check_even(name, mesh, placements, t.shape)
    if isinstance(t, DTensor):
        if tuple(t.placements) != tuple(placements):
            t = t.redistribute(mesh, placements)
        t = t.to_local()
    else:
        coord = mesh.get_coordinate()
        for mesh_dim, p in enumerate(placements):
            if isinstance(p, Shard):
                n = t.shape[p.dim] // mesh.size(mesh_dim)
                t = t.narrow(p.dim, coord[mesh_dim] * n, n)
    return t.to(dev).contiguous()


def _dtensor(local, mesh, placements):
    """A rank's shard → the DTensor of the global value."""
    shape = list(local.shape)
    for mesh_dim, p in enumerate(placements):
        if isinstance(p, Shard):
            shape[p.dim] *= mesh.size(mesh_dim)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local.contiguous(), mesh, placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def _tile_peer(mesh, offset: int):
    """(global rank, tile group) of the rank ``offset`` tiles along, or
    None past either end."""
    t, n = mesh.get_local_rank("tile"), mesh.size(1)
    if not 0 <= t + offset < n:
        return None
    group = mesh.get_group("tile")
    return dist.get_global_rank(group, t + offset), group


def _staged(group, dev) -> bool:
    return dev.type == "cuda" and dist.get_backend(group) == "gloo"


def send_halo(tensors, peer) -> None:
    """Send ``tensors`` (as one byte buffer) to ``peer`` = (global rank,
    group), staged through host memory where the group's backend takes
    no device tensors."""
    rank, group = peer
    buf = torch.cat([t.contiguous().reshape(-1).view(U8) for t in tensors])
    if _staged(group, buf.device):
        buf = buf.cpu()
        send_halo.staged_bytes += buf.numel()
    dist.send(buf, dst=rank, group=group)


def recv_halo(like, peer, dev) -> list:
    """Receive the tensors ``send_halo`` sent from ``peer``: ``like`` is a
    list of (shape, dtype); returns them on ``dev``."""
    rank, group = peer
    sizes = [int(np.prod(s)) * torch.empty(0, dtype=d).element_size()
             for s, d in like]
    staged = _staged(group, dev)
    buf = torch.empty(sum(sizes), dtype=U8,
                      device="cpu" if staged else dev)
    dist.recv(buf, src=rank, group=group)
    if staged:
        recv_halo.staged_bytes += buf.numel()
        buf = buf.to(dev)
    out, o = [], 0
    for (shape, dtype), n in zip(like, sizes):
        out.append(buf[o:o + n].view(dtype).reshape(shape))
        o += n
    return out


send_halo.staged_bytes = 0
recv_halo.staged_bytes = 0


def full_tensor(dt):
    """The global value of a DTensor on every rank (a collective: every
    rank calls it), on the DTensor's device and in its dtype.

    The shards are gathered as bytes over each sharded mesh dim's group,
    the last mesh dim first (the inverse of the split), through host
    copies where the group is gloo and the tensor on a card."""
    local = dt.to_local().contiguous()
    dev, mesh = local.device, dt.device_mesh
    buf = local.view(U8)
    for mesh_dim in reversed(range(mesh.ndim)):
        p = dt.placements[mesh_dim]
        if not isinstance(p, Shard) or mesh.size(mesh_dim) == 1:
            continue
        group = mesh.get_group(mesh_dim)
        x = buf.cpu() if _staged(group, dev) else buf
        parts = [torch.empty_like(x) for _ in range(mesh.size(mesh_dim))]
        dist.all_gather(parts, x, group=group)
        buf = torch.cat(parts, p.dim).to(dev)
    return buf.view(local.dtype)


def _penalties(i4_penalty, B: int):
    """The reference's per-image, per-segment RD lambdas (B, 4) int32 from
    a scalar, a (4,) row or a (B, 4) array."""
    pen = _tensor(i4_penalty)
    if isinstance(pen, DTensor):
        return pen
    pen = pen.to(I32)
    if pen.dim() == 0:
        return torch.full((B, 4), int(pen), dtype=I32)
    if pen.dim() == 1:
        return pen[None].expand(B, 4).contiguous()
    return pen


def sharded_encode_plane_step(mesh, y, u, v, *, quants):
    """The open-loop plane encode sharded over (data, tile).

    y (B, H16, W16), u/v (B, H16/2, W16/2) integer planes holding 0..255,
    batch over "data" and width over "tile" (each tile a whole number of
    MB columns); ``quants`` the dict of y1_dc..uv_ac steps.  Returns the
    dict of ``encode_plane_core_v2``'s outputs as DTensors, MB grids
    placed (Shard(0), Shard(2)).
    """
    from ..ops.encode_plane import encode_plane_core_v2

    dev = _rank_device(mesh)
    place = batch_sharding(mesh)
    B, H, W = _tensor(y).shape
    if (W // 16) % mesh.size(1) or W % 16:
        raise ValueError(f"mb_w={W // 16} not divisible by tile axis "
                         f"{mesh.size(1)}")
    yl, ul, vl = (_local(n, p, mesh, place, dev).to(U8)
                  for n, p in (("y", y), ("u", u), ("v", v)))
    right, left = _tile_peer(mesh, 1), _tile_peer(mesh, -1)
    if right is not None:
        send_halo([yl[:, :, -1], ul[:, :, -1], vl[:, :, -1]], right)
    halos = dict(y_halo=None, u_halo=None, v_halo=None)
    if left is not None:
        Bl, Hl = yl.shape[:2]
        halos = dict(zip(("y_halo", "u_halo", "v_halo"), recv_halo(
            [((Bl, Hl), U8), ((Bl, Hl // 2), U8), ((Bl, Hl // 2), U8)],
            left, dev)))
    out = encode_plane_core_v2(yl, ul, vl, **quants, **halos,
                               leftmost=left is None)
    return {k: _dtensor(t, mesh, place) for k, t in out.items()}


def sharded_wavefront_encode(mesh, y, u, v, seg_map, qsteps, tables, *,
                             try_i4: bool, i4_penalty=0,
                             use_derr: bool = False):
    """The exact closed-loop wavefront split over (data, MB-row stripes).

    y (B, H, W), u/v (B, H/2, W/2) planes, seg_map (B, mh, mw), rows over
    "tile"; qsteps (B, 4, 6) and i4_penalty (a scalar, (4,) or (B, 4))
    over "data"; ``tables`` the (p0, p1, val) cost tables, on every rank.
    The stripes run in turn (the stripe above's whole halo first).
    Returns ``wavefront_search``'s outputs without the recon as DTensors
    placed (Shard(0), Shard(1)): equal to the unsharded engine's.
    """
    from ..ops.kernels.wavefront_search import (search_tables,
                                                wavefront_search_stripe)

    dev = _rank_device(mesh)
    B, H, W = _tensor(y).shape
    mh, mw = H // 16, W // 16
    tile_n = mesh.size(1)
    if mh % tile_n:
        raise ValueError(f"mb_h={mh} not divisible by tile axis {tile_n}")
    yl, ul, vl = (_local(n, p, mesh, ROWS, dev).to(U8)
                  for n, p in (("y", y), ("u", u), ("v", v)))
    segl = _local("seg_map", seg_map, mesh, ROWS, dev).to(I32)
    qsl = _local("qsteps", qsteps, mesh, PER_IMAGE, dev).to(I32)
    pens = rate = None
    if try_i4:
        pens = _local("i4_penalty", _penalties(i4_penalty, B), mesh,
                      PER_IMAGE, dev).to(I32)
        rate = tuple(t.to(dev) for t in search_tables(
            tuple(_tensor(t).to(I32) for t in tables)))
    Bl = yl.shape[0]
    above_peer, below_peer = _tile_peer(mesh, -1), _tile_peer(mesh, 1)
    above = None
    if above_peer is not None:
        above = recv_halo([((Bl, W), U8), ((Bl, W // 2), U8),
                           ((Bl, W // 2), U8), ((Bl, mw, 4), I16)],
                          above_peer, dev)
    out, edge = wavefront_search_stripe(yl, ul, vl, segl, qsl, pens, rate,
                                        try_i4=try_i4, use_derr=use_derr,
                                        above=above)
    if below_peer is not None:
        send_halo(edge, below_peer)
    return {k: _dtensor(t, mesh, ROWS) for k, t in out.items()}


def sharded_recon_frame(mesh, coeffs, is_i4, imodes, uvmode, fparams, *,
                        mb_w, mb_h, filter_type):
    """The decode's recon and loop filter split over (data, MB-row
    stripes).

    coeffs (B, N, 24, 16), is_i4/uvmode (B, N), imodes (B, N, 16) and
    fparams (B, mb_h, mb_w, 4) (N = mb_h * mb_w, raster order), rows over
    "tile".  The stripes run in turn; each sends the 3 rows its top-edge
    filters changed back to the stripe above.  Returns the uint8 planes
    (Y, U, V) as DTensors placed (Shard(0), Shard(1)): equal to the
    unsharded recon_frame's.
    """
    from ..ops.kernels.vp8_recon import pack_modes, recon_filter_mb_stripe

    dev = _rank_device(mesh)
    tile_n = mesh.size(1)
    if mb_h % tile_n:
        raise ValueError(f"mb_h={mb_h} not divisible by tile axis {tile_n}")
    mh = mb_h // tile_n
    fp = _tensor(fparams)
    if not isinstance(fp, DTensor):
        fp = fp.reshape(fp.shape[0], mb_h, mb_w, 4)
    cl = _local("coeffs", coeffs, mesh, ROWS, dev).to(I16)
    Bl = cl.shape[0]
    modes = pack_modes(*(_local(n, t, mesh, ROWS, dev) for n, t in (
        ("is_i4", is_i4), ("imodes", imodes), ("uvmode", uvmode))))
    fpl = _local("fparams", fp, mesh, ROWS, dev).reshape(Bl, mh, mb_w, 4)
    W, Wc = 16 * mb_w, 8 * mb_w
    above_peer, below_peer = _tile_peer(mesh, -1), _tile_peer(mesh, 1)
    above = None
    if above_peer is not None:
        above = recv_halo([((Bl, W), U8), ((Bl, Wc), U8), ((Bl, Wc), U8),
                           ((Bl, 4, W), U8), ((Bl, 4, Wc), U8),
                           ((Bl, 4, Wc), U8)], above_peer, dev)
    planes, edge, back = recon_filter_mb_stripe(cl, modes, fpl, mb_w, mh,
                                                filter_type, above)
    if below_peer is not None:
        send_halo(edge, below_peer)
    if above_peer is not None:
        send_halo(back, above_peer)
    if below_peer is not None:
        rows = recv_halo([((Bl, 3, W), U8), ((Bl, 3, Wc), U8),
                          ((Bl, 3, Wc), U8)], below_peer, dev)
        for p, r in zip(planes, rows):
            p[:, -3:] = r
    return tuple(_dtensor(p, mesh, ROWS) for p in planes)


def _check_batch(name: str, B: int, mesh) -> None:
    n = mesh.size(0) * mesh.size(1)
    if B % n:
        raise ValueError(f"{name}: batch {B} not divisible by the mesh's "
                         f"{n} devices")


def sharded_recon_step(mesh, coeffs, is_i4, imodes, uvmode, fparams, *,
                       mb_w: int, mb_h: int, filter_type: int):
    """The decode recon (dequantized coefficients to filtered planes)
    split over the batch on the flattened mesh: ``recon_frame`` on each
    rank's images, no exchange.  Returns (Y, U, V) uint8 DTensors placed
    (Shard(0), Shard(0))."""
    from ..ops.vp8_recon import recon_frame

    dev = _rank_device(mesh)
    _check_batch("sharded_recon_step", _tensor(coeffs).shape[0], mesh)
    args = [_local(n, t, mesh, BATCH, dev) for n, t in (
        ("coeffs", coeffs), ("is_i4", is_i4), ("imodes", imodes),
        ("uvmode", uvmode), ("fparams", fparams))]
    args[0] = args[0].to(I16)
    planes = recon_frame(*args, mb_w=mb_w, mb_h=mb_h,
                         filter_type=filter_type)
    return tuple(_dtensor(p, mesh, BATCH) for p in planes)


def sharded_lossless_inverse(mesh, residuals, mode_img, *, bits: int):
    """The VP8L predictor inverse plus add-green split over the batch on
    the flattened mesh.

    residuals (B, h, w) ARGB words (uint32, or int32 bits); mode_img
    (th, tw), shared by the batch, on every rank.  Returns the (B, h, w)
    int32 ARGB bits as a DTensor placed (Shard(0), Shard(0)).
    """
    from ..ops.lossless import predictor_inverse

    dev = _rank_device(mesh)
    _check_batch("sharded_lossless_inverse", _tensor(residuals).shape[0],
                 mesh)
    res = _local("residuals", residuals, mesh, BATCH, dev).to(I32)
    modes = _tensor(mode_img)
    if isinstance(modes, DTensor):
        modes = full_tensor(modes)
    out = predictor_inverse(res, modes.to(I32).to(dev).contiguous(), bits,
                            add_green=True)
    return _dtensor(out, mesh, BATCH)


__all__ = ["full_tensor", "recv_halo", "send_halo", "sharded_encode_plane_step",
           "sharded_lossless_inverse", "sharded_recon_frame",
           "sharded_recon_step", "sharded_wavefront_encode"]
