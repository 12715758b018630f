"""PyTorch port on the card: each CUDA kernel vs its plain torch version
(the full-search kernel's trellis form too), the batch encode's GPU bytes
vs its CPU bytes (hybrid, exact wavefront and open-loop engines), the
single-image encode's GPU bytes vs its CPU bytes, and the batch decode's
GPU pixels vs its CPU pixels (lossy, lossy + ALPH and VP8L files, both
reconstruction backends), at small sizes.

Marked ``cuda``; every test skips on a host without a CUDA GPU.  This
file imports nothing of JAX, so it runs on a GPU machine without JAX:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _tables(dev):
    from gowebp_tpu_torch.models.vp8.encoder import _default_cost_tables

    return tuple(torch.from_numpy(t.astype(np.int32)).to(dev)
                 for t in _default_cost_tables())


def test_i4_search_kernel_matches_plain(cuda):
    from gowebp_tpu_torch.ops.kernels.i4_search import (
        i4_search, i4_search_plain, t3_tables)

    g = torch.Generator().manual_seed(3)
    S = 5000                                   # a ragged last block
    ctx13 = torch.randint(0, 256, (S, 13), generator=g, dtype=torch.int32)
    src16 = torch.randint(0, 256, (S, 16), generator=g, dtype=torch.int32)
    q = torch.randint(4, 160, (S, 2), generator=g, dtype=torch.int32)
    pen = torch.randint(0, 1 << 19, (S,), generator=g, dtype=torch.int32)
    quants5 = torch.stack([(1 << 17) // q[:, 0], (1 << 17) // q[:, 1],
                           q[:, 0], q[:, 1], pen], 1).to(torch.int32)
    args = tuple(a.to(cuda) for a in (ctx13, src16, quants5))
    t3 = t3_tables(_tables(cuda))
    before = i4_search.launches
    got = i4_search(*args, t3)
    want = i4_search_plain(*args, t3)
    torch.cuda.synchronize()
    assert i4_search.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _search_args(cuda, S, seed):
    g = torch.Generator().manual_seed(seed)
    ctx13 = torch.randint(0, 256, (S, 13), generator=g, dtype=torch.int32)
    src16 = torch.randint(0, 256, (S, 16), generator=g, dtype=torch.int32)
    q = torch.randint(4, 160, (S, 2), generator=g, dtype=torch.int32)
    pen = torch.randint(0, 1 << 19, (S,), generator=g, dtype=torch.int32)
    quants5 = torch.stack([(1 << 17) // q[:, 0], (1 << 17) // q[:, 1],
                           q[:, 0], q[:, 1], pen], 1).to(torch.int32)
    return tuple(a.to(cuda) for a in (ctx13, src16, quants5))


@pytest.mark.parametrize("topk", [1, 4, 10])
def test_i4_search_kernel_topk_matches_plain(cuda, topk):
    """Ranked candidates: the k best-predicting modes, argmin in rank
    order; random contexts in a narrow range give equal SSEs and costs."""
    from gowebp_tpu_torch.ops.kernels.i4_search import (
        i4_search, i4_search_plain, t3_tables)

    t3 = t3_tables(_tables(cuda))
    for args in (_search_args(cuda, 5000, topk),
                 tuple(a if i == 2 else 126 + a % 5
                       for i, a in enumerate(_search_args(cuda, 3001, 7)))):
        before = i4_search.launches
        got = i4_search(*args, t3, topk=topk)
        want = i4_search_plain(*args, t3, topk=topk)
        torch.cuda.synchronize()
        assert i4_search.launches == before + 1
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def _wavefront_args(cuda, seed, B, H, W):
    g = torch.Generator().manual_seed(seed)
    mh, mw = H // 16, W // 16
    I32, U8 = torch.int32, torch.uint8
    args = (torch.randint(0, 256, (B, H, W), generator=g, dtype=U8),
            torch.randint(0, 256, (B, H // 2, W // 2), generator=g, dtype=U8),
            torch.randint(0, 256, (B, H // 2, W // 2), generator=g, dtype=U8),
            torch.randint(0, 4, (B, mh, mw), generator=g, dtype=I32),
            torch.randint(4, 120, (B, 4, 6), generator=g, dtype=I32),
            torch.randint(0, 4, (B, mh, mw), generator=g, dtype=I32),
            torch.randint(0, 4, (B, mh, mw), generator=g, dtype=I32),
            torch.randint(0, 2, (B, mh, mw), generator=g, dtype=I32),
            torch.randint(0, 10, (B, mh, mw, 16), generator=g, dtype=I32))
    return tuple(a.to(cuda) for a in args)


@pytest.mark.parametrize("derr", [False, True])
@pytest.mark.parametrize("B,H,W", [
    (3, 64, 96),
    (2, 16, 112),       # one MB row
    (2, 112, 16),       # one MB column
    (160, 512, 32),     # 5,120 MB rows: more than the card holds blocks
])
def test_wavefront_kernel_matches_plain(cuda, derr, B, H, W):
    from gowebp_tpu_torch.ops.kernels.wavefront_fixed import (
        wavefront_fixed, wavefront_fixed_plain)

    args = _wavefront_args(cuda, 5 + derr + H, B, H, W)
    want = wavefront_fixed_plain(*args, use_derr=derr, want_recon=True)
    for recon in (True, False):
        before = wavefront_fixed.launches
        got = wavefront_fixed(*args, use_derr=derr, want_recon=recon)
        torch.cuda.synchronize()
        assert wavefront_fixed.launches == before + 1
        assert set(got) <= set(want)
        for k in got:
            assert torch.equal(got[k], want[k]), k


def _walk_args(cuda, seed, B, N):
    g = torch.Generator().manual_seed(seed)
    I32 = torch.int32

    def rnd(*shape, lo=0, hi=256):
        return torch.randint(lo, hi, shape, generator=g, dtype=I32)

    q = rnd(B, N, 6, lo=4, hi=160)
    return (rnd(B, N, 16, 16), rnd(B, N, 16), rnd(B, N, 4), rnd(B, N, 16),
            rnd(B, N), q, ((1 << 17) // q).to(I32),
            rnd(B, N, lo=0, hi=1 << 19))


@pytest.mark.parametrize("B,N", [(2, 15), (1, 1), (3, 37)])
def test_i4_walk_kernel_matches_plain(cuda, B, N):
    """Ragged MB counts: the last block of 6 MBs is partly empty."""
    from gowebp_tpu_torch.ops.kernels.i4_search import (
        i4_walk, i4_walk_plain, t3_tables)

    args = tuple(a.to(cuda) for a in _walk_args(cuda, B * 100 + N, B, N))
    t3 = t3_tables(_tables(cuda))
    before = i4_walk.launches
    got = i4_walk(*args, t3, want_recon=True)
    want = i4_walk_plain(*args, t3, want_recon=True)
    lean = i4_walk(*args, t3)
    torch.cuda.synchronize()
    assert i4_walk.launches == before + 2
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert len(lean) == 2 and all(torch.equal(a, b)
                                  for a, b in zip(lean, want))


@pytest.mark.parametrize("topk", [1, 4, 10])
def test_i4_walk_kernel_topk_matches_plain(cuda, topk):
    from gowebp_tpu_torch.ops.kernels.i4_search import (
        i4_walk, i4_walk_plain, t3_tables)

    args = tuple(a.to(cuda) for a in _walk_args(cuda, 40 + topk, 3, 37))
    t3 = t3_tables(_tables(cuda))
    before = i4_walk.launches
    got = i4_walk(*args, t3, want_recon=True, topk=topk)
    want = i4_walk_plain(*args, t3, want_recon=True, topk=topk)
    torch.cuda.synchronize()
    assert i4_walk.launches == before + 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_i4_wrappers_reject_bad_topk(cuda):
    from gowebp_tpu_torch.ops.kernels.i4_search import (i4_search, i4_walk,
                                                        t3_tables)

    t3 = t3_tables(_tables(cuda))
    search = _search_args(cuda, 8, 1)
    walk = [a.to(cuda) for a in _walk_args(cuda, 1, 2, 3)]
    before = (i4_search.launches, i4_walk.launches)
    for topk, err in ((0, ValueError), (11, ValueError), (-1, ValueError),
                      (4.0, TypeError), ("4", TypeError), (True, TypeError)):
        with pytest.raises(err):
            i4_search(*search, t3, topk=topk)
        with pytest.raises(err):
            i4_walk(*walk, t3, topk=topk)
    assert (i4_search.launches, i4_walk.launches) == before


def test_kernel_wrappers_reject_bad_tensors(cuda):
    from gowebp_tpu_torch.ops.kernels.i4_search import (i4_search, i4_walk,
                                                        t3_tables)
    from gowebp_tpu_torch.ops.kernels.wavefront_fixed import wavefront_fixed

    t3 = t3_tables(_tables(cuda))
    ok = torch.zeros((8, 13), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        i4_search(ok.to(torch.int64), ok[:, :16], ok[:, :5], t3)
    with pytest.raises(ValueError):
        i4_search(ok, torch.zeros((8, 16), dtype=torch.int32, device=cuda),
                  ok[:, :5], t3)                     # a non-contiguous view

    walk = [a.to(cuda) for a in _walk_args(cuda, 1, 2, 3)]
    bad = {0: walk[0].to(torch.int64),                     # src dtype
           1: torch.zeros((2, 3, 32), dtype=torch.int32,
                          device=cuda)[..., ::2],           # a view
           5: walk[5][..., :5].contiguous()}                # qlane shape
    before = i4_walk.launches
    for i, t in bad.items():
        args = list(walk)
        args[i] = t
        with pytest.raises(TypeError if i == 0 else ValueError):
            i4_walk(*args, t3)
    assert i4_walk.launches == before

    wf = list(_wavefront_args(cuda, 1, 2, 32, 32))
    before = wavefront_fixed.launches
    for i, t in ((0, wf[0].to(torch.int32)),              # y dtype
                 (0, wf[0].transpose(1, 2))):             # a transposed plane
        args = list(wf)
        args[i] = t
        with pytest.raises(TypeError if t.dtype != torch.uint8
                           else ValueError):
            wavefront_fixed(*args, use_derr=True, want_recon=False)
    assert wavefront_fixed.launches == before


def test_batch_encode_gpu_bytes_equal_cpu_bytes(cuda):
    from gowebp_tpu_torch import encode_rgba_batch
    from gowebp_tpu_torch.utils.corpus import natural_image

    imgs = [natural_image(45, 61, seed=s) for s in (1, 2)]
    for quality in (75.0, 99.0):
        got = encode_rgba_batch(imgs, quality=quality, device="cuda")
        assert got == encode_rgba_batch(imgs, quality=quality, device="cpu")


@pytest.mark.parametrize("kw", [
    dict(cold="dense"), dict(refine=2, i4_topk=4), dict(cold="dense", depth=1),
    dict(depth=3, chunk=1)])
def test_hybrid_options_gpu_bytes_equal_cpu_bytes(cuda, kw):
    """cold="dense" launches the flat i4_search kernel; every option set
    gives the CPU path's bytes, at depth 3 (the default) and depth 1."""
    from gowebp_tpu_torch.ops.encode_pipeline import (
        encode_rgba_batch_pipelined)
    from gowebp_tpu_torch.ops.kernels.i4_search import i4_search
    from gowebp_tpu_torch.utils.corpus import natural_image

    imgs = [natural_image(45, 61, seed=s) for s in (1, 2, 3)]
    kw = dict(dict(quality=75.0, chunk=2), **kw)
    before = i4_search.launches
    got = encode_rgba_batch_pipelined(imgs, device="cuda", **kw)
    if kw.get("cold") == "dense":
        assert i4_search.launches > before
    assert got == encode_rgba_batch_pipelined(imgs, device="cpu", **kw)


def test_config_without_i4_launches_no_i4_kernel(cuda):
    from gowebp_tpu_torch.config import EncoderConfig
    from gowebp_tpu_torch.ops.encode_pipeline import (
        encode_rgba_batch_pipelined)
    from gowebp_tpu_torch.ops.kernels.i4_search import i4_search, i4_walk
    from gowebp_tpu_torch.utils.corpus import natural_image

    imgs = [natural_image(45, 61, seed=s) for s in (1, 2)]
    for kw in (dict(method=3), dict(partition_limit=100)):
        cfg = EncoderConfig(lossless=False, **kw)
        before = (i4_search.launches, i4_walk.launches)
        got = encode_rgba_batch_pipelined(imgs, device="cuda", config=cfg,
                                          cold="dense")
        assert (i4_search.launches, i4_walk.launches) == before
        assert got == encode_rgba_batch_pipelined(imgs, device="cpu",
                                                  config=cfg, cold="dense")


@pytest.mark.parametrize("b,h,w,ph,pw,alpha", [
    (3, 61, 95, 64, 96, False),     # MB-padded planes, odd visible size
    (2, 64, 96, 64, 96, True),      # even size, alpha plane
    (1, 1, 1, 16, 16, False),
    (2, 17, 2, 32, 16, True),
    (1, 40, 33, 48, 48, False),
])
def test_yuv420_to_rgba_kernel_matches_plain(cuda, b, h, w, ph, pw, alpha):
    from gowebp_tpu_torch.ops.kernels.yuv420_to_rgba import (
        yuv420_to_rgba, yuv420_to_rgba_plain)

    g = torch.Generator().manual_seed(h * 1000 + w)
    U8 = torch.uint8
    y = torch.randint(0, 256, (b, ph, pw), generator=g, dtype=U8)
    u = torch.randint(0, 256, (b, ph // 2, pw // 2), generator=g, dtype=U8)
    v = torch.randint(0, 256, (b, ph // 2, pw // 2), generator=g, dtype=U8)
    a = (torch.randint(0, 256, (b, h, w), generator=g, dtype=U8)
         if alpha else None)
    args = [t.to(cuda) for t in (y, u, v)]
    ad = a.to(cuda) if alpha else None
    before = yuv420_to_rgba.launches
    got = yuv420_to_rgba(*args, h, w, ad)
    want = yuv420_to_rgba_plain(*args, h, w, ad)
    torch.cuda.synchronize()
    assert yuv420_to_rgba.launches == before + 1
    assert got.shape == (b, h, w, 4) and torch.equal(got, want)


def test_yuv420_to_rgba_rejects_bad_tensors(cuda):
    from gowebp_tpu_torch.ops.kernels.yuv420_to_rgba import yuv420_to_rgba

    y = torch.zeros((2, 32, 32), dtype=torch.uint8, device=cuda)
    c = torch.zeros((2, 16, 16), dtype=torch.uint8, device=cuda)
    with pytest.raises(TypeError):
        yuv420_to_rgba(y.to(torch.int32), c, c, 32, 32)
    with pytest.raises(ValueError):
        yuv420_to_rgba(y, c[:, :, :8], c[:, :, :8], 32, 32)   # too narrow
    with pytest.raises(ValueError):
        yuv420_to_rgba(y, c.transpose(1, 2), c, 32, 32)       # a view
    with pytest.raises(ValueError):
        yuv420_to_rgba(y, c, c, 32, 32, alpha=y[:, :16])      # alpha shape


def test_batch_decode_gpu_pixels_equal_cpu_pixels(cuda):
    from gowebp_tpu_torch import decode_rgba_batch, encode_rgba_batch
    from gowebp_tpu_torch.utils.corpus import natural_image

    datas = []
    for h, w in ((45, 61), (64, 64)):
        imgs = [natural_image(h, w, seed=s) for s in (1, 2)]
        datas += encode_rgba_batch(imgs, quality=75.0, device="cuda")
    got = decode_rgba_batch(datas, device="cuda")
    want = decode_rgba_batch(datas, device="cpu")
    for a, b in zip(got, want):
        assert a.shape == b.shape and np.array_equal(a, b)
    dev = decode_rgba_batch(datas, device="cuda", device_out=True)
    for a, b in zip(dev, want):
        assert a.is_cuda and np.array_equal(a.cpu().numpy(), b)


def _pillow(img, **kw):
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "WEBP", **kw)
    return buf.getvalue()


def _alpha_plane(h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    a = (255 * xx / max(w - 1, 1) + 30 * np.sin(yy / 4)).clip(0, 255)
    a[: h // 3, : w // 3] = 0
    return a.astype(np.uint8)


def _mixed_files():
    """Lossy files of the port's encoder at two sizes, lossy + ALPH and
    VP8L files of Pillow."""
    from gowebp_tpu_torch import encode_rgba_batch
    from gowebp_tpu_torch.utils.corpus import natural_image

    datas = []
    for h, w in ((45, 61), (64, 64)):
        imgs = [natural_image(h, w, seed=s) for s in (1, 2)]
        datas += encode_rgba_batch(imgs, quality=75.0, device="cuda")
    for s, (h, w) in enumerate(((45, 61), (64, 64), (64, 64))):
        rgba = np.dstack([natural_image(h, w, seed=10 + s),
                          _alpha_plane(h, w)])
        datas.insert(2 * s + 1, _pillow(rgba, quality=80))
    datas.insert(3, _pillow(natural_image(40, 24, seed=20), lossless=True))
    datas.append(_pillow(np.dstack([natural_image(64, 64, seed=21),
                                    _alpha_plane(64, 64)]), lossless=True,
                         exact=True))
    return datas


def test_mixed_batch_decode_gpu_equals_cpu(cuda):
    from gowebp_tpu_torch import decode_rgba_batch

    datas = _mixed_files()
    want = decode_rgba_batch(datas, device="cpu")
    for backend in ("device", "host"):
        got = decode_rgba_batch(datas, device="cuda", threads=2,
                                recon_backend=backend)
        for a, b in zip(got, want):
            assert a.shape == b.shape and np.array_equal(a, b)
        dev = decode_rgba_batch(datas, device="cuda", device_out=True,
                                recon_backend=backend)
        for a, b in zip(dev, want):
            assert a.is_cuda and np.array_equal(a.cpu().numpy(), b)


def test_alph_group_launches_the_kernel_with_alpha(cuda, monkeypatch):
    dec = importlib.import_module("gowebp_tpu_torch.decode")
    from gowebp_tpu_torch.ops.kernels.yuv420_to_rgba import yuv420_to_rgba

    seen = []
    real = dec.yuv420_to_rgba

    def spy(y, u, v, height, width, alpha=None):
        seen.append(alpha is not None and alpha.is_cuda)
        return real(y, u, v, height, width, alpha)

    monkeypatch.setattr(dec, "yuv420_to_rgba", spy)
    datas = _mixed_files()
    before = yuv420_to_rgba.launches
    before_alpha = yuv420_to_rgba.alpha_launches
    got = dec.decode_rgba_batch(datas, device="cuda")
    torch.cuda.synchronize()
    # groups (45x61, with and without ALPH) and (64x64, with and without)
    assert sorted(seen) == [False, False, True, True]
    assert yuv420_to_rgba.launches == before + 4
    assert yuv420_to_rgba.alpha_launches == before_alpha + 2
    np.testing.assert_array_equal(got[1][..., 3], _alpha_plane(45, 61))


def test_host_backend_device_out_gives_cuda_tensors(cuda):
    from gowebp_tpu_torch import decode_rgba_batch
    from gowebp_tpu_torch.ops.kernels.yuv420_to_rgba import yuv420_to_rgba

    datas = _mixed_files()
    before = yuv420_to_rgba.launches
    got = decode_rgba_batch(datas, device="cuda", device_out=True,
                            recon_backend="host")
    assert yuv420_to_rgba.launches == before      # all on the host
    want = decode_rgba_batch(datas, device="cpu", recon_backend="host")
    for a, b in zip(got, want):
        assert a.is_cuda and a.dtype == torch.uint8
        assert np.array_equal(a.cpu().numpy(), b)


@pytest.mark.parametrize("h,w", [(1, 64), (17, 1), (33, 49)])
def test_alph_odd_sizes_gpu_equals_cpu(cuda, h, w):
    from gowebp_tpu_torch import decode_rgba_batch
    from gowebp_tpu_torch.utils.corpus import natural_image

    datas = [_pillow(np.dstack([natural_image(h, w, seed=s),
                                _alpha_plane(h, w)]), quality=70)
             for s in (1, 2)]
    got = decode_rgba_batch(datas, device="cuda")
    want = decode_rgba_batch(datas, device="cpu")
    for a, b in zip(got, want):
        assert a.shape == (h, w, 4) and np.array_equal(a, b)
        assert np.array_equal(a[..., 3], _alpha_plane(h, w))


@pytest.mark.parametrize("b,h,w,quality", [
    (3, 64, 96, 75.0),
    (2, 16, 64, 99.0),       # one MB row
    (1, 64, 16, 40.0),       # one MB column
    (1, 16, 16, 75.0),       # one MB: the grid's last CUDA block is ragged
])
def test_encode_plane_kernels_match_plain(cuda, b, h, w, quality):
    from gowebp_tpu_torch.models.vp8.encoder import make_quants, quality_to_q
    from gowebp_tpu_torch.ops.kernels.encode_plane import (
        encode_chroma, encode_chroma_plain, encode_luma, encode_luma_plain)

    g = torch.Generator().manual_seed(h * 100 + w)
    ys, cs = h * w, (h // 2) * (w // 2)
    buf = torch.randint(0, 256, (b, ys + 2 * cs), generator=g,
                        dtype=torch.uint8).to(cuda)
    y = buf[:, :ys].reshape(b, h, w)                  # views, as the
    u = buf[:, ys:ys + cs].reshape(b, h // 2, w // 2)  # pipeline gives
    v = buf[:, ys + cs:].reshape(b, h // 2, w // 2)
    q = make_quants(quality_to_q(quality))
    lq = ((1 << 17) // q.y1_dc.q, 96 << 9, (1 << 17) // q.y1_ac.q, 110 << 9)
    y2q = ((1 << 17) // q.y2_dc.q, 96 << 9, (1 << 17) // q.y2_ac.q, 96 << 9)
    cq = ((1 << 17) // q.uv_dc.q, 110 << 9, (1 << 17) // q.uv_ac.q, 110 << 9)
    before = (encode_luma.launches, encode_chroma.launches)
    got = encode_luma(y, lq, y2q) + encode_chroma(u, v, cq)
    want = encode_luma_plain(y, lq, y2q) + encode_chroma_plain(u, v, cq)
    torch.cuda.synchronize()
    assert (encode_luma.launches, encode_chroma.launches) == tuple(
        n + 1 for n in before)
    for a, e in zip(got, want):
        assert a.dtype == e.dtype and torch.equal(a, e)


def _plane_quants(quality):
    from gowebp_tpu_torch.models.vp8.encoder import make_quants, quality_to_q

    q = make_quants(quality_to_q(quality))
    return (((1 << 17) // q.y1_dc.q, 96 << 9, (1 << 17) // q.y1_ac.q, 110 << 9),
            ((1 << 17) // q.y2_dc.q, 96 << 9, (1 << 17) // q.y2_ac.q, 96 << 9),
            ((1 << 17) // q.uv_dc.q, 110 << 9, (1 << 17) // q.uv_ac.q,
             110 << 9))


def _check_plane_kernels(y, u, v, quality):
    """Both plane kernels and both modes-only forms against their plain
    versions, one launch each."""
    from gowebp_tpu_torch.ops.kernels import encode_plane as ep

    lq, y2q, cq = _plane_quants(quality)
    counters = (ep.encode_luma, ep.encode_chroma, ep.encode_luma_modes,
                ep.encode_chroma_modes)
    before = [k.launches for k in counters]
    got = (ep.encode_luma(y, lq, y2q) + ep.encode_chroma(u, v, cq)
           + ep.encode_modes(y, u, v))
    want = (ep.encode_luma_plain(y, lq, y2q) + ep.encode_chroma_plain(u, v, cq)
            + (ep.encode_luma_modes_plain(y),
               ep.encode_chroma_modes_plain(u, v)))
    torch.cuda.synchronize()
    assert [k.launches for k in counters] == [n + 1 for n in before]
    for a, e in zip(got, want):
        assert a.dtype == e.dtype and torch.equal(a, e)


@pytest.mark.parametrize("b,h,w,quality", [
    (3, 64, 96, 75.0),
    (2, 16, 64, 99.0),       # one MB row
    (1, 64, 16, 40.0),       # one MB column
    (2, 48, 272, 75.0),      # 17 MB columns: luma strips of 8 and 1 MBs
    (1, 16, 16, 75.0),       # one MB
])
def test_modes_only_kernels_match_plain(cuda, b, h, w, quality):
    g = torch.Generator().manual_seed(h * 10 + w)
    y = torch.randint(0, 256, (b, h, w), generator=g, dtype=torch.uint8)
    u = torch.randint(0, 256, (b, h // 2, w // 2), generator=g,
                      dtype=torch.uint8)
    v = torch.randint(0, 256, (b, h // 2, w // 2), generator=g,
                      dtype=torch.uint8)
    _check_plane_kernels(y.to(cuda), u.to(cuda), v.to(cuda), quality)


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("stride_pad", [0, 1, 2, 3, 5])
def test_plane_kernels_take_unaligned_views(cuda, offset, stride_pad):
    """Planes that start 1-3 bytes past an aligned address, with batch
    strides that are no multiple of 4: views of one buffer."""
    b, h, w = 3, 48, 80
    ys, cs = h * w, (h // 2) * (w // 2)
    stride = offset + ys + 2 * cs + stride_pad
    g = torch.Generator().manual_seed(offset * 10 + stride_pad)
    buf = torch.randint(0, 256, (b * stride + 16,), generator=g,
                        dtype=torch.uint8).to(cuda)

    def view(start, rows, cols):
        return buf.as_strided((b, rows, cols), (stride, cols, 1), start)

    y = view(offset, h, w)
    u = view(offset + ys + stride_pad, h // 2, w // 2)
    v = view(offset + ys + cs + 2 * stride_pad, h // 2, w // 2)
    assert y.data_ptr() % 4 == offset % 4
    _check_plane_kernels(y, u, v, 75.0)


def test_hybrid_cold_round_launches_modes_only_kernels(cuda):
    """One modes-only launch of each plane kernel a chunk with cold="i16"
    (and refine=1), none with cold="dense"; the bytes stay the CPU's."""
    from gowebp_tpu_torch.ops.encode_pipeline import (
        encode_rgba_batch_pipelined)
    from gowebp_tpu_torch.ops.kernels import encode_plane as ep
    from gowebp_tpu_torch.utils.corpus import natural_image

    imgs = [natural_image(45, 61, seed=s) for s in (1, 2, 3)]
    for cold, per_chunk in (("i16", 1), ("dense", 0)):
        kw = dict(quality=75.0, chunk=2, cold=cold)
        before = (ep.encode_luma_modes.launches,
                  ep.encode_chroma_modes.launches)
        got = encode_rgba_batch_pipelined(imgs, device="cuda", **kw)
        assert (ep.encode_luma_modes.launches - before[0],
                ep.encode_chroma_modes.launches - before[1]) == (
            2 * per_chunk, 2 * per_chunk)                  # 2 chunks
        assert got == encode_rgba_batch_pipelined(imgs, device="cpu", **kw)


def test_encode_plane_wrappers_reject_bad_tensors(cuda):
    from gowebp_tpu_torch.ops.kernels.encode_plane import (encode_chroma,
                                                           encode_luma)

    q = (8192, 96 << 9, 8192, 110 << 9)
    y = torch.zeros((2, 32, 48), dtype=torch.uint8, device=cuda)
    c = torch.zeros((2, 16, 24), dtype=torch.uint8, device=cuda)
    with pytest.raises(TypeError):
        encode_luma(y.to(torch.int32), q, q)
    with pytest.raises(ValueError):
        encode_luma(y[:, :24], q, q)                      # not MB-aligned
    with pytest.raises(ValueError):
        encode_luma(y.transpose(1, 2).contiguous().transpose(1, 2), q, q)
    with pytest.raises(ValueError):
        encode_chroma(c, c[:, :8], q)                     # u, v differ


def test_openloop_encode_gpu_bytes_equal_cpu_bytes(cuda):
    from gowebp_tpu_torch import encode_rgba_batch
    from gowebp_tpu_torch.ops.kernels.encode_plane import encode_luma
    from gowebp_tpu_torch.utils.corpus import natural_image

    imgs = [natural_image(45, 61, seed=s) for s in (1, 2)]
    for quality in (75.0, 99.0):
        before = encode_luma.launches
        got = encode_rgba_batch(imgs, quality=quality, device="cuda",
                                engine="openloop")
        assert encode_luma.launches == before + 1
        assert got == encode_rgba_batch(imgs, quality=quality, device="cpu",
                                        engine="openloop")


def _search_tensors(cuda, rng, y, u, v, pens=()):
    """wavefront_search's inputs for the planes y, u, v: random segments of
    4 q75 quantizer rows and their penalties, the first ones replaced by
    ``pens``."""
    from gowebp_tpu_torch.models.vp8.encoder import (_i4_config_seg,
                                                     make_quants,
                                                     quality_to_q)

    B, H, W = y.shape
    rows = []
    for d in (-6, -2, 3, 8):
        q = make_quants(quality_to_q(75.0) + d)
        rows.append([q.y1_dc.q, q.y1_ac.q, q.y2_dc.q, q.y2_ac.q, q.uv_dc.q,
                     q.uv_ac.q])
    rows = np.array(rows, np.int32)
    pen = _i4_config_seg(rows, 4, 0)[1].astype(np.int32)
    pen[:len(pens)] = pens
    t = lambda a, dt=np.uint8: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(np.clip(a, 0, 255) if dt == np.uint8 else a)
        .astype(dt)).to(cuda)
    return (t(y), t(u), t(v),
            t(rng.integers(0, 4, (B, H // 16, W // 16)), np.int32),
            t(np.broadcast_to(rows, (B, 4, 6)), np.int32),
            t(np.broadcast_to(pen, (B, 4)), np.int32))


def _search_case(cuda, seed, B, H, W):
    """Planes whose MBs are noisy, flat or a gentle gradient (both i16 and
    i4 win), 4 segments with their quantizers and penalties."""
    rng = np.random.default_rng(seed)
    mh, mw = H // 16, W // 16
    yy, xx = np.mgrid[0:H, 0:W]
    kind = rng.integers(0, 3, (B, mh, mw)).repeat(16, 1).repeat(16, 2)
    y = np.where(kind == 0, rng.integers(0, 256, (B, H, W)), np.where(
        kind == 1, 128, 60 + 100 * xx / W + 50 * yy / H))
    u = rng.integers(100, 156, (B, H // 2, W // 2))
    v = 128 + rng.integers(-3, 4, (B, H // 2, W // 2))
    return _search_tensors(cuda, rng, y, u, v)


def _tie_case(cuda, seed, B, H, W):
    """Tie-heavy planes: flat MBs and MBs of gentle gradients, where
    several B-modes predict alike, with penalties 0 and 1 on two of the 4
    segments, where equal SSEs make equal scores."""
    rng = np.random.default_rng(seed)
    mh, mw = H // 16, W // 16
    yy, xx = np.mgrid[0:H, 0:W] % 16
    kind = rng.integers(0, 4, (B, mh, mw)).repeat(16, 1).repeat(16, 2)
    level = rng.integers(16, 240, (B, mh, mw)).repeat(16, 1).repeat(16, 2)
    y = level + np.select([kind == 1, kind == 2, kind == 3],
                          [xx // 4, yy // 4, (xx + yy) // 8], 0)
    u = np.full((B, H // 2, W // 2), 128)
    v = rng.integers(120, 124, (B, mh, mw)).repeat(8, 1).repeat(8, 2)
    return _search_tensors(cuda, rng, y, u, v, pens=(0, 1))


@pytest.mark.parametrize("try_i4", [True, False])
@pytest.mark.parametrize("derr", [False, True])
@pytest.mark.parametrize("B,H,W", [
    (3, 64, 96),
    (2, 16, 80),        # one MB row
    (2, 80, 16),        # one MB column
    (1, 16, 16),
    (40, 512, 32),      # 1,280 MB rows: more than the card holds blocks
])
def test_wavefront_search_kernel_matches_plain(cuda, try_i4, derr, B, H, W):
    from gowebp_tpu_torch.ops.kernels.wavefront_search import (
        search_tables, wavefront_search, wavefront_search_plain)

    args = _search_case(cuda, 7 + H + W, B, H, W)
    rate = search_tables(_tables(cuda))
    want = wavefront_search_plain(*args, rate, try_i4=try_i4, use_derr=derr,
                                  want_recon=True)
    for recon in (True, False):
        before = wavefront_search.launches
        got = wavefront_search(*args, rate, try_i4=try_i4, use_derr=derr,
                               want_recon=recon)
        torch.cuda.synchronize()
        assert wavefront_search.launches == before + 1
        assert set(got) == set(want) if recon else set(got) < set(want)
        for k in got:
            assert torch.equal(got[k], want[k]), k
    if try_i4 and B * H * W > 4096:
        assert 0 < want["is_i4"].float().mean() < 1


@pytest.mark.parametrize("derr", [False, True])
@pytest.mark.parametrize("B,H,W", [(2, 48, 80), (3, 64, 96), (1, 16, 16)])
def test_wavefront_search_kernel_matches_plain_on_ties(cuda, derr, B, H, W):
    from gowebp_tpu_torch.ops.kernels.wavefront_search import (
        search_tables, wavefront_search, wavefront_search_plain)

    args = _tie_case(cuda, 11 + H + W, B, H, W)
    rate = search_tables(_tables(cuda))
    want = wavefront_search_plain(*args, rate, try_i4=True, use_derr=derr,
                                  want_recon=True)
    got = wavefront_search(*args, rate, try_i4=True, use_derr=derr,
                           want_recon=True)
    torch.cuda.synchronize()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_wavefront_search_rejects_bad_tensors(cuda):
    from gowebp_tpu_torch.ops.kernels.wavefront_search import (
        search_tables, wavefront_search)

    args = list(_search_case(cuda, 1, 2, 32, 48))
    rate = search_tables(_tables(cuda))
    before = wavefront_search.launches
    for i, t, err in ((0, args[0].to(torch.int32), TypeError),      # y dtype
                      (0, args[0].transpose(1, 2), ValueError),     # a view
                      (3, args[3][:, :1], ValueError),              # seg shape
                      (5, args[5][:, :3].contiguous(), ValueError),  # pens
                      (5, args[5].cpu(), ValueError)):              # device
        bad = list(args)
        bad[i] = t
        with pytest.raises(err):
            wavefront_search(*bad, rate, try_i4=True, use_derr=True,
                             want_recon=False)
    with pytest.raises(ValueError):              # a table of the wrong shape
        wavefront_search(*args, (rate[0][:2],) + rate[1:], try_i4=True,
                         use_derr=True, want_recon=False)
    with pytest.raises(ValueError):              # not MB multiples
        wavefront_search(args[0][:, :24], *args[1:], rate, try_i4=True,
                         use_derr=True, want_recon=False)
    assert wavefront_search.launches == before


def test_wavefront_engine_gpu_bytes_equal_cpu_bytes(cuda):
    from gowebp_tpu_torch import encode_rgba_batch
    from gowebp_tpu_torch.ops.kernels.wavefront_search import wavefront_search
    from gowebp_tpu_torch.utils.corpus import natural_image

    imgs = [natural_image(45, 61, seed=s) for s in (1, 2)]
    for quality in (75.0, 99.0):
        before = wavefront_search.launches
        got = encode_rgba_batch(imgs, quality=quality, device="cuda",
                                engine="wavefront")
        assert wavefront_search.launches == before + 1
        assert got == encode_rgba_batch(imgs, quality=quality, device="cpu",
                                        engine="wavefront")


def test_wavefront_engine_without_i4_runs_the_lean_kernel(cuda, monkeypatch):
    """A config that turns the i4 search off (method 3) launches the
    try_i4=False form of the full-search kernel, and no i4 kernel."""
    from gowebp_tpu_torch.config import EncoderConfig
    from gowebp_tpu_torch.ops.encode_pipeline import (
        encode_rgba_batch_pipelined)
    from gowebp_tpu_torch.ops.kernels import wavefront_search as wsm
    from gowebp_tpu_torch.ops.kernels.i4_search import i4_search, i4_walk
    from gowebp_tpu_torch.utils.corpus import natural_image

    class Spy:
        def __init__(self, lib):
            self.lib, self.try_i4 = lib, []

        def wavefront_search_launch(self, *a):
            self.try_i4.append(a[26])          # the form: bit 0 try_i4
            return self.lib.wavefront_search_launch(*a)

    spy = Spy(wsm.LIBRARY.load())
    monkeypatch.setattr(wsm.LIBRARY, "_lib", spy)
    imgs = [natural_image(45, 61, seed=s) for s in (1, 2)]
    cfg = EncoderConfig(lossless=False, method=3)
    before = (i4_search.launches, i4_walk.launches)
    got = encode_rgba_batch_pipelined(imgs, device="cuda", config=cfg,
                                      engine="wavefront")
    assert spy.try_i4 == [0]
    assert (i4_search.launches, i4_walk.launches) == before
    assert got == encode_rgba_batch_pipelined(imgs, device="cpu", config=cfg,
                                              engine="wavefront")


@pytest.mark.parametrize("b,h,w,ph,pw", [
    (3, 61, 95, 64, 96), (1, 1, 1, 16, 16), (2, 17, 2, 32, 16)])
def test_yuv420_to_rgba_nearest_matches_plain(cuda, b, h, w, ph, pw):
    """fancy=False (no_fancy_upsampling): nearest chroma samples."""
    from gowebp_tpu_torch.ops.kernels.yuv420_to_rgba import (
        yuv420_to_rgba, yuv420_to_rgba_plain)

    g = torch.Generator().manual_seed(h * 7 + w)
    planes = [torch.randint(0, 256, s, generator=g, dtype=torch.uint8)
              .to(cuda) for s in ((b, ph, pw), (b, ph // 2, pw // 2),
                                  (b, ph // 2, pw // 2))]
    got = yuv420_to_rgba(*planes, h, w, fancy=False)
    want = yuv420_to_rgba_plain(*planes, h, w, fancy=False)
    assert torch.equal(got, want)
    assert not torch.equal(got, yuv420_to_rgba(*planes, h, w)) or h * w == 1


def _chip_smoke():
    """chip_smoke.py, loaded as a module."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _recon_case(seed, B, mb_h, mb_w):
    """chip_smoke.py's random recon inputs (i4/i16 mixes, skip MBs, four
    segments with distinct filter levels, one off), on the CPU."""
    return _chip_smoke().random_symbols("cpu", seed, B, mb_h, mb_w)


RECON_GRIDS = [(2, 3, 5), (1, 1, 5), (1, 5, 1), (1, 1, 1), (3, 4, 6)]


@pytest.mark.parametrize("filter_type", [0, 1, 2])
@pytest.mark.parametrize("B,mb_h,mb_w", RECON_GRIDS)
def test_recon_filter_mb_kernel_matches_plain(cuda, filter_type, B, mb_h,
                                              mb_w):
    from gowebp_tpu_torch.ops.kernels.vp8_recon import (
        recon_filter_mb, recon_filter_mb_plain)

    coeffs, modes, fp = _recon_case(B * 31 + mb_h * 7 + mb_w, B, mb_h, mb_w)
    want = recon_filter_mb_plain(coeffs, modes, fp, mb_w, mb_h, filter_type)
    before = recon_filter_mb.launches
    got = recon_filter_mb(coeffs.to(cuda), modes.to(cuda), fp.to(cuda), mb_w,
                          mb_h, filter_type)
    torch.cuda.synchronize()
    assert recon_filter_mb.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_recon_frame_on_the_card_launches_the_kernel(cuda):
    """recon_frame sends CUDA tensors to the one kernel: the GPU planes
    equal the CPU loops'."""
    from gowebp_tpu_torch.ops.kernels.vp8_recon import recon_filter_mb
    from gowebp_tpu_torch.ops.vp8_recon import recon_frame

    coeffs, modes, fp = _recon_case(5, 2, 3, 4)
    m = modes.to(torch.int32)
    args = (coeffs, m[..., 0], m[..., 2:], m[..., 1], fp)
    before = recon_filter_mb.launches
    marks = []
    got = recon_frame(*(a.to(cuda) for a in args), mb_w=4, mb_h=3,
                      filter_type=2, marks=marks.append)
    want = recon_frame(*args, mb_w=4, mb_h=3, filter_type=2)
    assert recon_filter_mb.launches == before + 1
    assert marks == ["recon"]
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_recon_filter_mb_rejects_bad_tensors(cuda):
    from gowebp_tpu_torch.ops.kernels.vp8_recon import recon_filter_mb

    coeffs, modes, fp = (t.to(cuda) for t in _recon_case(1, 1, 2, 2))
    with pytest.raises(TypeError):
        recon_filter_mb(coeffs.to(torch.int32), modes, fp, 2, 2, 2)
    with pytest.raises(TypeError):
        recon_filter_mb(coeffs, modes.to(torch.int32), fp, 2, 2, 2)
    with pytest.raises(ValueError):
        recon_filter_mb(coeffs, modes[:, :, :16], fp, 2, 2, 2)
    with pytest.raises(ValueError):
        recon_filter_mb(coeffs, modes, fp, 3, 1, 2)
    with pytest.raises(ValueError):
        recon_filter_mb(coeffs, modes, fp, 2, 2, 3)
    with pytest.raises(ValueError):
        recon_filter_mb(coeffs, modes, fp[:, :1], 2, 2, 2)
    with pytest.raises(ValueError):
        recon_filter_mb(coeffs.transpose(2, 3).contiguous().transpose(2, 3),
                        modes, fp, 2, 2, 2)


def _single_files():
    from gowebp_tpu_torch.utils.corpus import natural_image

    h, w = 45, 61
    yy, xx = np.mgrid[0:h, 0:w]
    alpha = (255 * xx / (w - 1)).astype(np.uint8)
    alpha[:h // 3, :w // 3] = 0
    smooth = np.stack([4 * xx, 5 * yy, xx + yy], -1).astype(np.uint8)
    return {"lossy": _pillow(natural_image(h, w, seed=1), quality=75),
            "smooth_q95": _pillow(smooth, quality=95),
            "alph": _pillow(np.dstack([natural_image(h, w, seed=2), alpha]),
                            quality=75),
            "vp8l": _pillow(np.dstack([natural_image(h, w, seed=3), alpha]),
                            lossless=True, exact=True)}


SINGLE_CONFIGS = [
    {}, {"use_cropping": True, "crop_left": 5, "crop_top": 3,
         "crop_width": 40, "crop_height": 31},
    {"use_scaling": True, "scaled_width": 90}, {"flip": True},
    {"bypass_filtering": True}, {"no_fancy_upsampling": True},
    {"dithering_strength": 50}, {"alpha_dithering_strength": 50},
    {"use_cropping": True, "crop_left": 5, "crop_top": 3, "crop_width": 40,
     "crop_height": 31, "use_scaling": True, "scaled_height": 17,
     "flip": True}]


@pytest.mark.parametrize("name", ["lossy", "smooth_q95", "alph", "vp8l"])
def test_single_file_decode_gpu_equals_cpu(cuda, name):
    """decode() on the card (recon_filter_mb, yuv420_to_rgba and torch
    output options) against device="cpu", every option and mode."""
    from gowebp_tpu_torch import DecoderConfig, decode, decode_yuva
    from gowebp_tpu_torch.ops.kernels.vp8_recon import recon_filter_mb

    data = _single_files()[name]
    before = recon_filter_mb.launches
    for kw in SINGLE_CONFIGS:
        cfg = DecoderConfig(**kw)
        for mode in ("RGBA", "bgrA", "RGB_565", "ARGB", "rgbA_4444"):
            got = decode(data, cfg, mode, device="cuda")
            want = decode(data, cfg, mode, device="cpu")
            assert got.shape == want.shape and np.array_equal(got, want)
        if name != "vp8l":
            for a, b in zip(decode_yuva(data, cfg, device="cuda"),
                            decode_yuva(data, cfg, device="cpu")):
                assert (a is None) == (b is None)
                assert a is None or np.array_equal(a, b)
    assert (recon_filter_mb.launches > before) == (name != "vp8l")


def test_single_file_decode_launches_the_decode_kernels(cuda):
    from gowebp_tpu_torch import decode, decode_rgba_batch
    from gowebp_tpu_torch.ops.kernels.vp8_recon import recon_filter_mb
    from gowebp_tpu_torch.ops.kernels.yuv420_to_rgba import yuv420_to_rgba

    files = list(_single_files().values())
    before = (recon_filter_mb.launches, yuv420_to_rgba.launches)
    got = [decode(d, device="cuda") for d in files]
    after = (recon_filter_mb.launches, yuv420_to_rgba.launches)
    assert [a - b for a, b in zip(after, before)] == [3, 3]
    for a, b in zip(got, decode_rgba_batch(files, device="cuda")):
        assert np.array_equal(a, b)


def _trellis_inputs(cuda, seed):
    """The trellis form's rate tables (of perturbed probabilities, as a
    first pass's adapted ones are) and per-segment lambdas (B=1 row,
    broadcast by the caller)."""
    from gowebp_tpu_torch.models.vp8.cost import trellis_cost_tables
    from gowebp_tpu_torch.models.vp8.tables import COEFF_PROBAS

    rng = np.random.default_rng(seed)
    probs = np.clip(COEFF_PROBAS.astype(np.int64)
                    + rng.integers(-60, 61, COEFF_PROBAS.shape), 1, 255)
    tables = tuple(torch.from_numpy(t.astype(np.int32)).to(cuda)
                   for t in trellis_cost_tables(probs.astype(np.uint8)))
    lams = torch.tensor([[1, 3, 7, 24]], dtype=torch.int32, device=cuda)
    return tables, lams


@pytest.mark.parametrize("try_i4", [True, False])
@pytest.mark.parametrize("derr", [False, True])
@pytest.mark.parametrize("B,H,W", [
    (3, 64, 96), (2, 16, 80), (2, 80, 16), (1, 16, 16), (20, 256, 32)])
def test_wavefront_search_trellis_kernel_matches_plain(cuda, try_i4, derr, B,
                                                       H, W):
    """The trellis form (method 6's second pass) against its plain version:
    every block's levels trellis-refined, tables of adapted
    probabilities, 4 segments with their own lambdas."""
    from gowebp_tpu_torch.ops.kernels.wavefront_search import (
        search_tables, wavefront_search, wavefront_search_plain)

    args = _search_case(cuda, 5 + H + W, B, H, W)
    tables, lams = _trellis_inputs(cuda, H + W)
    lams = lams.expand(B, 4).contiguous()
    rate = search_tables(tables, trellis=True)
    want = wavefront_search_plain(*args, rate, try_i4=try_i4, use_derr=derr,
                                  want_recon=True, lams=lams)
    before = (wavefront_search.launches, wavefront_search.trellis_launches)
    got = wavefront_search(*args, rate, try_i4=try_i4, use_derr=derr,
                           want_recon=True, lams=lams)
    torch.cuda.synchronize()
    assert (wavefront_search.launches,
            wavefront_search.trellis_launches) == (before[0], before[1] + 1)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _trellis_tie_case(cuda, seed, B, H, W):
    """Inputs that force equal trellis costs: steps of 4 (Y2 8) in every
    segment, free bits and value costs of 8 v under every context, and
    lambda 1, so that a level v >= 2 of a coefficient 4 v - 1 costs 8 v +
    1 kept and lowered alike, and the two states that tie stay tied;
    noisy, flat and gradient MBs.  The search's tables are the same, its
    penalties 0 and 1 (i4 and i16 MBs, ties between B-modes)."""
    args = list(_search_case(cuda, seed, B, H, W))
    args[4] = torch.tensor([4, 4, 8, 8, 4, 4], dtype=torch.int32,
                           device=cuda).expand(B, 4, 6).contiguous()
    args[5] = torch.tensor([0, 1, 0, 1], dtype=torch.int32,
                           device=cuda).expand(B, 4).contiguous()
    p0 = torch.zeros((4, 8, 3, 2), dtype=torch.int32, device=cuda)
    val = (8 * torch.arange(68, dtype=torch.int32, device=cuda)).expand(
        4, 8, 3, 68).contiguous()
    lams = torch.ones((B, 4), dtype=torch.int32, device=cuda)
    return tuple(args), (p0, p0.clone(), val), lams


@pytest.mark.parametrize("derr", [False, True])
@pytest.mark.parametrize("B,H,W", [(2, 48, 80), (3, 64, 96), (1, 16, 16)])
def test_wavefront_search_trellis_kernel_matches_plain_on_ties(cuda, derr, B,
                                                               H, W):
    """The trellis form against its plain version where trellis costs tie
    (``_trellis_tie_case``): the strict comparison keeps the unlowered
    level and the lower predecessor in the kernel's scan as in the serial
    DP."""
    from gowebp_tpu_torch.ops.kernels.wavefront_search import (
        search_tables, wavefront_search, wavefront_search_plain)

    args, tables, lams = _trellis_tie_case(cuda, 13 + H + W, B, H, W)
    rate = search_tables(tables, trellis=True)
    want = wavefront_search_plain(*args, rate, try_i4=True, use_derr=derr,
                                  want_recon=True, lams=lams)
    got = wavefront_search(*args, rate, try_i4=True, use_derr=derr,
                           want_recon=True, lams=lams)
    torch.cuda.synchronize()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_wavefront_search_ptxas_has_no_stack_or_spills(cuda, tmp_path):
    """All six forms of wavefront_search.cu (try_i4 x trellis, and the
    stripe form with and without try_i4) compile to no stack frame and no
    spills (nvcc -Xptxas -v, built here anew)."""
    import subprocess

    from gowebp_tpu_torch.ops.kernels.cuda_build import NVCC_FLAGS, nvcc
    from gowebp_tpu_torch.ops.kernels.wavefront_search import LIBRARY

    out = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp_path / "lib.so"),
         str(LIBRARY.source)], capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
    smoke = _chip_smoke()
    report = smoke.ptxas_report(out.stdout + out.stderr,
                                "wavefront_search_kernel")
    forms = {smoke.search_form(name): (stack, st, ld)
             for name, _, stack, st, ld in report}
    assert len(forms) == 6, report
    assert all(v == (0, 0, 0) for v in forms.values()), forms


def test_wavefront_search_trellis_rejects_bad_lambdas(cuda):
    from gowebp_tpu_torch.ops.kernels.wavefront_search import (
        search_tables, wavefront_search)

    args = _search_case(cuda, 1, 2, 32, 48)
    tables, lams = _trellis_inputs(cuda, 1)
    rate = search_tables(tables, trellis=True)
    before = wavefront_search.trellis_launches
    for bad_lams, bad_rate in ((lams, rate),                 # (1, 4) for B=2
                               (lams.expand(2, 4).contiguous(),
                                search_tables(tables))):     # 3 types only
        with pytest.raises(ValueError):
            wavefront_search(*args, bad_rate, try_i4=True, use_derr=True,
                             want_recon=False, lams=bad_lams)
    assert wavefront_search.trellis_launches == before


def _alpha_image(h, w, seed):
    from gowebp_tpu_torch.utils.corpus import natural_image

    yy, xx = np.mgrid[0:h, 0:w]
    alpha = np.clip(255 * (xx + yy) / max(1, h + w - 2) + 20, 0, 255)
    alpha[: h // 3, : w // 3] = 0
    return np.dstack([natural_image(h, w, seed=seed),
                      alpha.astype(np.uint8)])


@pytest.mark.parametrize("kw", [
    {}, {"method": 6}, {"method": 6, "segments": 2, "quality": 99},
    {"autofilter": True}, {"target_psnr": 30.0, "passes": 2},
    {"plane_backend": "jax"}, {"plane_backend": "jax-openloop"},
    {"method": 6, "partition_limit": 100}])
def test_encode_rgba_gpu_bytes_equal_cpu_bytes(cuda, kw):
    """The single-image encode on the card gives the CPU path's bytes and
    statistics (an RGBA image with a soft alpha and a transparent
    corner)."""
    import gowebp_tpu_torch as T

    im = _alpha_image(45, 61, seed=4)
    cfg = T.EncoderConfig(**kw)
    s_gpu, s_cpu = T.EncodeStats(), T.EncodeStats()
    got = T.encode_rgba(im, config=cfg, stats=s_gpu, device="cuda")
    assert got == T.encode_rgba(im, config=cfg, stats=s_cpu, device="cpu")
    assert vars(s_gpu) == vars(s_cpu)


def test_encode_rgba_launches(cuda):
    """Launch counts of the single-image encode: the defaults launch
    wavefront_search once and no other kernel; method 6 the method <= 5
    form once and the trellis form once; autofilter recon_filter_mb once
    a trial level; plane_backend="jax-openloop" the two plane kernels."""
    import gowebp_tpu_torch as T
    from gowebp_tpu_torch.models.vp8.encoder import (filter_level_from_q,
                                                     quality_to_q)
    from gowebp_tpu_torch.ops.kernels import encode_plane as epm
    from gowebp_tpu_torch.ops.kernels import vp8_recon as kvr
    from gowebp_tpu_torch.ops.kernels import wavefront_search as wsm

    kernels = {"search": (wsm.wavefront_search, "launches"),
               "trellis": (wsm.wavefront_search, "trellis_launches"),
               "recon": (kvr.recon_filter_mb, "launches"),
               "luma": (epm.encode_luma, "launches"),
               "chroma": (epm.encode_chroma, "launches")}
    im = _alpha_image(40, 50, seed=2)

    def counts():
        return {k: getattr(f, a) for k, (f, a) in kernels.items()}

    def launched(**kw):
        before = counts()
        T.encode_rgba(im, config=T.EncoderConfig(**kw), device="cuda")
        return {k: n - before[k] for k, n in counts().items()
                if n != before[k]}

    assert launched() == {"search": 1}
    assert launched(method=6) == {"search": 1, "trellis": 1}
    assert launched(method=6, low_memory=True) == {"search": 1}
    base = filter_level_from_q(quality_to_q(75.0), 60, 0)
    levels = {0, base // 2, base, min(63, base + base // 2 + 1),
              min(63, 2 * base + 1)}
    assert launched(autofilter=True) == {"search": 1, "recon": len(levels)}
    assert launched(plane_backend="jax-openloop") == {"luma": 1, "chroma": 1}


def test_encode_yuv_gpu_bytes_equal_cpu_bytes(cuda):
    import gowebp_tpu_torch as T

    rng = np.random.default_rng(3)
    y = rng.integers(0, 256, (33, 47), dtype=np.uint8)
    u = rng.integers(0, 256, (17, 24), dtype=np.uint8)
    v = rng.integers(0, 256, (17, 24), dtype=np.uint8)
    a = rng.integers(0, 256, (33, 47), dtype=np.uint8)
    for kw in ({}, {"alpha": a, "method": 6}):
        assert (T.encode_yuv(y, u, v, device="cuda", **kw)
                == T.encode_yuv(y, u, v, device="cpu", **kw))


def test_mixed_non_opaque_batch_gpu_equals_cpu(cuda):
    from gowebp_tpu_torch import encode_rgba_batch

    imgs = [_alpha_image(33, 17, seed=1), _alpha_image(40, 48, seed=2)[..., :3]]
    assert (encode_rgba_batch(imgs, device="cuda")
            == encode_rgba_batch(imgs, device="cpu"))


def _argb_words(img):
    """(H, W, 3) uint8 → int32 tensor of the opaque ARGB words' bits;
    (H, W, 4) → with its alpha."""
    alpha = img[..., 3].astype(np.uint32) if img.shape[-1] == 4 else 255
    argb = ((alpha << 24) | (img[..., 0].astype(np.uint32) << 16)
            | (img[..., 1].astype(np.uint32) << 8) | img[..., 2])
    return torch.from_numpy(argb.astype(np.uint32).view(np.int32))


def _tie_images():
    """Flat, gradient and 2x2-periodic planes: every mode ties on some
    tiles, so the lowest mode must win in both versions.  The flat plane's
    tiles are all equal (every residual of modes 1-13 is 0: every lane on
    the hot bin); the ramp's inner tiles fill one bin: its R residual under
    L is 1 at every pixel, 1,024 counts in a bits-5 tile (the 16-bit
    field's most)."""
    yy, xx = np.mgrid[0:200, 0:328]
    flat = np.full((200, 328, 3), 77, np.uint8)
    grad = np.stack([xx % 256, yy % 256, (xx + yy) % 256], -1).astype(np.uint8)
    checker = np.where(((yy + xx) % 2)[..., None] == 0, 10, 240)
    ry, rx = np.mgrid[0:96, 0:160]
    ramp = np.stack([rx, ry, np.full_like(rx, 7)], -1).astype(np.uint8)
    return {"flat": flat, "gradient": grad,
            "checker": np.broadcast_to(checker, (200, 328, 3)).astype(
                np.uint8),
            "ramp": ramp}


@pytest.mark.parametrize("iters", [0, 2, 4])
@pytest.mark.parametrize("bits", [2, 3, 4, 5])
def test_vp8l_predictor_kernel_matches_plain(cuda, bits, iters):
    """The chooser kernel's mode map == its plain version's, bit for bit:
    a 1 MP corpus image (at bits 2, a 512x512 crop), forced ties, all-equal
    tiles, bins at the full count, and a soft alpha (no opaque skip)."""
    from gowebp_tpu_torch.ops.kernels.vp8l_predictor import (
        predictor_search_entropy, predictor_search_entropy_plain)
    from gowebp_tpu_torch.utils.corpus import natural_image

    side = 512 if bits == 2 else 1024
    imgs = dict(_tie_images(), photo=natural_image(side, side, seed=12),
                alpha=_alpha_image(160, 224, seed=5))
    for name, img in imgs.items():
        x = _argb_words(img).to(cuda)
        before = predictor_search_entropy.launches
        got = predictor_search_entropy(x, bits, iters)
        want = predictor_search_entropy_plain(x, bits, iters)
        torch.cuda.synchronize()
        assert 1 <= predictor_search_entropy.launches - before <= 1 + iters
        assert torch.equal(got, want), name


def test_vp8l_predictor_rejects_bad_tensors(cuda):
    from gowebp_tpu_torch.ops.kernels.vp8l_predictor import (
        predictor_search_entropy)

    x = torch.zeros((64, 64), dtype=torch.int32, device=cuda)
    before = predictor_search_entropy.launches
    for args in ((x.to(torch.int64), 4, 2), (x[:, ::2], 4, 2), (x, 6, 2),
                 (x[None], 4, 2)):
        with pytest.raises((TypeError, ValueError)):
            predictor_search_entropy(*args)
    assert predictor_search_entropy.launches == before


def test_vp8l_predictor_ptxas_has_no_stack_or_spills(cuda, tmp_path):
    """vp8l_predictor.cu compiles to no stack frame and no spills in any
    instantiation: stage 1 and a round at each of bits 2-5 (nvcc -Xptxas
    -v, built here anew)."""
    import re
    import subprocess

    from gowebp_tpu_torch.ops.kernels.cuda_build import NVCC_FLAGS, nvcc
    from gowebp_tpu_torch.ops.kernels.vp8l_predictor import LIBRARY

    out = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp_path / "lib.so"),
         str(LIBRARY.source)], capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
    report = _chip_smoke().ptxas_report(out.stdout + out.stderr,
                                        "vp8l_predictor_kernel")
    kinds = sorted(tuple(int(g) for g in re.search(
        r"vp8l_predictor_kernelILi(\d)ELb(\d)E", row[0]).groups())
        for row in report)
    assert kinds == [(b, r) for b in (2, 3, 4, 5) for r in (0, 1)], report
    for row in report:
        assert row[2:] == (0, 0, 0), row


@pytest.mark.parametrize("kw", [{}, {"method": 6, "quality": 95},
                                {"near_lossless": 60}])
def test_lossless_encode_gpu_bytes_equal_forced_cpu_bytes(cuda, monkeypatch,
                                                          kw):
    """With $GOWEBP_TPU_VP8L_ANALYSIS=1 the chooser runs on the card
    (launching the kernel) and on the CPU as its plain version: the same
    bytes, which decode to the source."""
    import gowebp_tpu_torch as T
    from gowebp_tpu_torch.ops.kernels.vp8l_predictor import (
        predictor_search_entropy)

    im = _alpha_image(45, 61, seed=4)
    monkeypatch.setenv("GOWEBP_TPU_VP8L_ANALYSIS", "1")
    cfg = T.EncoderConfig(lossless=True, exact=True, **kw)
    before = predictor_search_entropy.calls
    got = T.encode_rgba(im, config=cfg, device="cuda")
    assert predictor_search_entropy.calls > before
    assert got == T.encode_rgba(im, config=cfg, device="cpu")
    if not kw:
        assert np.array_equal(T.decode_rgba(got, device="cuda"), im)


def test_vp8l_predictor_from_many_threads(cuda):
    """The photo path calls the chooser from a thread pool: 8 threads x 4
    calls on the card give the plain version's modes, and the counters
    lose no update (a short switch interval)."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    from gowebp_tpu_torch.ops.kernels.vp8l_predictor import (
        predictor_search_entropy, predictor_search_entropy_plain)
    from gowebp_tpu_torch.utils.corpus import natural_image

    xs = [_argb_words(natural_image(160, 224, seed=s)).to(cuda)
          for s in range(4)]
    wants = [predictor_search_entropy_plain(x, 3, 2) for x in xs]
    before = (predictor_search_entropy.launches,
              predictor_search_entropy.calls)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(8) as ex:
            got = list(ex.map(lambda i: predictor_search_entropy(
                xs[i % 4], 3, 2), range(32)))
    finally:
        sys.setswitchinterval(old)
    for i, g in enumerate(got):
        assert torch.equal(g, wants[i % 4]), i
    solo = predictor_search_entropy.launches
    for x in xs:
        predictor_search_entropy(x, 3, 2)
    per_round = predictor_search_entropy.launches - solo
    assert predictor_search_entropy.calls - before[1] == 36
    assert solo - before[0] == 8 * per_round


def test_vp8l_predictor_stage1_table_is_uploaded_once(cuda):
    """Stage 1's table is uploaded at a device's first call and kept: more
    calls upload nothing, and it holds the kernel layout's integers."""
    from gowebp_tpu_torch.ops.kernels import vp8l_predictor as vpm

    x = _argb_words(_tie_images()["gradient"]).to(cuda)
    vpm.predictor_search_entropy(x, 4, 0)
    uploads = vpm.predictor_search_entropy.table_uploads
    assert 1 <= uploads <= torch.cuda.device_count()
    first = vpm.stage1_device_table(cuda)
    for bits in (3, 4, 5):
        vpm.predictor_search_entropy(x, bits, 2)
    assert vpm.predictor_search_entropy.table_uploads == uploads
    assert vpm.stage1_device_table(cuda) is first
    assert np.array_equal(first.cpu().numpy(), vpm.stage1_kernel_table())


def _packed(case, K, monkeypatch, dev):
    """``case`` packed by the port's native pack at a forced K, as device
    tensors."""
    from gowebp_tpu_torch.ops import coeff_pack

    monkeypatch.setattr(coeff_pack, "_choose_k", lambda *a: K)
    packed, k = coeff_pack.pack_coeffs(*case)
    assert k == K
    return {key: torch.from_numpy(a).to(dev) for key, a in packed.items()}


@pytest.mark.parametrize("K", [4, 8, 16])
@pytest.mark.parametrize("B,mb_h,mb_w", [(2, 3, 5), (1, 1, 5), (1, 5, 1),
                                         (1, 1, 1), (3, 7, 9)])
def test_unpack_coeffs_kernel_matches_plain(cuda, monkeypatch, K, B, mb_h,
                                            mb_w):
    """Tails, exceptions (levels past int8, non-exact divisions) and i16
    DC lanes: the kernel == the plain version == the dense input."""
    from gowebp_tpu_torch.ops.kernels.coeff_unpack import (
        unpack_coeffs, unpack_coeffs_plain)

    case = _chip_smoke().coeff_case(B * 100 + mb_h * 10 + mb_w, B, mb_h,
                                    mb_w)
    packed = _packed(case, K, monkeypatch, cuda)
    assert packed["exc_idx"].numel() > 0
    before = unpack_coeffs.launches
    got = unpack_coeffs(packed)
    torch.cuda.synchronize()
    assert unpack_coeffs.launches == before + 1
    want = unpack_coeffs_plain({k: t.cpu() for k, t in packed.items()})
    assert torch.equal(got.cpu(), want)
    assert np.array_equal(want.numpy(), case[0])


def test_unpack_coeffs_kernel_drops_padding_and_reads_unaligned_levels(
        cuda, monkeypatch):
    """Table rows padded with index nblocks (and -nblocks - 1) are
    skipped, as the reference's mode="drop"; a level buffer off its K
    alignment takes the kernel's byte loads."""
    from gowebp_tpu_torch.ops.kernels.coeff_unpack import (
        unpack_coeffs, unpack_coeffs_plain)

    case = _chip_smoke().coeff_case(7, 2, 4, 3)
    for K in (4, 8, 16):
        packed = _packed(case, K, monkeypatch, cuda)
        nblocks = 2 * 12 * 24
        for key, fill in (("tail", nblocks), ("exc", -nblocks - 1)):
            idx, val = packed[key + "_idx"], packed[key + "_val"]
            packed[key + "_idx"] = torch.cat(
                [idx, torch.full((5,), fill, dtype=idx.dtype, device=cuda)])
            packed[key + "_val"] = torch.cat(
                [val, torch.full((5,) + val.shape[1:], 9, dtype=val.dtype,
                                 device=cuda)])
        lv8 = packed["lv8"]
        raw = torch.empty(lv8.numel() + 1, dtype=torch.int8, device=cuda)
        raw[1:] = lv8.reshape(-1)
        packed["lv8"] = raw[1:].view(lv8.shape)
        got = unpack_coeffs(packed)
        want = unpack_coeffs_plain({k: t.cpu() for k, t in packed.items()})
        assert torch.equal(got.cpu(), want)
        assert np.array_equal(want.numpy(), case[0])


@pytest.mark.parametrize("K", [4, 8, 16])
@pytest.mark.parametrize("case", range(7))
def test_unpack_coeffs_kernel_table_cases(cuda, case, K):
    """Tables at the kernel's CTA edges (chip_smoke.UNPACK_CASES: no rows,
    every block tailed, rows on every range's first and last block, rows
    only on the batch's first and last blocks, a block with both, blocks
    not a multiple of a CTA's, one MB): the kernel == the plain version,
    one launch by the wrapper's count and by the library's."""
    from gowebp_tpu_torch.ops.kernels.coeff_unpack import (
        LIBRARY, unpack_coeffs, unpack_coeffs_plain)

    cs = _chip_smoke()
    kind, B, N = cs.UNPACK_CASES[case]
    packed = {k: torch.from_numpy(a).to(cuda)
              for k, a in cs.unpack_case(kind, K, B, N, case).items()}
    lib = LIBRARY.load()
    before = (unpack_coeffs.launches, lib.unpack_coeffs_kernel_launches())
    got = unpack_coeffs(packed)
    torch.cuda.synchronize()
    assert unpack_coeffs.launches == before[0] + 1
    assert lib.unpack_coeffs_kernel_launches() == before[1] + 1
    want = unpack_coeffs_plain({k: t.cpu() for k, t in packed.items()})
    assert torch.equal(got.cpu(), want)


_DISORDERED = r"""
import sys
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke
from gowebp_tpu_torch.ops.kernels.coeff_unpack import (in_block_order,
                                                       unpack_coeffs)
p = {k: torch.from_numpy(a) for k, a in
     chip_smoke.unpack_case("random", 4, 2, 37, 0).items()}
how, nb = sys.argv[2], 2 * 37 * 24
if how == "swapped":
    p["tail_idx"][[3, 4]] = p["tail_idx"][[4, 3]].clone()
elif how == "duplicate":
    p["exc_idx"][1] = p["exc_idx"][0]
else:                               # a valid row after a dropped one
    p["tail_idx"][-2] = nb
assert not in_block_order(p["exc_idx" if how == "duplicate" else "tail_idx"],
                          nb)
unpack_coeffs({k: t.cuda() for k, t in p.items()})
try:
    torch.cuda.synchronize()
except RuntimeError as e:
    print("trapped:", e)
else:
    print("silent")
"""


@pytest.mark.parametrize("how", ["swapped", "duplicate", "dropped_first"])
def test_unpack_coeffs_kernel_traps_on_tables_out_of_order(cuda, how):
    """A table out of block order stops the kernel: the next synchronize
    raises (in a process of its own: the trap ends its CUDA context)."""
    import subprocess
    import sys

    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", _DISORDERED, str(root), how],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("trapped:"), proc.stdout


def test_unpack_coeffs_rejects_bad_tensors(cuda, monkeypatch):
    from gowebp_tpu_torch.ops.kernels.coeff_unpack import unpack_coeffs

    packed = _packed(_chip_smoke().coeff_case(3, 1, 2, 2), 8, monkeypatch,
                     cuda)
    for key, bad in (("lv8", packed["lv8"].to(torch.int16)),
                     ("dc16", packed["dc16"][:, :1]),
                     ("tail_val", packed["tail_val"][:, :4]),
                     ("qmat", packed["qmat"].to(torch.int64)),
                     ("seg", packed["seg"].cpu())):
        with pytest.raises((TypeError, ValueError)):
            unpack_coeffs({**packed, key: bad})
    with pytest.raises(ValueError):
        unpack_coeffs({k: v for k, v in packed.items() if k != "exc_val"})


def test_batch_decode_launches_unpack_once_a_group(cuda):
    """The batch decode's device groups go through unpack_coeffs (one a
    group); the single-file decode uploads dense and launches none."""
    from gowebp_tpu_torch import decode, decode_rgba_batch
    from gowebp_tpu_torch.ops.kernels.coeff_unpack import unpack_coeffs

    datas = _mixed_files()
    before = unpack_coeffs.launches
    timings = {}
    got = decode_rgba_batch(datas, device="cuda", timings=timings)
    assert unpack_coeffs.launches == before + 4     # 2 sizes x ALPH or not
    assert timings["h2d_bytes"] > 0 and "unpack" in timings["stage_ms"]
    before = unpack_coeffs.launches
    for d, g in zip(datas, got):
        assert np.array_equal(decode(d, device="cuda"), g)
    assert unpack_coeffs.launches == before


def test_timed_device_out_decode_waits_for_the_card_once(cuda, monkeypatch):
    """With ``timings`` and the pixels left on the card, the batch decode
    runs the schedule it runs untimed: its stage clocks are resolved by
    one wait for the device as the call ends, not one a group."""
    from gowebp_tpu_torch import decode_rgba_batch
    from gowebp_tpu_torch.utils.corpus import natural_image

    datas = [_pillow(natural_image(32, 48, seed=s), quality=75)
             for s in range(40)]
    want = decode_rgba_batch(datas, device="cuda", threads=2)
    waits = []

    def counted(kind, fn):
        def wait(*a, **k):
            waits.append(kind)
            return fn(*a, **k)
        return wait

    monkeypatch.setattr(torch.cuda, "synchronize",
                        counted("device", torch.cuda.synchronize))
    monkeypatch.setattr(torch.cuda.Event, "synchronize",
                        counted("event", torch.cuda.Event.synchronize))
    monkeypatch.setattr(torch.cuda.Stream, "synchronize",
                        counted("stream", torch.cuda.Stream.synchronize))
    timings = {}
    got = decode_rgba_batch(datas, device="cuda", threads=2,
                            device_out=True, timings=timings)
    assert waits == ["device"]
    groups = [s for s in timings["spans"] if s.name == "decode.device"]
    assert len(groups) == 2 and timings["kernels.loads"] == 0
    assert set(timings["stage_ms"]) == {"h2d", "unpack", "recon",
                                        "yuv420_to_rgba"}
    for g, w in zip(got, want):
        assert g.is_cuda and np.array_equal(g.cpu().numpy(), w)


def test_incremental_decoder_gpu_equals_cpu(cuda):
    """IncrementalDecoder(device="cuda"): the same states, rows and
    partial outputs as device="cpu", chunk by chunk; each partial lossy
    call launches recon_filter_mb and yuv420_to_rgba once."""
    from gowebp_tpu_torch import IncrementalDecoder
    from gowebp_tpu_torch.ops.kernels.vp8_recon import recon_filter_mb
    from gowebp_tpu_torch.ops.kernels.yuv420_to_rgba import yuv420_to_rgba

    files = _single_files()
    for name in ("lossy", "alph", "vp8l"):
        data = files[name]
        a, b = IncrementalDecoder(device="cuda"), IncrementalDecoder(
            device="cpu")
        for i in range(0, len(data), 97):
            assert a.append(data[i:i + 97]) == b.append(data[i:i + 97])
            assert a.rows_decoded == b.rows_decoded
            if a.state != "done" and a.rows_decoded and name != "vp8l":
                before = (recon_filter_mb.launches, yuv420_to_rgba.launches)
                pa = a.get_partial_output()
                after = (recon_filter_mb.launches, yuv420_to_rgba.launches)
                assert [y - x for x, y in zip(before, after)] == [1, 1]
            else:
                pa = a.get_partial_output()
            pb = b.get_partial_output()
            assert (pa is None) == (pb is None)
            assert pa is None or np.array_equal(pa, pb)
        assert a.state == "done"
        assert np.array_equal(a.get_output(), b.get_output())


def test_picture_rescale_gpu_equals_cpu(cuda):
    from gowebp_tpu_torch import picture_rescale
    from gowebp_tpu_torch.utils.corpus import natural_image

    rgb = natural_image(45, 61, seed=4)
    rgba = np.dstack([rgb, _alpha_plane(45, 61)])
    for img in (rgb, rgba):
        for w, h in ((30, 0), (0, 90), (17, 13), (128, 96)):
            got = picture_rescale(img, w, h, device="cuda")
            want = picture_rescale(img, w, h, device="cpu")
            assert got.shape == want.shape and np.array_equal(got, want)


# ---------------------------------------------------------------------------
# The halo and stripe forms (parallel/) and the VP8L predictor inverse
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,h,w,quality", [
    (3, 64, 96, 75.0),
    (2, 16, 64, 99.0),       # one MB row
    (1, 64, 16, 40.0),       # one MB column
])
def test_encode_plane_halo_forms_match_plain(cuda, b, h, w, quality):
    """encode_luma/encode_chroma with a left halo column == their plain
    versions with it; one launch each, counted as halo launches."""
    from gowebp_tpu_torch.ops.kernels import encode_plane as ep

    g = torch.Generator().manual_seed(h * 7 + w)
    y = torch.randint(0, 256, (b, h, w), generator=g, dtype=torch.uint8)
    u, v = (torch.randint(0, 256, (b, h // 2, w // 2), generator=g,
                          dtype=torch.uint8) for _ in "uv")
    hy = torch.randint(0, 256, (b, h), generator=g, dtype=torch.uint8)
    hu, hv = (torch.randint(0, 256, (b, h // 2), generator=g,
                            dtype=torch.uint8) for _ in "uv")
    lq, y2q, cq = _plane_quants(quality)
    before = [(k.launches, k.halo_launches)
              for k in (ep.encode_luma, ep.encode_chroma)]
    got = (ep.encode_luma(y.to(cuda), lq, y2q, halo=hy.to(cuda))
           + ep.encode_chroma(u.to(cuda), v.to(cuda), cq,
                              halo=(hu.to(cuda), hv.to(cuda))))
    want = (ep.encode_luma_plain(y, lq, y2q, hy)
            + ep.encode_chroma_plain(u, v, cq, (hu, hv)))
    torch.cuda.synchronize()
    assert [(k.launches, k.halo_launches) for k in (
        ep.encode_luma, ep.encode_chroma)] == [(a + 1, c + 1)
                                               for a, c in before]
    for a, e in zip(got, want):
        assert a.dtype == e.dtype and torch.equal(a.cpu(), e)
    # without a halo the MB column 0 differs (the 129 fill)
    plain = ep.encode_luma(y.to(cuda), lq, y2q)
    assert not all(torch.equal(a, c) for a, c in zip(plain, got[:3]))


@pytest.mark.parametrize("try_i4", [True, False])
@pytest.mark.parametrize("derr", [False, True])
@pytest.mark.parametrize("B,mh,mw,cuts", [(2, 4, 6, (1, 3)), (1, 5, 1, (2,)),
                                          (3, 6, 5, (3,))])
def test_wavefront_search_stripe_form_matches_plain(cuda, try_i4, derr, B,
                                                    mh, mw, cuts):
    """Stripes run in turn through wavefront_search_stripe (the stripe
    form below the first) == the plain stripes, and together == one
    unsharded launch."""
    from gowebp_tpu_torch.ops.kernels.wavefront_search import (
        search_tables, wavefront_search, wavefront_search_stripe)

    y, u, v, seg, qs, pens = _search_case(cuda, mh * 10 + mw, B, 16 * mh,
                                          16 * mw)
    rate = search_tables(_tables(cuda))
    whole = wavefront_search(y, u, v, seg, qs, pens, rate, try_i4=try_i4,
                             use_derr=derr, want_recon=False)
    rows = (0, *cuts, mh)
    kernel, plain = [], []
    k_above = p_above = None
    before = wavefront_search.stripe_launches
    for a, b in zip(rows, rows[1:]):
        part = [t[:, s * a:s * b].contiguous() for t, s in (
            (y, 16), (u, 8), (v, 8), (seg, 1))]
        out, k_above = wavefront_search_stripe(
            *part, qs, pens, rate, try_i4=try_i4, use_derr=derr,
            above=k_above)
        kernel.append(out)
        out, p_above = wavefront_search_stripe(
            *(t.cpu() for t in part), qs.cpu(), pens.cpu(),
            tuple(t.cpu() for t in rate), try_i4=try_i4, use_derr=derr,
            above=p_above)
        plain.append(out)
        for e_k, e_p in zip(k_above, p_above):
            assert torch.equal(e_k.cpu(), e_p) or not derr and \
                e_k.dtype == torch.int16
    torch.cuda.synchronize()
    assert wavefront_search.stripe_launches == before + len(rows) - 2
    for k in whole:
        got = torch.cat([o[k] for o in kernel], 1)
        assert torch.equal(got, whole[k]), k
        assert torch.equal(got.cpu(), torch.cat([o[k] for o in plain], 1)), k


@pytest.mark.parametrize("filter_type", [0, 1, 2])
@pytest.mark.parametrize("B,mb_h,mb_w,cuts", [(2, 4, 5, (1, 3)),
                                              (1, 5, 1, (2, 3)),
                                              (3, 6, 4, (3,))])
def test_recon_filter_mb_stripe_form_matches_plain(cuda, filter_type, B,
                                                   mb_h, mb_w, cuts):
    """The decode's stripes in turn through the stripe form == the plain
    stripes (planes, edges, written-back rows), and with the write-backs
    applied == one unsharded launch."""
    from gowebp_tpu_torch.ops.kernels.vp8_recon import (
        recon_filter_mb, recon_filter_mb_stripe)

    coeffs, modes, fp = _recon_case(B * 13 + mb_h * 5 + mb_w, B, mb_h, mb_w)
    whole = recon_filter_mb(coeffs.to(cuda), modes.to(cuda), fp.to(cuda),
                            mb_w, mb_h, filter_type)
    rows = (0, *cuts, mb_h)
    k_above = p_above = None
    outs, backs = [], []
    before = recon_filter_mb.stripe_launches
    for a, b in zip(rows, rows[1:]):
        part = (coeffs[:, a * mb_w:b * mb_w].contiguous(),
                modes[:, a * mb_w:b * mb_w].contiguous(),
                fp[:, a:b].contiguous())
        k_planes, k_above, k_back = recon_filter_mb_stripe(
            *(t.to(cuda) for t in part), mb_w, b - a, filter_type, k_above)
        p_planes, p_above, p_back = recon_filter_mb_stripe(
            *part, mb_w, b - a, filter_type, p_above)
        for g, w in zip((*k_planes, *k_above, *(k_back or ())),
                        (*p_planes, *p_above, *(p_back or ()))):
            assert torch.equal(g.cpu(), w)
        outs.append([p.clone() for p in k_planes])
        backs.append(k_back)
    torch.cuda.synchronize()
    assert recon_filter_mb.stripe_launches == before + len(rows) - 1
    for i in range(1, len(outs)):
        for p in range(3):
            outs[i - 1][p][:, -3:] = backs[i][p]
    for p in range(3):
        assert torch.equal(torch.cat([o[p] for o in outs], 1), whole[p])


def _inverse_case(B, h, w, bits):
    rng = np.random.default_rng(h * 31 + w + bits)
    th, tw = -(-h // (1 << bits)), -(-w // (1 << bits))
    res = torch.from_numpy(rng.integers(0, 1 << 32, (B, h, w),
                                        dtype=np.uint32).view(np.int32))
    modes = torch.from_numpy(((rng.integers(0, 16, (th, tw), dtype=np.uint32)
                               << 8) | 0xFF000000).view(np.int32))
    return res, modes


@pytest.mark.parametrize("add_green", [False, True])
@pytest.mark.parametrize("B,h,w,bits", [
    (2, 9, 13, 2), (1, 1, 1, 3), (3, 1, 40, 4), (2, 33, 1, 5),
    (1, 1100, 7, 2),        # many row groups, scalar accesses
    (2, 64, 96, 4), (1, 2049, 3, 3),
    # heights off the 32 rows of a warp and the 128 of a CTA
    (1, 100, 40, 3), (2, 129, 64, 4), (1, 33, 16, 2), (1, 1030, 100, 4),
    # widths the 16-byte vectors do not fit
    (2, 70, 1, 2), (2, 70, 2, 2), (1, 70, 3, 3), (1, 70, 5, 2),
    # a tile a pixel, one tile
    (1, 40, 36, 0), (2, 300, 50, 16),
])
def test_vp8l_inverse_kernel_matches_plain(cuda, add_green, B, h, w, bits):
    from gowebp_tpu_torch.ops.kernels.vp8l_inverse import (
        predictor_inverse, predictor_inverse_plain)

    res, modes = _inverse_case(B, h, w, bits)
    before = predictor_inverse.launches
    got = predictor_inverse(res.to(cuda), modes.to(cuda), bits, add_green)
    torch.cuda.synchronize()
    assert predictor_inverse.launches == before + 1
    want = predictor_inverse_plain(res, modes, bits, add_green)
    assert torch.equal(got.cpu(), want)


def test_vp8l_inverse_more_ctas_than_the_card_holds(cuda):
    """B=512 at 2048x8: 8,192 CTAs of 4 warps, far more than are resident
    at once; a CTA waiting on one not yet started would hang here."""
    from gowebp_tpu_torch.ops.kernels.vp8l_inverse import (
        predictor_inverse, predictor_inverse_plain)

    res, modes = _inverse_case(512, 2048, 8, 2)
    before = predictor_inverse.launches
    got = predictor_inverse(res.to(cuda), modes.to(cuda), 2, True)
    torch.cuda.synchronize()
    assert predictor_inverse.launches == before + 1
    assert torch.equal(got.cpu(), predictor_inverse_plain(res, modes, 2, True))


def test_vp8l_inverse_misaligned_and_warps_a_cta(cuda):
    """A view 4 bytes past an aligned address (w % 4 == 0: the scalar
    accesses), and 1, 2, 4 and 8 warps a CTA, equal the plain version."""
    from gowebp_tpu_torch.ops.kernels import vp8l_inverse as vim

    B, h, w, bits = 2, 200, 64, 3
    res, modes = _inverse_case(B, h, w, bits)
    want = vim.predictor_inverse_plain(res, modes, bits, True)
    flat = torch.zeros(B * h * w + 1, dtype=torch.int32, device=cuda)
    view = flat[1:].view(B, h, w)
    view.copy_(res.to(cuda))
    assert view.data_ptr() % 16 == 4
    got = vim.predictor_inverse(view, modes.to(cuda), bits, True)
    assert torch.equal(got.cpu(), want)
    for warps in (1, 2, 4, 8):
        got = vim.launch(res.to(cuda), modes.to(cuda), bits, True, warps)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), warps
    with pytest.raises(RuntimeError):
        vim.launch(res.to(cuda), modes.to(cuda), bits, True, 9)


def test_vp8l_inverse_rejects_bad_tensors(cuda):
    from gowebp_tpu_torch.ops.kernels.vp8l_inverse import predictor_inverse

    res = torch.zeros((1, 8, 8), dtype=torch.int32, device=cuda)
    modes = torch.zeros((2, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        predictor_inverse(res.to(torch.int64), modes, 2)
    with pytest.raises(ValueError):
        predictor_inverse(res, modes.cpu(), 2)
    with pytest.raises(ValueError):
        predictor_inverse(res, modes[:1], 2)


def test_parallel_kernels_ptxas_have_no_stack_or_spills(cuda, tmp_path):
    """vp8l_inverse.cu and the halo and stripe forms of encode_plane.cu and
    vp8_recon.cu compile to no stack frame and no spills."""
    import subprocess

    from gowebp_tpu_torch.ops.kernels import encode_plane, vp8_recon
    from gowebp_tpu_torch.ops.kernels import vp8l_inverse
    from gowebp_tpu_torch.ops.kernels.cuda_build import NVCC_FLAGS, nvcc

    smoke = _chip_smoke()
    for lib, kernel, n in ((vp8l_inverse.LIBRARY, "vp8l_inverse_kernel", 1),
                           (encode_plane.LIBRARY, "encode_", 6),
                           (vp8_recon.LIBRARY, "recon_filter_mb_kernel", 2)):
        out = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp_path / "lib.so"),
             str(lib.source)], capture_output=True, text=True)
        assert out.returncode == 0, out.stdout + out.stderr
        report = smoke.ptxas_report(out.stdout + out.stderr, kernel)
        assert len(report) == n, report
        assert all(r[2:] == (0, 0, 0) for r in report), report


def test_sharded_steps_in_a_two_rank_job_on_one_card(cuda, tmp_path):
    """chip_smoke.py's two-rank gloo job on cuda:0 (halos staged through
    host memory), at a small size: every step's full tensors equal the
    unsharded calls'."""
    smoke = _chip_smoke()
    inputs = smoke.parallel_inputs(cuda, small=True)
    want = smoke.parallel_digests(smoke.unsharded_results(inputs))
    got = smoke.run_parallel_job(inputs, 2, tmp_path)
    assert got["digests"] == want
    assert got["staged_bytes"] > 0


_BATCH_SYMBOLS = r"""
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np
from gowebp_tpu_torch.constants import CHUNK_VP8
from gowebp_tpu_torch.container.riff import parse_riff
from gowebp_tpu_torch.models.vp8 import decoder as dec

payload = parse_riff(open(sys.argv[2], "rb").read()).find(CHUNK_VP8).payload
st, coeffs, modes = dec.decode_vp8_symbols(payload)
((_, bc, bm),) = dec.decode_vp8_symbols_batch([payload])
print("EQUAL", np.array_equal(bc, coeffs), np.array_equal(bm, modes),
      len(st.partition_bytes[0]), dec.symbol_engine(), flush=True)
"""


def test_batch_symbols_of_the_hybrid_4096_file(cuda, tmp_path):
    """The hybrid engine's q75 file of a 4096x4096 mosaic of corpus
    images: one token partition of some 1.6 MB, which the batch symbol
    decoder reads with one lane while 31 sit parked (it ended the process
    there until parked lanes stopped refilling).  In a subprocess, so
    that a crash fails the test: the batch decode equals the
    single-stream decode."""
    import subprocess
    import sys

    from gowebp_tpu_torch import encode_rgba_batch
    from gowebp_tpu_torch.utils.corpus import natural_images

    big = _chip_smoke().mosaic(list(natural_images(16, 1024, 1024, seed=7)),
                               4)
    path = tmp_path / "hybrid4096.webp"
    path.write_bytes(encode_rgba_batch([big], quality=75.0,
                                       device="cuda")[0])
    root = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", _BATCH_SYMBOLS, str(root),
                          str(path)], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    equal, part = out.stdout.split()[1:3], int(out.stdout.split()[3])
    assert equal == ["True", "True"], out.stdout
    assert part > 1 << 20, part
