"""The port's parallel/ package against the JAX package's, on the CPU.

The five ``gowebp_tpu_torch.parallel.shard`` steps run once in an 8-rank
gloo job of worker processes (spawned once for this module; they import
neither JAX nor gowebp_tpu and hand their results back through files),
on the JAX tests' inputs, sizes and meshes (tests/test_jax_ops.py
TestShardedEquivalence, tests/test_sharded_pipelines.py): data 2 x tile 4,
and data 4 x tile 2 for the lossless inverse.  Each full tensor must equal
the JAX package's sharded result on its 8-device CPU mesh bit for bit.

In process, with no process group, the stripe and halo forms of the
kernels' plain versions are fed halos by hand and must equal the
unsharded port: the plane kernels' halo forms against the JAX plane
context with a halo, the exact wavefront's and the decode recon's stripes
(2-4 stripes, odd MB grids, error diffusion on and off, filter types 0-2,
skip MBs) against one unsharded call.  A two-process
``initialize``/``global_mesh`` job mirrors test_distributed_two_process_smoke.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gowebp_tpu.config import EncoderConfig
from gowebp_tpu.constants import CHUNK_VP8
from gowebp_tpu.container.riff import parse_riff
from gowebp_tpu.encode import encode_rgba
from gowebp_tpu.parallel.mesh import make_mesh as jax_mesh

REPO = Path(__file__).resolve().parent.parent
QUANTS = dict(y1_dc=20, y1_ac=25, y2_dc=40, y2_ac=38, uv_dc=20, uv_ac=25)
WORKERS = 8
TIMEOUT_S = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _symbols(img, quality, method=None):
    """A JAX-encoded lossy file's decode symbols: (state, coeffs, modes,
    filter params)."""
    from gowebp_tpu.models.vp8.decoder import (decode_vp8_symbols,
                                               vp8_filter_params)

    kw = {} if method is None else dict(method=method)
    data = encode_rgba(img, config=EncoderConfig(lossless=False,
                                                 quality=quality, **kw))
    st, coeffs, modes = decode_vp8_symbols(parse_riff(data).find(
        CHUNK_VP8).payload)
    return st, coeffs, modes, vp8_filter_params(st, modes)


def _recon_args(B, st, coeffs, modes, fps):
    cb = np.broadcast_to(coeffs, (B,) + coeffs.shape).copy()
    mb = np.broadcast_to(modes, (B,) + modes.shape).copy()
    fb = np.broadcast_to(fps, (B,) + fps.shape).copy()
    return dict(coeffs=cb, is_i4=mb[:, :, 0].astype(np.int32),
                imodes=mb[:, :, 5:21].astype(np.int32),
                uvmode=mb[:, :, 1].astype(np.int32), fparams=fb,
                mb_w=np.int64(st.mb_w), mb_h=np.int64(st.mb_h),
                filter_type=np.int64(st.filter_type))


def _inputs() -> dict:
    """Every case's inputs, built as the JAX tests build theirs."""
    from gowebp_tpu.models.vp8.encoder import (_default_cost_tables,
                                               _i4_config_seg, make_quants,
                                               quality_to_q)

    cases = {}
    rng = np.random.default_rng(42)
    B, H, W = 2, 32, 32 * 4
    cases["plane"] = dict(
        y=rng.integers(0, 256, (B, H, W)).astype(np.int32),
        u=rng.integers(0, 256, (B, H // 2, W // 2)).astype(np.int32),
        v=rng.integers(0, 256, (B, H // 2, W // 2)).astype(np.int32))

    rng = np.random.default_rng(11)
    h = w = 64
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([
        np.clip(120 + 60 * np.sin(xx / 7) + rng.integers(-8, 9, (h, w)),
                0, 255),
        np.clip(100 + 70 * np.cos(yy / 9), 0, 255),
        (xx * 3 + yy * 2) % 256,
    ], -1).astype(np.uint8)
    cases["recon_step"] = _recon_args(8, *_symbols(img, 80.0, method=4))

    rng = np.random.default_rng(3)
    B, h, w, bits = 8, 24, 40, 4
    th, tw = (h + (1 << bits) - 1) >> bits, (w + (1 << bits) - 1) >> bits
    cases["lossless"] = dict(
        residuals=rng.integers(0, 1 << 32, (B, h, w), dtype=np.uint32),
        mode_img=(0xFF000000 | (rng.integers(0, 14, (th, tw),
                                             dtype=np.uint32) << 8)),
        bits=np.int64(bits))

    rng = np.random.default_rng(21)
    B, H, W = 2, 128, 80          # mb_h = 8 rows over 4 row shards
    q = make_quants(quality_to_q(75.0))
    row = np.array([q.y1_dc.q, q.y1_ac.q, q.y2_dc.q, q.y2_ac.q,
                    q.uv_dc.q, q.uv_ac.q], np.int32)
    qs = np.broadcast_to(row, (B, 4, 6)).copy()
    wf = dict(
        y=rng.integers(0, 256, (B, H, W)).astype(np.int32),
        u=rng.integers(0, 256, (B, H // 2, W // 2)).astype(np.int32),
        v=rng.integers(0, 256, (B, H // 2, W // 2)).astype(np.int32),
        qsteps=qs)
    wf["seg_map"] = rng.integers(0, 4, (B, H // 16, W // 16)).astype(
        np.int32)
    _, pens = _i4_config_seg(qs[0], 4, 0)
    wf["i4_penalty"] = np.broadcast_to(pens, (B, 4)).astype(np.int32).copy()
    for i, t in enumerate(_default_cost_tables()):
        wf[f"table{i}"] = t.astype(np.int32)
    cases["wavefront"] = wf

    rng = np.random.default_rng(31)
    img = rng.integers(0, 256, (128, 80, 3), dtype=np.uint8)
    rf = _recon_args(2, *_symbols(img, 60.0))
    assert int(rf["filter_type"]) == 2       # every halo of the filter
    cases["recon_frame"] = rf
    return cases


# The 8-rank job.  Each rank runs every step; rank 0 writes the full
# tensors to OUT/<case>.npz; every rank writes the messages of the
# errors it was meant to raise to OUT/errors<rank>.txt.
WORKER = r"""
import os, sys
import numpy as np
sys.path.insert(0, os.environ["REPO"])
import torch
torch.set_num_threads(1)
from gowebp_tpu_torch.parallel import distributed, shard
from gowebp_tpu_torch.parallel.mesh import batch_sharding, make_mesh

rank = int(sys.argv[1])
inp, out = sys.argv[2], sys.argv[3]
distributed.initialize(os.environ["COORD"], 8, rank, device="cpu")
assert "jax" not in sys.modules and "gowebp_tpu" not in sys.modules


def load(name):
    with np.load(os.path.join(inp, name + ".npz")) as z:
        return {k: z[k] for k in z.files}


def save(name, arrays):
    full = {k: shard.full_tensor(v).numpy() for k, v in arrays.items()}
    if rank == 0:
        np.savez(os.path.join(out, name + ".npz"), **full)


errors = []


def expect_error(fn):
    try:
        fn()
    except ValueError as e:
        errors.append(str(e))
    else:
        errors.append("no error")


mesh = make_mesh(8, data=2, tile=4, device="cpu")
a = load("plane")
q = dict(y1_dc=20, y1_ac=25, y2_dc=40, y2_ac=38, uv_dc=20, uv_ac=25)
save("plane", shard.sharded_encode_plane_step(mesh, a["y"], a["u"], a["v"],
                                              quants=q))
# the same inputs as DTensors already placed
placed = [shard._dtensor(shard._local(k, a[k], mesh, batch_sharding(mesh),
                                      torch.device("cpu")), mesh,
                         batch_sharding(mesh)) for k in ("y", "u", "v")]
save("plane_dtensor", shard.sharded_encode_plane_step(mesh, *placed,
                                                      quants=q))

a = load("recon_step")
kw = {k: int(a.pop(k)) for k in ("mb_w", "mb_h", "filter_type")}
save("recon_step", dict(zip("YUV", shard.sharded_recon_step(
    mesh, a["coeffs"], a["is_i4"], a["imodes"], a["uvmode"], a["fparams"],
    **kw))))

a = load("lossless")
save("lossless", {"out": shard.sharded_lossless_inverse(
    make_mesh(8, data=4, tile=2, device="cpu"), a["residuals"],
    a["mode_img"], bits=int(a["bits"]))})

a = load("wavefront")
tables = tuple(a.pop(f"table{i}") for i in range(3))
save("wavefront", shard.sharded_wavefront_encode(
    mesh, a["y"], a["u"], a["v"], a["seg_map"], a["qsteps"], tables,
    try_i4=True, i4_penalty=a["i4_penalty"], use_derr=True))
save("wavefront_i16", shard.sharded_wavefront_encode(
    mesh, a["y"], a["u"], a["v"], a["seg_map"], a["qsteps"], tables,
    try_i4=False, use_derr=False))
expect_error(lambda: shard.sharded_wavefront_encode(
    mesh, a["y"][:, :48], a["u"][:, :24], a["v"][:, :24],
    a["seg_map"][:, :3], a["qsteps"], tables, try_i4=False))

a = load("recon_frame")
kw = {k: int(a.pop(k)) for k in ("mb_w", "mb_h", "filter_type")}
save("recon_frame", dict(zip("YUV", shard.sharded_recon_frame(
    mesh, a["coeffs"], a["is_i4"], a["imodes"], a["uvmode"], a["fparams"],
    **kw))))
expect_error(lambda: shard.sharded_recon_frame(
    mesh, a["coeffs"], a["is_i4"], a["imodes"], a["uvmode"], a["fparams"],
    mb_w=kw["mb_w"], mb_h=kw["mb_h"] + 1, filter_type=2))
expect_error(lambda: shard.sharded_lossless_inverse(
    mesh, np.zeros((3, 4, 4), np.uint32), np.zeros((1, 1), np.uint32),
    bits=4))
expect_error(lambda: make_mesh(4, device="cpu"))
expect_error(lambda: make_mesh(data=3, device="cpu"))
with open(os.path.join(out, f"errors{rank}.txt"), "w") as f:
    f.write("\n".join(errors))
print("WORKER_OK", rank, flush=True)
"""


def _run_job(script: str, args_of, n: int, tmp: Path) -> list:
    """Run ``script`` in ``n`` processes (argv[1] the rank, then
    ``args_of``), each with COORD and REPO set; returns their outputs."""
    path = tmp / "worker.py"
    path.write_text(script)
    env = dict(os.environ, COORD=f"127.0.0.1:{_free_port()}", REPO=str(REPO),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, str(path), str(r),
                               *args_of],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env, text=True)
             for r in range(n)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT_S)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} rc={p.returncode}:\n{out}"
    return outs


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """(inputs, the 8-rank job's results by case, its error messages)."""
    tmp = tmp_path_factory.mktemp("parallel")
    inp, out = tmp / "in", tmp / "out"
    inp.mkdir()
    out.mkdir()
    cases = _inputs()
    for name, arrays in cases.items():
        np.savez(inp / f"{name}.npz", **arrays)
    outs = _run_job(WORKER, [str(inp), str(out)], WORKERS, tmp)
    for r, o in enumerate(outs):
        assert f"WORKER_OK {r}" in o, o
    results = {}
    for f in out.glob("*.npz"):
        with np.load(f) as z:
            results[f.stem] = {k: z[k] for k in z.files}
    errors = [(out / f"errors{r}.txt").read_text().split("\n")
              for r in range(WORKERS)]
    return cases, results, errors


def _equal(want: dict, got: dict) -> None:
    assert set(want) == set(got)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def _jax_plane(a):
    from gowebp_tpu.parallel.shard import sharded_encode_plane_step

    mesh = jax_mesh(8, data=2, tile=4)
    return sharded_encode_plane_step(mesh, a["y"], a["u"], a["v"],
                                     quants=QUANTS)


@pytest.mark.parametrize("case", ["plane", "plane_dtensor"])
def test_sharded_encode_plane_step_matches_jax(job, case):
    cases, results, _ = job
    _equal(_jax_plane(cases["plane"]), results[case])


def test_sharded_encode_plane_step_matches_unsharded_port(job):
    """The halo forms give the unsharded plane encode's outputs."""
    from gowebp_tpu_torch.ops.encode_plane import encode_plane_core_v2

    cases, results, _ = job
    a = cases["plane"]
    want = encode_plane_core_v2(*(torch.from_numpy(a[k]) for k in "yuv"),
                                **QUANTS)
    _equal({k: v.numpy() for k, v in want.items()}, results["plane"])


def test_sharded_recon_step_matches_jax(job):
    from gowebp_tpu.parallel.shard import sharded_recon_step

    cases, results, _ = job
    a = dict(cases["recon_step"])
    kw = {k: int(a.pop(k)) for k in ("mb_w", "mb_h", "filter_type")}
    want = sharded_recon_step(jax_mesh(8, data=2, tile=4), a["coeffs"],
                              a["is_i4"], a["imodes"], a["uvmode"],
                              a["fparams"], **kw)
    _equal(dict(zip("YUV", want)), results["recon_step"])


def test_sharded_lossless_inverse_matches_jax(job):
    from gowebp_tpu.parallel.shard import sharded_lossless_inverse

    cases, results, _ = job
    a = cases["lossless"]
    want = np.asarray(sharded_lossless_inverse(
        jax_mesh(8, data=4, tile=2), a["residuals"], a["mode_img"],
        bits=int(a["bits"])))
    got = results["lossless"]["out"].view(np.uint32)
    np.testing.assert_array_equal(got, want)


def _jax_wavefront(a, try_i4, use_derr):
    from gowebp_tpu.parallel.shard import sharded_wavefront_encode

    tables = tuple(jnp.asarray(a[f"table{i}"]) for i in range(3))
    kw = dict(try_i4=True, i4_penalty=a["i4_penalty"]) if try_i4 else dict(
        try_i4=False)
    return sharded_wavefront_encode(
        jax_mesh(8, data=2, tile=4), a["y"], a["u"], a["v"], a["seg_map"],
        a["qsteps"], tables, use_derr=use_derr, **kw)


@pytest.mark.parametrize("case,try_i4,use_derr",
                         [("wavefront", True, True),
                          ("wavefront_i16", False, False)])
def test_sharded_wavefront_encode_matches_jax(job, case, try_i4, use_derr):
    cases, results, _ = job
    _equal(_jax_wavefront(cases["wavefront"], try_i4, use_derr),
           results[case])


def test_sharded_recon_frame_matches_jax(job):
    from gowebp_tpu.parallel.shard import sharded_recon_frame

    cases, results, _ = job
    a = dict(cases["recon_frame"])
    kw = {k: int(a.pop(k)) for k in ("mb_w", "mb_h", "filter_type")}
    want = sharded_recon_frame(jax_mesh(8, data=2, tile=4), a["coeffs"],
                               a["is_i4"], a["imodes"], a["uvmode"],
                               a["fparams"], **kw)
    _equal(dict(zip("YUV", want)), results["recon_frame"])


def test_sharded_steps_raise_where_the_reference_needs_divisibility(job):
    """Every rank raises ValueError, with the reference's message where
    it has one: MB rows over the tile axis, a batch over the mesh, a mesh
    over fewer ranks than the job's, a split that is not the job's."""
    _, _, errors = job
    for msgs in errors:
        assert msgs[0] == "mb_h=3 not divisible by tile axis 4"
        assert msgs[1] == "mb_h=9 not divisible by tile axis 4"
        assert "not divisible" in msgs[2]
        assert "every rank" in msgs[3]
        assert msgs[4] == "mesh 3x2 != 8 devices"
    assert all(m == errors[0] for m in errors)


DIST_WORKER = r"""
import os, sys
sys.path.insert(0, os.environ["REPO"])
import torch
import torch.distributed as dist
from gowebp_tpu_torch.parallel import distributed

pid = int(sys.argv[1])
distributed.initialize(coordinator_address=os.environ["COORD"],
                       num_processes=2, process_id=pid, device="cpu")
distributed.initialize()          # once a process: a second call returns
assert dist.get_world_size() == 2, dist.get_world_size()
mesh = distributed.global_mesh()
assert mesh.mesh.numel() == dist.get_world_size()
assert mesh.mesh_dim_names == ("data", "tile")
# a real cross-process collective over the global mesh
t = torch.full((1,), pid + 1, dtype=torch.int32)
dist.all_reduce(t)
assert int(t) == 3, int(t)
assert "jax" not in sys.modules and "gowebp_tpu" not in sys.modules
print("DIST_OK", pid, flush=True)
"""


def test_distributed_two_process_smoke(tmp_path):
    """parallel/distributed.py in a real 2-process gloo job: init (once),
    the global mesh over both ranks, and a cross-process all-reduce."""
    outs = _run_job(DIST_WORKER, [], 2, tmp_path)
    for i, out in enumerate(outs):
        assert f"DIST_OK {i}" in out, out


REJOIN_WORKER = r"""
import os, sys
sys.path.insert(0, os.environ["REPO"])
import torch
import torch.distributed as dist
from gowebp_tpu_torch.parallel import distributed
from gowebp_tpu_torch.parallel.mesh import make_mesh

for _ in range(2):
    distributed.initialize(device="cpu")
    assert dist.is_initialized() and dist.get_world_size() == 1
    assert make_mesh(device="cpu").mesh.numel() == 1
    assert distributed.global_mesh().mesh_dim_names == ("data", "tile")
    dist.destroy_process_group()
try:
    distributed.global_mesh()
    raise SystemExit("global_mesh after destroy_process_group returned")
except RuntimeError as e:
    assert "initialize" in str(e), e
print("REJOIN_OK", flush=True)
"""


def test_initialize_joins_again_after_the_group_is_destroyed(tmp_path):
    """A one-process job: initialize() with no coordinator, a working
    make_mesh() and global_mesh(); after destroy_process_group a second
    initialize() joins a new group (global_mesh raises until then)."""
    (out,) = _run_job(REJOIN_WORKER, [], 1, tmp_path)
    assert "REJOIN_OK" in out, out


# ---------------------------------------------------------------------------
# In process: the halo and stripe forms' plain versions, halos by hand
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mh,mw,tiles", [(2, 8, 4), (1, 5, 5), (3, 6, 2),
                                         (5, 3, 3), (2, 4, 2)])
def test_plane_tiles_with_halos_equal_the_whole_plane(mh, mw, tiles):
    """Width tiles encoded by the halo forms (each fed its left
    neighbour's last columns) give the unsharded plane encode."""
    from gowebp_tpu_torch.ops.encode_plane import encode_plane_core_v2

    rng = np.random.default_rng(mh * 100 + mw)
    B = 2
    y = torch.from_numpy(rng.integers(0, 256, (B, 16 * mh, 16 * mw),
                                      dtype=np.uint8))
    u, v = (torch.from_numpy(rng.integers(0, 256, (B, 8 * mh, 8 * mw),
                                          dtype=np.uint8)) for _ in "uv")
    want = encode_plane_core_v2(y, u, v, **QUANTS)
    cols = np.linspace(0, mw, tiles + 1).astype(int)
    parts = []
    for t, (a, b) in enumerate(zip(cols, cols[1:])):
        halo = {}
        if t:
            halo = dict(y_halo=y[:, :, 16 * a - 1], u_halo=u[:, :, 8 * a - 1],
                        v_halo=v[:, :, 8 * a - 1])
        parts.append(encode_plane_core_v2(
            y[:, :, 16 * a:16 * b], u[:, :, 8 * a:8 * b],
            v[:, :, 8 * a:8 * b], **QUANTS, **halo, leftmost=t == 0))
    for k in want:
        assert torch.equal(torch.cat([p[k] for p in parts], 2), want[k]), k


@pytest.mark.parametrize("leftmost", [False, True])
@pytest.mark.parametrize("mh,mw", [(1, 5), (5, 1), (3, 5)])
def test_plane_halo_forms_match_the_jax_halo_context(mh, mw, leftmost):
    """encode_plane_core_v2 with a halo == the JAX package's, whose
    _plane_context takes the halo at MB column 0 unless leftmost."""
    from gowebp_tpu.ops.encode_plane_jax import encode_plane_core_v2 as ref

    from gowebp_tpu_torch.ops.encode_plane import encode_plane_core_v2

    rng = np.random.default_rng(mh * 7 + mw + leftmost)
    B, H, W = 2, 16 * mh, 16 * mw
    planes = [rng.integers(0, 256, s).astype(np.int32)
              for s in ((B, H, W), (B, H // 2, W // 2), (B, H // 2, W // 2))]
    halos = [rng.integers(0, 256, (B, s)).astype(np.int32)
             for s in (H, H // 2, H // 2)]
    names = ("y_halo", "u_halo", "v_halo")
    want = ref(*(jnp.asarray(p) for p in planes),
               **{n: jnp.asarray(h) for n, h in zip(names, halos)},
               leftmost=jnp.asarray(leftmost), **QUANTS)
    got = encode_plane_core_v2(
        *(torch.from_numpy(p) for p in planes),
        **{n: torch.from_numpy(h) for n, h in zip(names, halos)},
        leftmost=leftmost, **QUANTS)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def _wavefront_case(seed, B, mh, mw):
    from gowebp_tpu_torch.models.vp8.encoder import (_default_cost_tables,
                                                     _i4_config_seg,
                                                     make_quants,
                                                     quality_to_q)
    from gowebp_tpu_torch.ops.kernels.wavefront_search import search_tables

    rng = np.random.default_rng(seed)
    H, W = 16 * mh, 16 * mw
    y, u, v = (torch.from_numpy(rng.integers(0, 256, s, dtype=np.uint8))
               for s in ((B, H, W), (B, H // 2, W // 2), (B, H // 2, W // 2)))
    q = make_quants(quality_to_q(75.0))
    row = np.array([q.y1_dc.q, q.y1_ac.q, q.y2_dc.q, q.y2_ac.q, q.uv_dc.q,
                    q.uv_ac.q], np.int32)
    qs = torch.from_numpy(np.broadcast_to(row, (B, 4, 6)).copy())
    seg = torch.from_numpy(rng.integers(0, 4, (B, mh, mw)).astype(np.int32))
    _, pens = _i4_config_seg(qs[0].numpy(), 4, 0)
    pens = torch.from_numpy(np.broadcast_to(pens, (B, 4)).astype(
        np.int32).copy())
    tables = tuple(torch.from_numpy(t.astype(np.int32))
                   for t in _default_cost_tables())
    return y, u, v, seg, qs, pens, search_tables(tables)


@pytest.mark.parametrize("use_derr", [False, True])
@pytest.mark.parametrize("try_i4", [False, True])
@pytest.mark.parametrize("mh,mw,cuts", [(3, 5, (1, 2)), (5, 1, (2, 3, 4)),
                                        (4, 3, (2,)), (1, 5, ())])
def test_wavefront_stripes_equal_the_whole_frame(mh, mw, cuts, try_i4,
                                                 use_derr):
    """MB-row stripes run in turn by wavefront_search_stripe, each fed
    the stripe above's edge, give the unsharded engine's outputs."""
    from gowebp_tpu_torch.ops.kernels.wavefront_search import (
        wavefront_search_plain, wavefront_search_stripe)

    y, u, v, seg, qs, pens, rate = _wavefront_case(mh * 10 + mw, 2, mh, mw)
    want = wavefront_search_plain(y, u, v, seg, qs, pens, rate,
                                  try_i4=try_i4, use_derr=use_derr,
                                  want_recon=True)
    rows = (0, *cuts, mh)
    above, parts = None, []
    for a, b in zip(rows, rows[1:]):
        out, above = wavefront_search_stripe(
            y[:, 16 * a:16 * b].contiguous(), u[:, 8 * a:8 * b].contiguous(),
            v[:, 8 * a:8 * b].contiguous(), seg[:, a:b].contiguous(), qs,
            pens, rate, try_i4=try_i4, use_derr=use_derr, above=above)
        parts.append(out)
        # the edge: the stripe's last recon rows
        assert torch.equal(above[0], want["recon_y"][:, 16 * b - 1])
        assert torch.equal(above[1], want["recon_u"][:, 8 * b - 1])
    for k in ("ymode", "uvmode", "is_i4", "imodes", "y_levels", "y2_levels",
              "uv_levels"):
        assert torch.equal(torch.cat([p[k] for p in parts], 1), want[k]), k


def _recon_stripes(c, m, f, mw, rows, ft):
    from gowebp_tpu_torch.ops.kernels.vp8_recon import recon_filter_mb_stripe

    above, outs, backs = None, [], []
    for a, b in zip(rows, rows[1:]):
        planes, above, back = recon_filter_mb_stripe(
            c[:, a * mw:b * mw].contiguous(), m[:, a * mw:b * mw].contiguous(),
            f[:, a:b].contiguous(), mw, b - a, ft, above)
        outs.append([p.clone() for p in planes])
        backs.append(back)
    for i in range(1, len(outs)):
        for p in range(3):
            outs[i - 1][p][:, -3:] = backs[i][p]
    return [torch.cat([o[p] for o in outs], 1) for p in range(3)]


@pytest.mark.parametrize("ft", [0, 1, 2])
@pytest.mark.parametrize("mh,mw,cuts", [(3, 5, (1, 2)), (5, 1, (2, 3, 4)),
                                        (4, 3, (2,)), (6, 4, (1, 3, 5)),
                                        (1, 5, ())])
def test_recon_stripes_equal_the_whole_frame(mh, mw, cuts, ft):
    """The decode's MB-row stripes in turn, each fed the stripe above's
    edge, with the 3 rows each top-edge filter changed written back up,
    give the unsharded recon and filter (random i4/i16 mixes, skip MBs,
    a segment with its filter off)."""
    import chip_smoke
    from gowebp_tpu_torch.ops.kernels.vp8_recon import recon_filter_mb_plain

    c, m, f = chip_smoke.random_symbols(torch.device("cpu"), mh * 10 + mw,
                                        2, mh, mw)
    want = recon_filter_mb_plain(c, m, f, mw, mh, ft)
    got = _recon_stripes(c, m, f, mw, (0, *cuts, mh), ft)
    for p in range(3):
        assert torch.equal(got[p], want[p]), "YUV"[p]


@pytest.mark.parametrize("tiles", [2, 4])
def test_recon_stripes_of_a_jax_file_equal_its_jax_recon(job, tiles):
    """A JAX-encoded file's symbols (complex filter) in 2 or 4 stripes
    == the JAX package's unsharded recon_frame."""
    from gowebp_tpu.ops.vp8_recon_jax import recon_frame

    from gowebp_tpu_torch.ops.kernels.vp8_recon import pack_modes

    cases, _, _ = job
    a = cases["recon_frame"]
    mw, mh, ft = (int(a[k]) for k in ("mb_w", "mb_h", "filter_type"))
    want = recon_frame(a["coeffs"], a["is_i4"], a["imodes"], a["uvmode"],
                       a["fparams"], mb_w=mw, mb_h=mh, filter_type=ft)
    t = torch.from_numpy
    modes = pack_modes(t(a["is_i4"]), t(a["imodes"]), t(a["uvmode"]))
    rows = np.linspace(0, mh, tiles + 1).astype(int)
    got = _recon_stripes(t(a["coeffs"]), modes, t(a["fparams"]), mw,
                         tuple(rows), ft)
    for w, g, name in zip(want, got, "YUV"):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
