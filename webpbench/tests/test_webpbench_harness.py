"""The harness: files found by name, BENCHMARK.json in step with them, the
result line, the kernel counts, the refusal without a card and the import
boundary."""

import ast
import io
import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from webpbench import bench, checks, generator, run
from webpbench.tests.conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
SMALL_CFG = {"image": {"height": 48, "width": 80, "channels": 3}}
SMALL_TR = {"pool": 2, "batch": 4}


def test_every_file_loads_by_name():
    for kind in ("configs", "traffic", "workloads"):
        for name in bench.names(kind, ".json"):
            assert bench.load_json(kind, name)["name"] == name
    for kind in ("metrics", "roofline"):
        for name in bench.names(kind, ".py"):
            bench.load_module(kind, name)
    for m in bench.metric_modules():
        assert bench.NAME_RE.match(m.NAME)


def test_benchmark_json_matches_the_files():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for c in BENCH["configs"]:
        f = bench.load_json("configs", c["name"])
        assert c["file"] == f"webpbench/configs/{c['name']}.json"
        assert c["source"] == f["source"] and c["reduced"] == f["reduced"]
    for w in BENCH["workloads"]:
        f = bench.load_json("workloads", w["name"])
        assert {k: f[k] for k in w} == w
    mods = {m.NAME: m for m in bench.metric_modules()}
    assert {m["name"] for m in BENCH["per_layer"]} <= set(mods)
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        mod = mods[m["name"]]
        assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) \
            == (mod.UNIT, mod.BETTER, mod.SOURCE, mod.LAYER, mod.MOVES)
        assert set(m["workloads"]) <= cells
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in BENCH["workloads"]:
        rate = bench.load_json("traffic", w["traffic"])["metric"]
        assert w["name"] in e2e[rate]["workloads"]
        # each per-layer metric a cell lists moves a metric the cell reports
        for m in BENCH["per_layer"]:
            if w["name"] in m["workloads"]:
                assert m["moves"] == rate


def test_an_added_metric_mix_config_and_cell_are_found(tmp_path, monkeypatch):
    root = tmp_path / "webpbench"
    shutil.copytree(bench.ROOT, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests", "vp8ref"))
    (root / "metrics" / "encode.calls.py").write_text(
        'NAME = "encode.calls"\nUNIT = "calls"\nBETTER = "higher"\n'
        'SOURCE = "host_clock"\nLAYER = "device"\nMOVES = "encode_mps"\n'
        'def read(ctx):\n    return len(ctx.orders)\n')
    (root / "traffic" / "encode-batch32.json").write_text(json.dumps(
        {"name": "encode-batch32", "op": "encode", "metric": "encode_mps",
         "pool": 8, "batch": 32, "why": "smaller calls"}))
    cfg = bench.load_json("configs", "photo1mp-q75m4")
    (root / "configs" / "photo2mp.json").write_text(json.dumps(
        {**cfg, "name": "photo2mp",
         "image": {"height": 1024, "width": 2048, "channels": 3}}))
    (root / "workloads" / "photo2mp.encode32.json").write_text(json.dumps(
        {"name": "photo2mp.encode32", "config": "photo2mp",
         "traffic": "encode-batch32", "chips": 1, "why": "2 MP"}))
    monkeypatch.setattr(bench, "ROOT", root)
    assert "encode.calls" in [m.NAME for m in bench.metric_modules()]
    cell, cfg2, tr = run.load_cell("photo2mp.encode32")
    assert cfg2["image"]["width"] == 2048 and tr["batch"] == 32
    from webpbench.layers import LayerContext, read_metrics
    from webpbench.trace import Trace

    ctx = LayerContext(op="encode", timings={}, timed_items=0,
                       trace=Trace(), traced_items=0,
                       orders=[[0], [1]], files={})
    assert read_metrics(ctx)["encode.calls"]["value"] == 2


def _tiny_run(cell, trace, capsys):
    res, table = run.run_cell(cell, 2**31 + 12345, 0.5, trace,
                              t_start=time.time(), device="cpu",
                              config_override=SMALL_CFG,
                              traffic_override=SMALL_TR)
    bench.emit(res, table)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell,trace", [
    ("photo1mp-q75m4.encode-hybrid", False),
    ("photo1mp-q75m4.encode-hybrid", True),
    ("photo1mp-q75m4.decode-host", False),
    ("photo1mp-q75m4.decode-device", True)])
def test_the_last_line_has_the_keys(cell, trace, capsys):
    line = _tiny_run(cell, trace, capsys)
    want = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == want + (["breakdown"] if trace else []) + ["checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in line["metrics"]
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_a_cpu_run_is_refused_without_a_result(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "photo1mp-q75m4.encode-hybrid",
                   "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def _tiny_file(h, w, seed):
    from PIL import Image

    from webpbench.corpus import natural_image

    b = io.BytesIO()
    Image.fromarray(natural_image(h, w, seed=seed)).save(
        b, "WEBP", quality=75, method=4)
    return b.getvalue()


def test_roofline_counts_against_a_hand_count():
    from webpbench.vp8ref import decode_rgba, parse
    from webpbench.vp8ref.recon import dequantize, filter_params

    wf = bench.load_module("roofline", "wavefront_fixed")
    rf = bench.load_module("roofline", "recon_filter_mb")
    # wavefront_fixed: one i4 and one i16 macroblock, by the table of ops
    blk = 160 + 96 + 16 + 164 + 64
    i16 = 16 * (32 + blk) + 64 + 96 + 16 + 72
    i4 = 16 * (80 + blk)
    uv = 8 * (32 + blk) + 80
    assert wf.count(2, 1) == (i4 + i16 + 2 * uv, 2 * (384 + 20 + 800 + 384))
    # recon_filter_mb: 2 x 3 macroblocks, by the reference's decode
    data = _tiny_file(32, 48, 3)
    work = {}
    decode_rgba(data, work=work)
    fr = parse(data)
    assert (fr.mb_h, fr.mb_w) == (2, 3) and work["mb"] == 6
    coef = dequantize(fr)
    ac = (coef[..., 1:] != 0).any(-1)
    dc = (coef[..., 0] != 0) & ~ac
    assert (work["blocks_ac"], work["blocks_dc"]) == (ac.sum(), dc.sum())
    assert work["blocks_ac"] + work["blocks_dc"] <= 6 * 24
    # every line across an edge the frame filters is tested
    nz = (coef != 0).any(axis=(2, 3))
    limit, _, _, inner = filter_params(fr, nz)
    on = limit > 0
    edges = int(on[:, 1:].sum() + on[1:, :].sum())
    inner_n = int((on & inner).sum())
    lines = work["filter"]
    assert not fr.simple and set(lines) == {"mb", "inner"}
    assert lines["mb"][0] == 16 * edges + 2 * 8 * edges
    assert lines["inner"][0] == 16 * 6 * inner_n + 2 * 8 * 2 * inner_n
    for tested, passed, high in lines.values():
        assert tested >= passed >= high >= 0
    assert lines["mb"][1] > 0
    (tm, pm, hm), (ti, pi, hi) = lines["mb"], lines["inner"]
    filt = (tm * 31 + pm * 3 + hm * 20 + (pm - hm) * 35
            + ti * 31 + pi * 3 + hi * 20 + (pi - hi) * 24)
    n_i4 = int(fr.is_i4.sum())
    ops = (6 * 8 * 32 + n_i4 * 16 * 80 + (6 - n_i4) * 16 * 32
           + int(ac.sum()) * 228 + int(dc.sum()) * 66 + filt)
    assert rf.count([work]) == (ops, 6 * (768 + 18 + 8 + 384))
    assert rf.count([work, work]) == (2 * ops, 12 * (768 + 18 + 8 + 384))
    simple = {"simple": [100, 40, 0]}
    assert rf.filter_ops(simple) == 100 * 7 + 40 * 20


@pytest.mark.parametrize("pool,batch", [(32, 128), (16, 64), (2, 4),
                                        (8, 8)])
def test_no_group_of_a_call_holds_an_item_twice(pool, batch):
    m = batch // pool
    rng = np.random.default_rng(generator.seed_words(2**33 + 1, 2))
    orders = [generator.call_order(rng, {"pool": pool, "batch": batch})
              for _ in range(20)]
    for idx in orders:
        for r in range(m):                  # groups by stride
            assert sorted(idx[r::m]) == list(range(pool))
        for g in range(m):                  # groups by runs
            assert sorted(idx[g * pool:(g + 1) * pool]) == list(range(pool))
    if pool > 2:
        assert len({tuple(o) for o in orders}) == len(orders)


def test_the_programs_symbol_engines_never_get_a_file_twice(monkeypatch):
    """The decode mix's calls, split by the program's own batch decode:
    each symbol-engine call holds distinct streams."""
    import importlib

    dec = importlib.import_module("gowebp_tpu_torch.decode")
    tr = bench.load_json("traffic", "decode-batch128-device")
    files = [_tiny_file(16, 16, 100 + k) for k in range(tr["pool"])]
    assert len(set(files)) == tr["pool"]
    groups = []
    real = dec.decode_vp8_symbols_batch

    def spy(parts, *a, **k):
        groups.append([bytes(p) for p in parts])
        return real(parts, *a, **k)

    monkeypatch.setattr(dec, "decode_vp8_symbols_batch", spy)
    rng = np.random.default_rng(generator.seed_words(7, 2))
    for _ in range(2):
        idx = generator.call_order(rng, tr)
        out = dec.decode_rgba_batch([files[i] for i in idx], device="cpu")
        assert len(out) == tr["batch"]
    assert len(groups) == 2 * tr["batch"] // 32
    for g in groups:
        assert len(g) == 32 and len(set(g)) == 32


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module


def test_nothing_imports_jax_or_the_jax_package():
    for path in bench.ROOT.rglob("*.py"):
        for mod in _imports(path):
            assert mod.split(".", 1)[0] not in bench.FORBIDDEN_MODULES, (
                path, mod)
    # at run time the top-level names are compared whole: the port passes
    import gowebp_tpu_torch  # noqa: F401

    assert "gowebp_tpu_torch" in sys.modules
    assert bench.forbidden_loaded() == []


def test_the_reference_imports_nothing_of_the_program():
    for path in (bench.ROOT / "vp8ref").rglob("*.py"):
        for mod in _imports(path):
            assert not mod.startswith("gowebp"), (path, mod)
    for path in (bench.ROOT / "checks.py", bench.ROOT / "corpus.py",
                 bench.ROOT / "alpha_models.py"):
        for mod in _imports(path):
            assert not mod.startswith("gowebp"), (path, mod)


@pytest.mark.parametrize("h,w,q,m", [(32, 48, 75, 4), (77, 133, 30, 6),
                                     (96, 160, 90, 2), (17, 9, 75, 4)])
def test_the_reference_decodes_as_libwebp(h, w, q, m):
    from PIL import Image

    from webpbench.corpus import natural_image
    from webpbench.vp8ref import decode_rgba

    b = io.BytesIO()
    Image.fromarray(natural_image(h, w, seed=h * w)).save(
        b, "WEBP", quality=q, method=m)
    want = np.asarray(Image.open(io.BytesIO(b.getvalue())).convert("RGBA"))
    assert np.array_equal(decode_rgba(b.getvalue()), want)


def test_quality_to_q():
    assert checks.quality_to_q(75) == 26
    assert checks.quality_to_q(100) == 0


def test_seed_words_take_large_seeds():
    a = generator.seed_words(2**40 + 3, 1)
    b = generator.seed_words(3, 1)
    assert a != b and all(0 <= x < 2**32 for x in a)


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(capsys):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res, table = run.run_cell("photo1mp-q75m4.encode-hybrid", 7, 1.0, False,
                              t_start=time.time(),
                              config_override=SMALL_CFG,
                              traffic_override=SMALL_TR)
    assert res["correct"] and res["device"]["platform"] == "gpu"


# sha256 of three calls' orders of the decode mixes (pool 32, batch 128) at
# each seed, as the harness drew them before configurations could state
# sizes, alpha or lossless files
ORDERS = {1: "262a276240fe50c6", 2**31 + 5: "a545c7788d1b033c",
          4100000000101: "401c8fd00447380e"}


@pytest.mark.parametrize("seed", list(ORDERS))
def test_a_configuration_without_the_new_keys_makes_the_same_inputs(seed):
    import hashlib

    from PIL import Image

    from webpbench.corpus import natural_images

    cfg = {**bench.load_json("configs", "photo1mp-q75m4"), **SMALL_CFG}
    tr = {**bench.load_json("traffic", "decode-batch128-host"), **SMALL_TR}
    inp = generator.make_inputs(cfg, tr, seed)
    want = natural_images(2, 48, 80, seed=seed)
    assert len(inp.images) == 2
    assert all(np.array_equal(a, b) for a, b in zip(inp.images, want))
    for im, f in zip(want, inp.files):
        b = io.BytesIO()
        Image.fromarray(im).save(b, "WEBP", quality=75, method=4)
        assert f == b.getvalue()
    rng = np.random.default_rng(generator.seed_words(seed, 2))
    tr = bench.load_json("traffic", "decode-batch128-device")
    orders = [generator.call_order(rng, tr) for _ in range(3)]
    digest = hashlib.sha256(np.concatenate(orders).astype(np.int64)
                            .tobytes()).hexdigest()
    assert digest[:16] == ORDERS[seed]


@pytest.mark.parametrize("image,traffic", [
    ({"sizes": [[32, 32], [16, 48]], "channels": 3}, {"pool": 3, "batch": 3}),
    ({"sizes": [], "channels": 3}, {"pool": 2, "batch": 4}),
    ({"sizes": [[32]], "channels": 3}, {"pool": 2, "batch": 4}),
    ({"height": 32, "width": 32, "channels": 4}, {"pool": 2, "batch": 4}),
    ({"height": 32, "width": 32, "channels": 4, "alpha": "glass"},
     {"pool": 2, "batch": 4}),
    ({"height": 32, "width": 32, "channels": 3, "alpha": "cutout"},
     {"pool": 2, "batch": 4}),
    ({"height": 32, "width": 32, "channels": 4, "alpha": "cutout"},
     {"op": "encode", "pool": 2, "batch": 4})])
def test_a_configuration_the_generator_cannot_make_is_refused(image,
                                                              traffic):
    tr = {**bench.load_json("traffic", "decode-batch128-host"), **traffic}
    with pytest.raises(ValueError):
        generator.check_params(tr, {"image": image})
    with pytest.raises(ValueError):
        run.run_cell("photo1mp-q75m4.decode-host", 1, 0.1, False,
                     t_start=time.time(), device="cpu",
                     config_override={"image": image},
                     traffic_override=traffic)


@pytest.mark.parametrize("seed", [3, 2**33 + 17, 4100000000202])
def test_each_size_gets_its_share_of_the_pool(seed):
    sizes = [[48, 64], [17, 9], [33, 50]]
    got = generator.item_sizes({"sizes": sizes}, 12, seed)
    assert sorted(got) == sorted([tuple(s) for s in sizes] * 4)
    assert got != generator.item_sizes({"sizes": sizes}, 12, seed + 1)
    cfg = {"image": {"sizes": sizes, "channels": 3}}
    inp = generator.make_inputs(cfg, {"op": "encode", "pool": 12,
                                      "batch": 12}, seed)
    assert [im.shape for im in inp.images] == [(*s, 3) for s in got]
    win = generator.run_window(
        type("Echo", (), {"encode": lambda self, x, timings=None: x})(),
        inp, {"op": "encode", "pool": 12, "batch": 12}, seed, 0.0, 0)
    assert win.megapixels == win.calls * sum(h * w for h, w in got) / 1e6


@pytest.mark.parametrize("h,w,seed", [(1024, 1024, 11), (375, 500, 2**32),
                                      (256, 256, 5)])
def test_the_cutout_alpha_model(h, w, seed):
    from webpbench.alpha_models import cutout

    a = cutout(h, w, seed)
    assert a.shape == (h, w) and a.dtype == np.uint8
    assert np.array_equal(a, cutout(h, w, seed))
    assert 0.35 <= (a == 255).mean() <= 0.65          # the object
    assert 0.005 <= ((a > 0) & (a < 255)).mean() <= 0.2   # edge and shadow
    assert (a == 0).mean() >= 0.25
    assert not np.array_equal(a, cutout(h, w, seed + 1))


def test_a_lossless_file_adds_no_recon_work():
    from PIL import Image

    from webpbench.corpus import natural_image
    from webpbench.vp8ref import decode_rgba

    rf = bench.load_module("roofline", "recon_filter_mb")
    b = io.BytesIO()
    Image.fromarray(natural_image(32, 48, 1)).save(b, "WEBP", lossless=True)
    none, lossy = {}, {}
    decode_rgba(b.getvalue(), work=none)
    decode_rgba(_tiny_file(32, 48, 3), work=lossy)
    assert none == {} and lossy["mb"] == 6
    assert rf.count([none, lossy, none]) == rf.count([lossy])


@pytest.mark.parametrize("metric,key", [
    ("decode.symbols_ms_per_image", "symbols_s"),
    ("decode.pack_ms_per_image", "pack_s")])
def test_a_host_sum_with_no_lossy_file_reads_nothing(metric, key):
    """A call of VP8L files alone runs no symbol engine and no pack; the
    program's sums then read 0, and the reader returns nothing."""
    from webpbench.layers import LayerContext
    from webpbench.trace import Trace

    mod = bench.load_module("metrics", metric)

    def ctx(seconds):
        return LayerContext(op="decode", timings={key: seconds},
                            timed_items=4, trace=Trace(), traced_items=4,
                            orders=[], files={})

    assert mod.read(ctx(0.0)) is None
    assert mod.read(ctx(0.02)) == pytest.approx(5.0)
