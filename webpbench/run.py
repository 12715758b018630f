"""Runs one cell of the benchmark once and prints its result line.

    python3 -m webpbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds the program (gowebp_tpu_torch).
With --trace 0 it reports the cell's end-to-end metrics (its rate and
setup_s); with --trace 1 the per-layer metrics that metrics/ finds in a
torch.profiler trace of the window.  It exits non-zero and prints no result
without a CUDA card, without the program, or if JAX or the JAX package was
loaded.
"""

from __future__ import annotations

import time

_T_IMPORT = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import sys  # noqa: E402

from . import bench, checks, generator  # noqa: E402
from .bench import log  # noqa: E402


def _log_window(what: str, win) -> None:
    done = win.items - win.failed
    calls = " ".join(f"{t:.3f}" for t in win.call_s)
    log(f"{what} {win.seconds:.3f} s: {win.calls} calls, {done} of "
        f"{win.items} items, {win.megapixels:.3f} MP; calls (s): {calls}")


def _peak(cuda: bool) -> int:
    import torch

    return int(torch.cuda.max_memory_allocated()) if cuda else 0


def load_cell(name: str):
    cell = bench.load_json("workloads", name)
    config = bench.load_json("configs", cell["config"])
    traffic = bench.load_json("traffic", cell["traffic"])
    generator.check_params(traffic, config)
    return cell, config, traffic


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device=None, wrap_program=None,
             config_override=None, traffic_override=None):
    """(result without "checks", checks).  ``device`` None means CUDA;
    ``wrap_program`` puts another program (a control, a planted fault) in
    the program's place; the overrides replace a configuration's or a
    mix's parameters (tests use them to run a cell at a tiny size)."""
    import torch

    cell, config, traffic = load_cell(name)
    if config_override:
        config = {**config, **config_override}
    if traffic_override:
        traffic = {**traffic, **traffic_override}
    generator.check_params(traffic, config)
    cuda = device is None
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    program = generator.Program(config, traffic, device)
    program.check_settings()
    if wrap_program is not None:
        program = wrap_program(program)
    inputs = generator.make_inputs(config, traffic, seed)
    generator.warm_up(program, inputs, traffic, seed, with_timings=trace)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.time() - t_start
    log(f"set-up {setup_s:.3f} s")
    held = config["held_to"]
    keep = held.get("outputs_per_call", 0)

    dev = (bench.device_description(1) if cuda
           else {"platform": "cpu", "kind": "cpu", "count": 0})
    if trace:
        # first half: the program's own timings; second half: the profiler
        # (its host-side cost would inflate those timings)
        from . import trace as tracing

        timed = generator.run_window(program, inputs, traffic, seed,
                                     seconds / 2, keep, timed=True)
        prof = tracing.profiler()
        with prof:
            win = generator.run_window(program, inputs, traffic, seed,
                                       seconds / 2, keep,
                                       profiler_span=tracing.span, stream=1)
        tr = tracing.read(prof)
        del prof
        _log_window("timed half", timed)
        _log_window("traced half", win)
        dev["memory_peak_bytes"] = _peak(cuda)
        kept = timed.kept + win.kept
        attempted, failed = timed.items + win.items, timed.failed + win.failed
    else:
        win = generator.run_window(program, inputs, traffic, seed, seconds,
                                   keep)
        _log_window("window", win)
        dev["memory_peak_bytes"] = _peak(cuda)
        metrics = {traffic["metric"]: {"value": win.megapixels / win.seconds,
                                       "unit": "MP/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
        kept = win.kept
        attempted, failed = win.items, win.failed

    # the program's state goes before the reference runs
    del program
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    work = {}
    if traffic["op"] == "encode":
        numbers = checks.check_encode(config, inputs.images, kept)
    else:
        kept = [(i, checks.to_host(o)) for i, o in kept]
        refs, works = checks.reference_decodes(inputs.files)
        numbers = checks.check_decode(refs, kept)
        work = dict(enumerate(works))
        del refs
    log(f"reference check {time.perf_counter() - t0:.3f} s")
    if trace:
        from .layers import LayerContext, read_metrics
        from .peaks import int32_ops_per_s

        files = (win.first if traffic["op"] == "encode"
                 else dict(enumerate(inputs.files)))
        ctx = LayerContext(op=traffic["op"], timings=timed.timings,
                           timed_items=timed.items - timed.failed,
                           trace=tr, traced_items=win.items - win.failed,
                           orders=win.orders, files=files, work=work,
                           ops_per_s=int32_ops_per_s() if cuda else None)
        metrics = read_metrics(ctx)
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s()
    del win
    correct, table = checks.judge(numbers, held["limits"])
    result = {"correct": bool(correct and failed == 0),
              "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = tr.breakdown()
    return result, table


def main(argv=None) -> int:
    t_start = bench.process_start_wall() or _T_IMPORT
    ap = argparse.ArgumentParser(prog="python3 -m webpbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell, _, _ = load_cell(args.workload)
    try:
        import gowebp_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"the program is not in this checkout: {e!r}")
        return 3
    import torch

    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell["chips"]):
        log(f"cell {args.workload} needs {cell['chips']} CUDA card(s); "
            f"this process sees {torch.cuda.device_count()}: no result")
        return 2
    result, table = run_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace), t_start=t_start)
    bad = bench.forbidden_loaded()
    if bad:
        log(f"modules loaded that the benchmark may not load: {bad}; "
            f"no result")
        return 4
    log(f"card: {result['device']}")
    bench.emit(result, table)
    return 0


if __name__ == "__main__":
    sys.exit(main())
