"""The control of ``correct``: a cell run with the control in the program's
place, on several seeds, printing the numbers that decide ``correct``.  The
benchmark's own runs never run it.

    python3 -m webpbench.control --workload <cell> --seeds 1,2,3 \\
        [--seconds 1] [--device cuda|cpu]

The configurations state no precision, so each control breaks one
guarantee that its configuration states:
- encode cells: the program's own open-loop engine (engine="openloop"),
  which predicts from the source instead of the decoded picture (no closed
  loop) and drops the segments;
- decode cells: the reference decoder put in the program's place, with
  the step that would tempt a later change left out: a VP8 frame's loop
  filter (libwebp's bypass_filtering; a frame with an ALPH plane too),
  and a VP8L image's inverse predictor transform.
"""

from __future__ import annotations

import argparse
import json
import time

from .bench import log


class OpenLoop:
    """The program with its open-loop engine."""

    def __init__(self, program):
        self.p = program
        self.p.settings = {**program.settings, "engine": "openloop"}

    def encode(self, images, timings=None):
        return self.p.encode(images, timings)


class UnfilteredReference:
    """The reference decoder without the loop filter or the inverse
    predictor, a file decoded once."""

    def __init__(self, program):
        self.memo = {}

    def decode(self, files, timings=None):
        from .vp8ref import decode_rgba

        out = []
        for f in files:
            if f not in self.memo:
                self.memo[f] = decode_rgba(f, loop_filter_on=False,
                                           predictor_on=False)
            out.append(self.memo[f])
        return out


def control_for(op: str):
    return OpenLoop if op == "encode" else UnfilteredReference


def main(argv=None) -> int:
    from .run import load_cell, run_cell

    ap = argparse.ArgumentParser(prog="python3 -m webpbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    _, _, traffic = load_cell(args.workload)
    wrap = control_for(traffic["op"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        result, table = run_cell(args.workload, seed, args.seconds, False,
                                 t_start=t0, device=args.device,
                                 wrap_program=wrap)
        line = {"workload": args.workload, "seed": seed, "control": wrap.__name__,
                "correct": result["correct"],
                "checks": {k: v["value"] for k, v in table.items()},
                "seconds": time.time() - t0}
        log(json.dumps(line))
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
