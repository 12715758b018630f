"""Runs the plain reference over many items in a few worker processes, once
the window has closed.  Each worker is ``python3 -m webpbench.refpool
<task>`` started from the checkout's root; it reads its share of the jobs,
pickled, on standard input and writes the results, pickled, on standard
output.  Nothing is written to disk, and every worker has ended when
``run`` returns.  Tasks are the functions that ``checks.TASKS`` names."""

from __future__ import annotations

import os
import pickle
import subprocess
import sys

from .bench import ROOT

MAX_WORKERS = 8


def workers_for(jobs: int) -> int:
    return max(1, min(jobs, os.cpu_count() or 1, MAX_WORKERS))


def run(task: str, jobs: list) -> list:
    """[TASKS[task](*job) for job in jobs], in ``workers_for`` processes."""
    if not jobs:
        return []
    n = workers_for(len(jobs))
    env = {**os.environ, "OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1",
           "MKL_NUM_THREADS": "1"}
    procs = []
    try:
        for _ in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "webpbench.refpool", task],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                cwd=ROOT.parent, env=env))
        # a worker reads all of its share before it writes anything
        for w, p in enumerate(procs):
            p.stdin.write(pickle.dumps(jobs[w::n]))
            p.stdin.close()
        out = [None] * len(jobs)
        for w, p in enumerate(procs):
            got = p.stdout.read()
            if p.wait() != 0:
                raise RuntimeError(f"reference worker {w} ({task}) exited "
                                   f"with {p.returncode}")
            out[w::n] = pickle.loads(got)
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def main() -> int:
    from .checks import TASKS

    fn = TASKS[sys.argv[1]]
    jobs = pickle.load(sys.stdin.buffer)
    pickle.dump([fn(*job) for job in jobs], sys.stdout.buffer)
    sys.stdout.buffer.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
