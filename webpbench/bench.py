"""Shared pieces of the harness: finding a cell's files by name, the card's
description, the process clock and the result line.

Everything that belongs to one configuration, traffic mix, cell, per-layer
metric or kernel count is a file of its own under this folder, found by the
name ``BENCHMARK.json`` gives it:

    configs/<config>.json     traffic/<mix>.json      workloads/<cell>.json
    metrics/<metric>.py       roofline/<kernel>.py
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
# top-level module names the harness and the program may not load
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "gowebp_tpu")


def check_name(name: str) -> str:
    if not NAME_RE.match(name):
        raise ValueError(f"not a valid name: {name!r}")
    return name


def load_json(kind: str, name: str) -> dict:
    """configs/, traffic/ or workloads/<name>.json."""
    path = ROOT / kind / f"{check_name(name)}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """metrics/ or roofline/<name>.py as a module of its own."""
    path = ROOT / kind / f"{check_name(name)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module for {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"webpbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def names(kind: str, suffix: str) -> list:
    return sorted(p.name[:-len(suffix)] for p in (ROOT / kind).glob(f"*{suffix}")
                  if not p.name.startswith("_"))


def metric_modules() -> list:
    return [load_module("metrics", n) for n in names("metrics", ".py")]


def process_start_wall() -> float | None:
    """Wall-clock time at which this process started (Linux /proc)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = int(fields[19])                 # field 22: starttime
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return None


def nvidia_smi(query: str) -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


def device_description(count: int) -> dict:
    import torch

    limit = nvidia_smi("power.limit")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "power_limit_w": float(limit) if limit else None}


def forbidden_loaded() -> list:
    return sorted({m.split(".", 1)[0] for m in sys.modules}
                  & set(FORBIDDEN_MODULES))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def emit(result: dict, checks: dict) -> None:
    """The numbers compared beside their limits as the last lines of
    standard error, and the result as the last line of standard output,
    with those numbers under "checks", its last key."""
    for k, c in checks.items():
        log(f"check {k}: {c['value']} (limit {c['limit']})")
    line = dict(result)
    line["checks"] = checks
    print(json.dumps(line), flush=True)

