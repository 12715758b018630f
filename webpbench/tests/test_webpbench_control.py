"""``correct`` comes out false under the control and under each fault a
cell can have, with the rest of a run driven as the benchmark drives it
(here on the CPU at a tiny size; the card is not looked for), for each
cell and for the decode cells with each kind of pool a configuration can
state (mixed sizes, RGBA cut-outs, lossless files)."""

import time

import numpy as np
import pytest

from webpbench import run
from webpbench.control import control_for
from webpbench.tests.conftest import POOLS

SMALL_CFG = {"image": {"height": 48, "width": 64, "channels": 3}}
SMALL_TR = {"pool": 2, "batch": 4}
CELLS = ["photo1mp-q75m4.encode-hybrid", "photo1mp-q75m4-exact.encode",
         "photo1mp-q75m4.decode-device", "photo1mp-q75m4.decode-host"]


class Fault:
    def __init__(self, program, kind):
        self.p, self.kind, self.last = program, kind, None

    def _call(self, fn, items, timings):
        out = list(fn(items, timings))
        if self.kind == "half_left_out":
            return out[:len(out) // 2]
        if self.kind == "state_unchanged":
            prev, self.last = self.last, out
            return prev if prev is not None else out
        if self.kind == "answer_altered":
            return [_alter(o) for o in out]
        raise ValueError(self.kind)

    def encode(self, images, timings=None):
        return self._call(self.p.encode, images, timings)

    def decode(self, files, timings=None):
        return self._call(self.p.decode, files, timings)


def _alter(out):
    if isinstance(out, (bytes, bytearray)):
        b = bytearray(out)
        b[len(b) - 40] ^= 0x24             # a byte of the token partition
        return bytes(b)
    a = np.array(out)
    a[a.shape[0] // 2, a.shape[1] // 2, 1] ^= 1
    return a


def _run(cell, wrap):
    res, table = run.run_cell(cell, 2**32 + 77, 0.3, False,
                              t_start=time.time(), device="cpu",
                              wrap_program=wrap, config_override=SMALL_CFG,
                              traffic_override=SMALL_TR)
    return res, {k: v["value"] for k, v in table.items()}


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    res, numbers = _run(cell, None)
    assert res["correct"], numbers
    assert all(v == 0 for v in numbers.values())


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    op = "encode" if "encode" in cell else "decode"
    res, numbers = _run(cell, control_for(op))
    assert not res["correct"], numbers
    assert any(v > 0 for v in numbers.values())


@pytest.mark.parametrize("kind", ["half_left_out", "state_unchanged",
                                  "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_each_fault_is_not_correct(cell, kind):
    res, numbers = _run(cell, lambda p: Fault(p, kind))
    assert not res["correct"], (kind, numbers, res["failed"])


def _run_pool(cell, pool, wrap):
    cfg, tr = POOLS[pool]
    res, table = run.run_cell(cell, 2**32 + 91, 0.3, False,
                              t_start=time.time(), device="cpu",
                              wrap_program=wrap, config_override=cfg,
                              traffic_override=tr)
    return res, {k: v["value"] for k, v in table.items()}


@pytest.mark.parametrize("pool", list(POOLS))
@pytest.mark.parametrize("cell", ["photo1mp-q75m4.decode-device",
                                  "photo1mp-q75m4.decode-host"])
def test_a_sound_run_of_each_pool_is_correct(cell, pool):
    res, numbers = _run_pool(cell, pool, None)
    assert res["correct"] and res["failed"] == 0, numbers
    assert all(v == 0 for v in numbers.values())


@pytest.mark.parametrize("pool", list(POOLS))
def test_the_control_is_not_correct_on_each_pool(pool):
    res, numbers = _run_pool("photo1mp-q75m4.decode-host", pool,
                             control_for("decode"))
    assert not res["correct"], numbers
    assert numbers["pixel_mismatch"] > 0


@pytest.mark.parametrize("kind", ["half_left_out", "state_unchanged",
                                  "answer_altered"])
@pytest.mark.parametrize("pool", list(POOLS))
def test_each_fault_is_not_correct_on_each_pool(pool, kind):
    res, numbers = _run_pool("photo1mp-q75m4.decode-host", pool,
                             lambda p: Fault(p, kind))
    assert not res["correct"], (kind, numbers, res["failed"])
