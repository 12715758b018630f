"""What a per-layer metric's reader sees of a traced run, and the loop that
asks every reader in metrics/ for its number."""

from __future__ import annotations

from dataclasses import dataclass, field

from .bench import log, metric_modules


@dataclass
class LayerContext:
    op: str                         # "encode" or "decode"
    timings: dict                   # the program's own timings, accumulated
    timed_items: int                # images or files those timings cover
    trace: object                   # trace.Trace of the traced window
    traced_items: int               # images or files the trace covers
    orders: list                    # pool indices of each traced call
    files: dict                     # pool index -> .webp bytes (in or out)
    work: dict = field(default_factory=dict)  # pool index -> the reference
                                    # decode's work (vp8ref.decode_rgba)
    ops_per_s: float | None = None  # the card's int32 ceiling
    _frames: dict = field(default_factory=dict)

    def frame(self, i: int):
        """Pool item ``i``'s file, first partition parsed (no tokens)."""
        if i not in self._frames:
            from .vp8ref import parse

            self._frames[i] = parse(self.files[i], tokens=False)
        return self._frames[i]


def read_metrics(ctx: LayerContext) -> dict:
    """{name: {"value", "unit", ...}} of every reader that found its data."""
    out = {}
    for mod in metric_modules():
        got = mod.read(ctx)
        if got is None:
            continue
        entry = got if isinstance(got, dict) else {"value": got}
        entry = {"value": entry["value"], "unit": mod.UNIT,
                 **{k: v for k, v in entry.items() if k != "value"}}
        out[mod.NAME] = entry
        log(f"{mod.NAME}: {entry}")
    return out
