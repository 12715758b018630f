"""Canonical, depth-limited Huffman codes for the VP8L encoder.

``build_code_lengths`` makes a Huffman tree from symbol counts and, when
it is deeper than the format allows, rebuilds it from counts shifted
right until it fits (the classic libwebp strategy); ``canonical_codes``
assigns the canonical codes for the lengths.  Written from the
canonical-code definition of the lossless bitstream spec.
"""

from __future__ import annotations

import heapq

import numpy as np

from ..constants import MAX_ALLOWED_CODE_LENGTH


def canonical_codes(code_lengths) -> np.ndarray:
    """Assign canonical codes (MSB-first integers) for the given lengths.

    Symbols with length 0 get code 0 (unused).  Codes are assigned in
    increasing symbol order within each length, lengths ascending.
    """
    lengths = np.asarray(code_lengths, dtype=np.int32)
    max_len = int(lengths.max(initial=0))
    codes = np.zeros(len(lengths), dtype=np.uint32)
    if max_len == 0:
        return codes
    bl_count = np.bincount(lengths, minlength=max_len + 1)
    bl_count[0] = 0
    next_code = np.zeros(max_len + 2, dtype=np.uint64)
    code = 0
    for ln in range(1, max_len + 1):
        code = (code + int(bl_count[ln - 1])) << 1
        next_code[ln] = code
    for sym, ln in enumerate(lengths):
        if ln > 0:
            codes[sym] = next_code[ln]
            next_code[ln] += 1
    return codes


def build_code_lengths(histogram,
                       max_depth: int = MAX_ALLOWED_CODE_LENGTH) -> np.ndarray:
    """Depth-limited Huffman code lengths from symbol counts.

    Standard Huffman tree by pairing min-frequency nodes; if the resulting
    depth exceeds ``max_depth``, retry with counts right-shifted until the
    tree fits.  Always complete and canonical-compatible.
    """
    counts = np.asarray(histogram, dtype=np.int64)
    n = len(counts)
    lengths = np.zeros(n, dtype=np.int32)
    used = np.flatnonzero(counts > 0)
    if len(used) == 0:
        return lengths
    if len(used) == 1:
        lengths[used[0]] = 1
        return lengths

    shift = 0
    while True:
        work = counts.copy()
        if shift:
            nz = work > 0
            work[nz] = np.maximum(work[nz] >> shift, 1)
        depths = _huffman_depths(work)
        if depths.max() <= max_depth:
            lengths[:] = depths
            return lengths
        shift += 1
        if shift > 32:
            raise RuntimeError("failed to limit huffman depth")


def _huffman_depths(counts: np.ndarray) -> np.ndarray:
    n = len(counts)
    used = np.flatnonzero(counts > 0)
    depths = np.zeros(n, dtype=np.int32)
    # heap of (count, tiebreak, node); leaves are ints, internal are lists.
    heap = []
    serial = 0
    for s in used:
        heap.append((int(counts[s]), serial, int(s)))
        serial += 1
    heapq.heapify(heap)
    while len(heap) > 1:
        c1, _, n1 = heapq.heappop(heap)
        c2, _, n2 = heapq.heappop(heap)
        heapq.heappush(heap, (c1 + c2, serial, [n1, n2]))
        serial += 1
    # DFS assigning depths.
    stack = [(heap[0][2], 0)]
    while stack:
        node, d = stack.pop()
        if isinstance(node, int):
            depths[node] = max(d, 1)
        else:
            stack.append((node[0], d + 1))
            stack.append((node[1], d + 1))
    return depths


__all__ = ["build_code_lengths", "canonical_codes"]
