"""Canonical Huffman codes: depth-limited code lengths for the VP8L
encoder, and a table decoder for the incremental VP8L decoder.

``build_code_lengths`` makes a Huffman tree from symbol counts and, when
it is deeper than the format allows, rebuilds it from counts shifted
right until it fits (the classic libwebp strategy); ``canonical_codes``
assigns the canonical codes for the lengths; ``HuffmanDecodeTable``
reads symbols of a code back from a ``BitReader``.  Written from the
canonical-code definition of the lossless bitstream spec.
"""

from __future__ import annotations

import heapq

import numpy as np

from ..constants import MAX_ALLOWED_CODE_LENGTH
from ..errors import BitstreamError


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


def _reverse_bits(v: int, n: int) -> int:
    r = 0
    for _ in range(n):
        r = (r << 1) | (v & 1)
        v >>= 1
    return r


class HuffmanDecodeTable:
    """Flat LUT decoder: peek ``max_len`` LSB-first bits, look up, consume."""

    __slots__ = ("max_len", "sym", "lens", "single_symbol")

    def __init__(self, code_lengths):
        lengths = np.asarray(code_lengths, dtype=np.int32)
        used = np.flatnonzero(lengths > 0)
        if len(used) == 0:
            raise BitstreamError("huffman code with no symbols")
        if len(used) == 1:
            # Single-symbol code: zero bits per symbol.
            self.max_len = 0
            self.single_symbol = int(used[0])
            self.sym = None
            self.lens = None
            return
        self.single_symbol = -1
        max_len = int(lengths.max())
        if max_len > MAX_ALLOWED_CODE_LENGTH:
            raise BitstreamError("code length exceeds 15")
        # Kraft sum must be exactly 1 for a complete code.
        kraft = int(np.sum((1 << (max_len - lengths[used])).astype(np.int64)))
        if kraft != (1 << max_len):
            raise BitstreamError("invalid (incomplete/oversubscribed) huffman code")
        self.max_len = max_len
        codes = canonical_codes(lengths)
        size = 1 << max_len
        self.sym = np.zeros(size, dtype=np.int32)
        self.lens = np.zeros(size, dtype=np.int32)
        for s in used:
            ln = int(lengths[s])
            rc = _reverse_bits(int(codes[s]), ln)
            step = 1 << ln
            idx = np.arange(rc, size, step)
            self.sym[idx] = s
            self.lens[idx] = ln

    def decode(self, br) -> int:
        """Read one symbol from a BitReader."""
        if self.max_len == 0:
            return self.single_symbol
        key = br.peek_bits(self.max_len)
        ln = self.lens[key]
        br.skip_bits(int(ln))
        return int(self.sym[key])


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


__all__ = ["HuffmanDecodeTable", "build_code_lengths", "canonical_codes"]
