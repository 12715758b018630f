"""LSB-first bit I/O for the VP8L lossless bitstream.

Bits are packed into bytes starting at the least-significant bit.  The
VP8L decoder reads its headers with ``BitReader``; the pixel loop and the
prefix-code section run in the native layer (entropy/native/vp8l_dec.cpp),
which takes the reader's ``bit_pos`` and hands back where it stopped.
The VP8L encoder (the ALPH chunk's stream) writes with ``BitWriter``; its
symbol emission runs natively too and continues the writer's state.
"""

from __future__ import annotations


class BitReader:
    """LSB-first bit reader over an immutable byte buffer.

    Reads past the end return zero bits and set ``eos``, so a decoder
    can detect truncation after the fact rather than mid-symbol.
    """

    __slots__ = ("data", "bit_pos", "bit_len")

    def __init__(self, data: bytes):
        self.data = data
        self.bit_pos = 0
        self.bit_len = 8 * len(data)

    @property
    def eos(self) -> bool:
        return self.bit_pos > self.bit_len

    def read_bits(self, n: int) -> int:
        """Read n (0..56) bits; the first bit read is the lowest bit."""
        v = self.peek_bits(n)
        self.bit_pos += n
        return v

    def peek_bits(self, n: int) -> int:
        byte_pos = self.bit_pos >> 3
        bit_off = self.bit_pos & 7
        chunk = int.from_bytes(self.data[byte_pos : byte_pos + 8], "little")
        return (chunk >> bit_off) & ((1 << n) - 1)

    def skip_bits(self, n: int) -> None:
        self.bit_pos += n

    def read_bit(self) -> int:
        return self.read_bits(1)


class BitWriter:
    """LSB-first bit writer with a Python-int accumulator."""

    __slots__ = ("_buf", "_acc", "_used")

    def __init__(self):
        self._buf = bytearray()
        self._acc = 0
        self._used = 0

    def put_bits(self, value: int, n: int) -> None:
        """Append the low n bits of value (lowest bit written first)."""
        self._acc |= (value & ((1 << n) - 1)) << self._used
        self._used += n
        while self._used >= 8:
            self._buf.append(self._acc & 0xFF)
            self._acc >>= 8
            self._used -= 8

    @property
    def bit_count(self) -> int:
        return 8 * len(self._buf) + self._used

    def getvalue(self) -> bytes:
        """Final byte string (zero-pads the trailing partial byte)."""
        out = bytes(self._buf)
        if self._used:
            out += bytes([self._acc & 0xFF])
        return out

    def append_writer(self, other: "BitWriter") -> None:
        """Splice another writer's bits onto this one (56-bit chunks)."""
        data = bytes(other._buf)
        n7 = len(data) - (len(data) % 7)
        for i in range(0, n7, 7):
            self.put_bits(int.from_bytes(data[i : i + 7], "little"), 56)
        if n7 != len(data):
            rest = data[n7:]
            self.put_bits(int.from_bytes(rest, "little"), 8 * len(rest))
        if other._used:
            self.put_bits(other._acc, other._used)


__all__ = ["BitReader", "BitWriter"]
