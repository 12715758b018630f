"""LSB-first bit reader for the VP8L lossless bitstream.

Bits are packed into bytes starting at the least-significant bit.  The
VP8L decoder reads its headers with this class; the pixel loop and the
prefix-code section run in the native layer (entropy/native/vp8l_dec.cpp),
which takes the reader's ``bit_pos`` and hands back where it stopped.
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


__all__ = ["BitReader"]
