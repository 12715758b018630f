"""The VP8 frame's length fields: the port refuses what does not fit.

The frame tag holds the first partition's length in 19 bits and each
token partition's length but the last in 3 bytes.  libwebp refuses a
frame whose lengths do not fit (VP8_ENC_ERROR_PARTITION0_OVERFLOW,
VP8_ENC_ERROR_PARTITION_OVERFLOW); the JAX package writes the truncated
length, a file no decoder reads.  The port raises EncodeError, a kept
difference from the reference.
"""

from __future__ import annotations

import pytest

from gowebp_tpu.models.vp8.encoder import _frame_bytes as jax_frame_bytes
from gowebp_tpu_torch.errors import EncodeError
from gowebp_tpu_torch.models.vp8.encoder import (MAX_PARTITION0_SIZE,
                                                 MAX_PARTITION_SIZE,
                                                 _frame_bytes)


def _tag_length(frame: bytes) -> int:
    return (frame[0] | frame[1] << 8 | frame[2] << 16) >> 5


@pytest.mark.parametrize("n", [1, 1000, MAX_PARTITION0_SIZE])
def test_first_partition_lengths_that_fit_match_the_reference(n):
    part0, parts = bytes(n), [b"\x01\x02", b"\x03"]
    got = _frame_bytes(part0, parts, 33, 17)
    assert got == jax_frame_bytes(part0, parts, 33, 17)
    assert _tag_length(got) == n


def test_a_first_partition_of_512k_is_refused():
    part0 = bytes(MAX_PARTITION0_SIZE + 1)
    with pytest.raises(EncodeError, match="partition #0 is too big"):
        _frame_bytes(part0, [b"\x00"], 16, 16)
    # the reference writes the length modulo 2^19: here 0
    assert _tag_length(jax_frame_bytes(part0, [b"\x00"], 16, 16)) == 0


def test_the_reference_misstates_a_first_partition_past_512k():
    """What the port refuses: the reference's frame with a first
    partition of 2^19 + 1000 bytes claims 1000, so a decoder reads the
    rest of it as token partitions."""
    part0 = bytes(MAX_PARTITION0_SIZE + 1001)
    assert _tag_length(jax_frame_bytes(part0, [b"\x00"], 16, 16)) == 1000
    with pytest.raises(EncodeError):
        _frame_bytes(part0, [b"\x00"], 16, 16)


def test_token_partition_sizes_that_fit_and_the_last_unbounded():
    big = bytes(MAX_PARTITION_SIZE)
    got = _frame_bytes(b"\x00", [big, b"\x01"], 16, 16)
    assert got[11:14] == b"\xff\xff\xff"
    # the last partition's length is not written: any size goes
    assert len(_frame_bytes(b"\x00", [b"\x01", bytes(MAX_PARTITION_SIZE + 1)],
                            16, 16)) == 10 + 1 + 3 + 1 + MAX_PARTITION_SIZE + 1


def test_a_token_partition_of_16m_is_refused():
    with pytest.raises(EncodeError, match="bigger than 16M"):
        _frame_bytes(b"\x00", [bytes(MAX_PARTITION_SIZE + 1), b"\x01"], 16,
                     16)
