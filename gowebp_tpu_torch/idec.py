"""Incremental (push) decoding: append bytes, get rows as they decode.

libwebp's WebPINewDecoder/WebPIAppend state machine.  ``append`` feeds
bytes and returns the state: ``STATE_HEADER`` until the headers have
arrived, ``STATE_DATA`` while the image decodes, ``STATE_DONE`` once the
whole file is there (its output then comes from the full decoder).

A lossy (VP8) stream is parsed macroblock by macroblock in Python on the
host (models/vp8/decoder.py ``_parse_intra_mode``, ``_parse_residuals``):
each MB saves the boolean decoder's state and the contexts it changes
before it is parsed, so a stream that runs dry mid-row drops only the
unfinished MB and resumes there.  ``get_partial_output`` turns the
finished MB rows into the native engine's dense arrays and runs them
through the same device path as ``decode()``: one upload, the
``recon_filter_mb`` kernel and the fancy ``yuv420_to_rgba`` kernel
(their plain versions on the CPU).  Rows are final one MB row behind the
parse (the loop filter of the next row reaches up into them), and their
alpha is 255 (an ALPH chunk is read only once the file is complete).

A lossless (VP8L) stream resumes inside its Python pixel loop from
checkpoints every 8 rows (models/vp8l/decoder.py
``VP8LIncrementalPixels``); partial rows get the inverse transforms on
the host.
"""

from __future__ import annotations

import copy
import struct

import numpy as np

from .constants import CHUNK_VP8, CHUNK_VP8L, RIFF_HEADER_SIZE
from .container.riff import get_features, parse_riff
from .device import resolve_device
from .entropy.bool_coder import BoolDecoder
from .errors import BitstreamError, NotEnoughData

STATE_HEADER = "header"
STATE_DATA = "data"
STATE_DONE = "done"


class IncrementalDecoder:
    """``device`` None means CUDA and raises without it; ``device="cpu"``
    runs the kernels' plain versions (identical pixels)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._buf = bytearray()
        self.state = STATE_HEADER
        self.features = None
        self._vp8 = None       # _VP8RowDecoder
        self._vp8l = None      # _VP8LRowDecoder
        self._output = None

    def append(self, chunk: bytes) -> str:
        """Feed more bytes; returns the current state."""
        self._buf.extend(chunk)
        if self.state == STATE_HEADER:
            try:
                self.features = get_features(bytes(self._buf), tolerant=True)
                self.state = STATE_DATA
            except NotEnoughData:
                return self.state
            except BitstreamError:
                # Could still be a truncated header; wait for more bytes.
                if len(self._buf) > 64:
                    raise
                return self.state
        if self.state == STATE_DATA:
            self._advance()
        return self.state

    def _advance(self) -> None:
        data = bytes(self._buf)
        try:
            parsed = parse_riff(data)
        except NotEnoughData:
            parsed = None
        if parsed is not None:
            vp8l = parsed.find(CHUNK_VP8L)
            if vp8l is not None:
                from .models.vp8l.decoder import decode_vp8l

                self._output = decode_vp8l(vp8l.payload)
                self.state = STATE_DONE
                return
            if parsed.find(CHUNK_VP8) is None:
                # RIFF parsed but the image chunk hasn't arrived yet
                # (e.g. header + partial chunk header): keep waiting.
                return
            from .decode import decode_rgba

            self._output = decode_rgba(data, device=self.device)
            self.state = STATE_DONE
            return
        # Partial data: advance the row decoder for the detected format.
        if self.features is not None and self.features.format == "lossy":
            self._advance_vp8(data)
        elif self.features is not None and self.features.format == "lossless":
            self._advance_vp8l(data)

    @staticmethod
    def _find_chunk_payload(data: bytes, want: bytes):
        """A chunk's (possibly truncated) payload inside data, and whether
        all of it is there: (payload, complete), or (None, False)."""
        pos = RIFF_HEADER_SIZE
        while pos + 8 <= len(data):
            tag = data[pos : pos + 4]
            size = struct.unpack_from("<I", data, pos + 4)[0]
            if tag == want:
                payload = data[pos + 8 : pos + 8 + size]
                return payload, len(payload) == size
            pos += 8 + size + (size & 1)
        return None, False

    def _advance_vp8l(self, data: bytes) -> None:
        payload, _ = self._find_chunk_payload(data, CHUNK_VP8L)
        if payload is None:
            return
        if self._vp8l is None:
            try:
                self._vp8l = _VP8LRowDecoder(payload)
            except (NotEnoughData, BitstreamError, IndexError):
                return
        else:
            self._vp8l.payload = payload
        self._vp8l.decode_available_rows()

    def _advance_vp8(self, data: bytes) -> None:
        # The VP8 chunk payload may itself be truncated; find its span.
        payload, complete = self._find_chunk_payload(data, CHUNK_VP8)
        if payload is None:
            return
        if self._vp8 is None:
            try:
                self._vp8 = _VP8RowDecoder(payload, complete)
            except (NotEnoughData, BitstreamError):
                return
        else:
            self._vp8.update_data(payload, complete)
        self._vp8.decode_available_rows()

    @property
    def rows_decoded(self) -> int:
        """Finalized output rows available via get_partial_output()."""
        if self.state == STATE_DONE and self._output is not None:
            return self._output.shape[0]
        if self._vp8l is not None:
            return self._vp8l.rows_done
        if self._vp8 is None:
            return 0
        done_mb_rows = max(0, self._vp8.rows_done - 1)  # loop-filter lag
        return min(done_mb_rows * 16, self._vp8.st.height)

    def get_partial_output(self) -> np.ndarray | None:
        """RGBA rows decoded so far (None if nothing is final yet)."""
        if self.state == STATE_DONE:
            return self._output
        n = self.rows_decoded
        if n == 0:
            return None
        if self._vp8l is not None:
            return self._vp8l.partial_rgba(n)
        if self._vp8 is None:
            return None
        return self._vp8.partial_rgba(n, self.device)

    def get_output(self) -> np.ndarray:
        if self.state != STATE_DONE:
            raise NotEnoughData("stream incomplete")
        return self._output


def _bd_state(bd):
    return (bd.pos, bd.value, bd.range, bd.bit_count)


def _bd_restore(bd, s):
    bd.pos, bd.value, bd.range, bd.bit_count = s


class _VP8RowDecoder:
    """Row-granular VP8 symbol decoding with save/restore on starvation.

    A macroblock's tokens commit only if their parse read no byte past
    the end of what has arrived of its partition, unless the partition is
    complete: the boolean decoder's window looks 2 bytes ahead, and zeros
    read in place of bytes still to come can change its decisions.  (The
    JAX package's decoder commits an MB that read up to 4 such bytes, and
    builds a partition's decoder on fewer than the 2 bytes its window
    loads, so its partial rows can differ from the final decode's.)  With
    this rule the committed MBs, and the partial rows, are those of a
    decoder given the same bytes at once, and equal the final decode's.
    """

    def __init__(self, payload: bytes, complete: bool):
        from .models.vp8 import decoder as V

        self.V = V
        self.payload = payload
        self.st, self.bd = V.parse_frame_header(payload)
        self.parts = [BoolDecoder(b) for b in self.st.partition_bytes]
        self.parts_complete = self._parts_complete(payload, complete)
        self.mbs = [
            [V.MBData() for _ in range(self.st.mb_w)]
            for _ in range(self.st.mb_h)
        ]
        self.ctx_above = [[0, 0] for _ in range(self.st.mb_w)]
        self.intra_t = np.full(4 * self.st.mb_w, 0, np.int32)
        self.rows_done = 0
        self._reset_row_cursor()

    def update_data(self, payload: bytes, complete: bool) -> None:
        """More bytes arrived: extend the partition buffers in place."""
        if len(payload) <= len(self.payload):
            return
        self.payload = payload
        st, bd = self.V.parse_frame_header(payload)
        # Graft the longer buffers onto the live decoder states.  An
        # incomplete partition whose state holds bytes read past its end
        # (only its initial state can: no MB commits on such bytes)
        # starts over on the longer buffer.
        self.bd.data = bd.data
        for k, new in enumerate(st.partition_bytes):
            part = self.parts[k]
            if not self.parts_complete[k] and part.pos > len(part.data):
                self.parts[k] = BoolDecoder(new)
            else:
                part.data = new
        self.st.partition_bytes = st.partition_bytes
        self.parts_complete = self._parts_complete(payload, complete)

    def _parts_complete(self, payload: bytes, complete: bool) -> list:
        """Per token partition: have all of its bytes arrived?  Each size
        but the last is in the partition table; the last partition ends
        with the chunk (``complete``)."""
        part0_len = (payload[0] | (payload[1] << 8) | (payload[2] << 16)) >> 5
        table = payload[10 + part0_len:]
        sizes = [len(b) for b in self.st.partition_bytes]
        return [sizes[p] == int.from_bytes(table[3 * p:3 * p + 3], "little")
                for p in range(len(sizes) - 1)] + [complete]

    def _reset_row_cursor(self) -> None:
        """Per-row MB-granular progress: both passes resume mid-row."""
        self._modes_x = 0
        self._resid_x = 0
        self._intra_l = np.full(4, 0, np.int32)
        self._ctx_left = [0, 0]

    def decode_available_rows(self) -> None:
        st = self.st
        while self.rows_done < st.mb_h:
            if not self._decode_row_incremental(self.rows_done):
                return                  # starved mid-row; cursor kept
            self.rows_done += 1
            self._reset_row_cursor()

    def _decode_row_incremental(self, mb_y: int) -> bool:
        """Advance the row's two passes MB by MB; True when complete.

        Each macroblock saves the minimal context (boolean-decoder
        state + the nz/intra context it mutates) before decoding, so a
        mid-row starvation discards only the unfinished MB, not the row.
        """
        V = self.V
        st = self.st
        p = mb_y & (len(self.parts) - 1)
        token_bd = self.parts[p]
        row = self.mbs[mb_y]
        while self._modes_x < st.mb_w:
            mb_x = self._modes_x
            mb = row[mb_x]
            sl = self.intra_t[4 * mb_x : 4 * mb_x + 4]
            saved = (_bd_state(self.bd), sl.copy(), self._intra_l.copy())
            try:
                (mb.segment, mb.skip, mb.is_i4, mb.imodes, mb.uvmode) = \
                    V._parse_intra_mode(self.bd, st, sl, self._intra_l)
                if self.bd.exhausted():
                    raise NotEnoughData("partition 0 starved")
            except (BitstreamError, NotEnoughData):
                _bd_restore(self.bd, saved[0])
                sl[:] = saved[1]
                self._intra_l = saved[2]
                return False
            self._modes_x += 1
        while self._resid_x < st.mb_w:
            mb_x = self._resid_x
            mb = row[mb_x]
            saved = (_bd_state(token_bd), list(self.ctx_above[mb_x]),
                     list(self._ctx_left))
            try:
                skip = mb.skip if st.use_skip_proba else 0
                if not skip:
                    empty = V._parse_residuals(
                        token_bd, st, mb, self.ctx_above[mb_x],
                        self._ctx_left
                    )
                    mb.skip = int(empty)
                else:
                    self.ctx_above[mb_x][0] = 0
                    self._ctx_left[0] = 0
                    if not mb.is_i4:
                        self.ctx_above[mb_x][1] = 0
                        self._ctx_left[1] = 0
                    mb.coeffs = np.zeros((25, 16), np.int32)
                    mb.non_zero_y = 0
                    mb.non_zero_uv = 0
                    mb.skip = 1
                if token_bd.exhausted() or (
                        not self.parts_complete[p]
                        and token_bd.pos > len(token_bd.data)):
                    raise NotEnoughData("token partition starved")
            except (BitstreamError, NotEnoughData):
                _bd_restore(token_bd, saved[0])
                self.ctx_above[mb_x][:] = saved[1]
                self._ctx_left[:] = saved[2]
                return False
            self._resid_x += 1
        return True

    def partial_rgba(self, n_rows: int, dev) -> np.ndarray:
        """Reconstruct + filter + convert the finished MB rows on ``dev``
        (the decode's upload, recon_filter_mb and fancy yuv420_to_rgba),
        cropped to the first ``n_rows`` rows; alpha 255."""
        from .decode import _upload
        from .ops.kernels.yuv420_to_rgba import yuv420_to_rgba
        from .ops.vp8_recon import recon_frame

        st = copy.copy(self.st)
        st.mb_h = self.rows_done
        coeffs, modes = self.V.mb_symbols(
            [mb for row in self.mbs[:st.mb_h] for mb in row])
        fp = self.V.vp8_filter_params(st, modes)
        dc, dm, dfp, _ = _upload([(0, st, coeffs, modes, fp, None)], dev)
        Y, U, V = recon_frame(
            dc, dm[:, :, 0], dm[:, :, 5:21], dm[:, :, 1],
            dfp.reshape(1, st.mb_h, st.mb_w, 4), mb_w=st.mb_w, mb_h=st.mb_h,
            filter_type=st.filter_type)
        # Upsample over the whole reconstructed height so the chroma rows
        # bordering the emitted region interpolate as in a full decode,
        # then crop to the finalized rows.
        h_full = min(st.height, 16 * st.mb_h)
        rgba = yuv420_to_rgba(Y, U, V, h_full, st.width)
        return rgba[0, :min(n_rows, st.height)].cpu().numpy()


class _VP8LRowDecoder:
    """Incremental VP8L: suspend/resume over a growing chunk payload
    (the checkpointing loop is models/vp8l/decoder.VP8LIncrementalPixels)."""

    def __init__(self, payload: bytes):
        from .entropy.bitio import BitReader
        from .models.vp8l.decoder import (VP8LIncrementalPixels,
                                          _parse_stream_header,
                                          decode_vp8l_header)

        self.payload = payload
        self.width, self.height, _ = decode_vp8l_header(payload)
        br = BitReader(payload[1:])
        br.skip_bits(14 + 14 + 1 + 3)
        hdr = _parse_stream_header(br, self.width, self.height,
                                   top_level=True)
        if br.eos:
            raise NotEnoughData("VP8L entropy headers incomplete")
        self._pix = VP8LIncrementalPixels(self.width, self.height, hdr,
                                          br.bit_pos)
        self._done = False

    def decode_available_rows(self) -> None:
        if not self._done:
            self._done = self._pix.resume(self.payload[1:])

    @property
    def rows_done(self) -> int:
        return self._pix.rows_ready()

    def partial_rgba(self, n_rows: int) -> np.ndarray:
        from .models.vp8l.decoder import _apply_inverse_transforms

        argb = self._pix.partial_argb()
        if argb.shape[0] == 0:
            return np.zeros((0, self.width, 4), np.uint8)
        argb = _apply_inverse_transforms(argb, self._pix.transforms)[:n_rows]
        return np.stack([(argb >> s) & 0xFF for s in (16, 8, 0, 24)],
                        axis=-1).astype(np.uint8)


__all__ = ["IncrementalDecoder", "STATE_DATA", "STATE_DONE", "STATE_HEADER"]
