"""PackedBatch - the device-first unit of work.

The reference's unit is one Python object; the device-native unit is a
structure-of-arrays batch (SURVEY.md section 7 decision 1): `[N, W]`
uint32 packed lanes plus `[N]` lengths, living on device.  Everything the
scalar objects do (pack, decode, hamming, slice, count) exists here as a
batched op, which is where the throughput targets are met; the scalar
ShortSeq objects are the ergonomic facade on top.

All ops keep static shapes (width is fixed per batch, rows zero-padded
past their length) so XLA compiles each program once per bucket shape.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .constants import (
    MAX_VAR_NT,
    NT_PER_LANE,
    PAD_BYTE,
    TOO_LONG_MSG,
    UNSUPPORTED_BASE_MSG,
    lanes_for_length,
)


def _ascii_matrix(seqs, width=None):
    """List of str/bytes -> PAD_BYTE-padded uint8 matrix + lengths (the
    pad byte satisfies the device kernel's pad_valid contract - passes
    the bloom, encodes to code 0; constants.PAD_BYTE)."""
    norm = [s.encode("ascii") if isinstance(s, str) else bytes(s)
            for s in seqs]
    max_len = max((len(s) for s in norm), default=0)
    if max_len > MAX_VAR_NT:
        raise Exception(TOO_LONG_MSG)
    if width is None:
        width = max(NT_PER_LANE, -(-max_len // NT_PER_LANE) * NT_PER_LANE)
    if width % NT_PER_LANE:
        raise ValueError(f"width must be a multiple of {NT_PER_LANE}")
    if max_len > width:
        raise ValueError(f"width {width} is too small for a {max_len} nt read")
    mat = np.full((len(norm), width), PAD_BYTE, np.uint8)
    lengths = np.zeros(len(norm), np.int32)
    for i, s in enumerate(norm):
        mat[i, :len(s)] = np.frombuffer(s, np.uint8)
        lengths[i] = len(s)
    return mat, lengths


@partial(jax.jit, static_argnames=("start", "length", "out_width"))
def _trim_words(words, lengths, start, length, out_width):
    """Batched subsequence extraction directly on packed lanes: the true
    funnel shift of the scalar slicing engine (reference
    short_seq.pyx:202-238), batched.  `start` is the same for every row
    (static), so the lane offset and bit shift are compile-time constants
    and the whole op is W_out static slices + shifts + one per-row tail
    mask - ~8x less traffic than the previous unpack-to-ASCII-and-repack
    formulation."""
    n, w = words.shape
    lane0, nt_off = divmod(start, NT_PER_LANE)
    sh = jnp.uint32(2 * nt_off)

    def lane(j):
        src = lane0 + j
        lo = words[:, src] if src < w else jnp.zeros((n,), jnp.uint32)
        if nt_off == 0:
            return lo
        hi = words[:, src + 1] if src + 1 < w else jnp.zeros((n,), jnp.uint32)
        return (lo >> sh) | (hi << jnp.uint32(32 - 2 * nt_off))

    out = jnp.stack([lane(j) for j in range(out_width)], axis=1)
    new_len = jnp.clip(length, 0, jnp.maximum(lengths - start, 0)) \
        .astype(jnp.int32)
    # Per-row tail mask: lane j keeps 2*clip(new_len - 16j, 0, 16) bits.
    lane_pos = jax.lax.broadcasted_iota(jnp.int32, (n, out_width), 1)
    r = jnp.clip(new_len[:, None] - NT_PER_LANE * lane_pos, 0, NT_PER_LANE)
    mask = jnp.where(
        r >= NT_PER_LANE, jnp.uint32(0xFFFFFFFF),
        (jnp.uint32(1) << (2 * r).astype(jnp.uint32)) - jnp.uint32(1))
    return out & mask, new_len


@partial(jax.jit, static_argnames=("out_w",))
def _trim_words_ragged(words, lengths, starts, new_lengths, out_w):
    """Per-row dynamic-start funnel shift: the
    scalar slicing engine (reference short_seq.pyx:94-238) batched with
    PER-ROW start positions - mixed-design UMI/adapter clipping, where
    each read's clip point differs.  The static-start kernel (_trim_words)
    reads lanes at compile-time offsets; here the lane index and bit shift
    are row data, so each output lane is one take_along_axis gather of
    two source lanes plus a variable funnel shift.  Still one fused
    program, O(N * out_w) work."""
    n, w = words.shape
    starts = jnp.maximum(starts.astype(jnp.int32), 0)
    lane0 = starts // NT_PER_LANE
    sh = (2 * (starts % NT_PER_LANE)).astype(jnp.uint32)[:, None]
    src = lane0[:, None] + jnp.arange(out_w, dtype=jnp.int32)[None, :]
    lo = jnp.where(src < w,
                   jnp.take_along_axis(words, jnp.minimum(src, w - 1),
                                       axis=1),
                   jnp.uint32(0))
    hi = jnp.where(src + 1 < w,
                   jnp.take_along_axis(words, jnp.minimum(src + 1, w - 1),
                                       axis=1),
                   jnp.uint32(0))
    # sh == 0 rows select `lo` directly: the unselected (lo >> 0) |
    # (hi << 32) branch's out-of-range shift is discarded by the where.
    shifted = jnp.where(sh == 0, lo,
                        (lo >> sh) | (hi << (jnp.uint32(32) - sh)))
    new_len = jnp.clip(new_lengths.astype(jnp.int32), 0,
                       jnp.maximum(lengths - starts, 0)).astype(jnp.int32)
    # A row cannot keep more nt than the output lanes hold.
    new_len = jnp.minimum(new_len, NT_PER_LANE * out_w)
    lane_pos = jax.lax.broadcasted_iota(jnp.int32, (n, out_w), 1)
    r = jnp.clip(new_len[:, None] - NT_PER_LANE * lane_pos, 0, NT_PER_LANE)
    mask = jnp.where(
        r >= NT_PER_LANE, jnp.uint32(0xFFFFFFFF),
        (jnp.uint32(1) << (2 * r).astype(jnp.uint32)) - jnp.uint32(1))
    return shifted & mask, new_len


@dataclass(frozen=True)
class PackedBatch:
    """[N, W] uint32 packed lanes + [N] int32 lengths (device arrays)."""

    words: jax.Array
    lengths: jax.Array

    # -- construction --------------------------------------------------------

    @classmethod
    def from_seqs(cls, seqs, width: int | None = None) -> "PackedBatch":
        """Pack a list of str/bytes, validating every base on device and
        raising the reference's error (short_seq_64.pyx:105) on failure."""
        from .oracle import first_invalid_char
        from .ops.bitpack import pack_and_validate_rows

        mat, lengths = _ascii_matrix(seqs, width)
        if len(seqs) == 0:
            return cls(jnp.zeros((0, 1), jnp.uint32), jnp.asarray(lengths))
        # pad_valid: _ascii_matrix pads with PAD_BYTE (bloom-passing,
        # code-0), so the kernel skips per-byte length masking (~1.5x).
        words, ok = pack_and_validate_rows(mat.view(np.uint32), lengths,
                                           pad_valid=True)
        ok = np.asarray(ok)
        if not ok.all():
            i = int(np.argmin(ok))
            bad = first_invalid_char(mat[i, :lengths[i]])
            raise Exception(f"{UNSUPPORTED_BASE_MSG}: {bad}")
        return cls(words, jnp.asarray(lengths))

    @classmethod
    def from_matrix(cls, mat, lengths) -> "PackedBatch":
        """Pack an already-padded uint8 ASCII matrix (e.g. straight from
        io.read_fastq_matrix) without validation.  The device receives the
        matrix as its uint32 view (same bytes, no bitcast on device),
        row-folded for full-tile HBM traffic (ops.bitpack.pack_rows)."""
        from .ops.bitpack import pack_rows

        mat = np.ascontiguousarray(mat, np.uint8)
        pad = -mat.shape[1] % 16
        if pad:  # the pack consumes 16-byte lane groups; zero bytes encode
            # to code 0, the reference's zero-filled tail convention
            mat = np.ascontiguousarray(np.pad(mat, ((0, 0), (0, pad))))
        return cls(pack_rows(mat.view(np.uint32)),
                   jnp.asarray(lengths, dtype=jnp.int32))

    # -- shape ---------------------------------------------------------------

    def __len__(self) -> int:
        return self.words.shape[0]

    @property
    def width_lanes(self) -> int:
        return self.words.shape[1]

    def __getitem__(self, item) -> "PackedBatch":
        """Row selection (int/slice/array) -> sub-batch."""
        if isinstance(item, (int, np.integer)):
            index = int(item)
            n = len(self)
            if index < 0:
                index += n
            if index < 0 or index >= n:
                raise IndexError("batch row index out of range")
            item = slice(index, index + 1)
        return PackedBatch(self.words[item], self.lengths[item])

    # -- ops -----------------------------------------------------------------

    def hamming(self, other: "PackedBatch") -> jax.Array:
        """Row-wise hamming distances `[N]`; lengths must match row-wise
        (the batched form of the scalar `^`, reference
        short_seq_64.pyx:77-84)."""
        from .ops.hamming import hamming_rows

        if np.asarray(self.lengths != other.lengths).any():
            from .constants import LENGTH_MISMATCH_MSG

            raise Exception(LENGTH_MISMATCH_MSG)
        return hamming_rows(self.words, other.words)

    def pairwise(self, other: "PackedBatch | None" = None) -> jax.Array:
        """All-pairs hamming `[N, M]` (ops.pairwise_hamming_auto)."""
        from .ops import pairwise_hamming_auto

        other = self if other is None else other
        return pairwise_hamming_auto(self.words, other.words)

    def trim(self, start: int, length: int) -> "PackedBatch":
        """Batched subsequence: rows become seq[start:start+length]
        (clamped per-row), e.g. adapter/UMI clipping."""
        if start < 0 or length < 0:
            raise ValueError("trim start/length must be non-negative")
        out_width = lanes_for_length(min(length, self.width_lanes * 16))
        words, lengths = _trim_words(
            self.words, self.lengths, int(start), int(length),
            max(out_width, 1))
        return PackedBatch(words, lengths)

    def trim_ragged(self, starts, lengths,
                    out_width_lanes: int | None = None) -> "PackedBatch":
        """Batched subsequence with PER-ROW start/length: row i becomes
        seq[starts[i] : starts[i] + lengths[i]] (clamped per row; negative
        starts clamp to 0).  `starts`/`lengths` are [N] arrays or scalars
        (scalars broadcast - the scalar/scalar case is `trim`, which skips
        the gathers).  out_width_lanes bounds the output lane count
        (default: this batch's width; rows keep at most 16 * out_width
        nt)."""
        n = len(self)
        starts = jnp.broadcast_to(jnp.asarray(starts, jnp.int32), (n,))
        lengths = jnp.broadcast_to(jnp.asarray(lengths, jnp.int32), (n,))
        out_w = (self.width_lanes if out_width_lanes is None
                 else int(out_width_lanes))
        if out_w < 1:
            raise ValueError("out_width_lanes must be >= 1")
        words, new_len = _trim_words_ragged(self.words, self.lengths,
                                            starts, lengths, out_w)
        return PackedBatch(words, new_len)

    def counts(self):
        """Exact dedup of this batch -> ShortSeqCounter (device sort-unique,
        count/device.py)."""
        from .count import count_batch
        from .dist.pipeline import table_to_counter

        if len(self) == 0:
            from .api.counter import ShortSeqCounter

            return ShortSeqCounter()
        return table_to_counter(count_batch(self.words, self.lengths))

    # -- materialization -----------------------------------------------------

    def decode(self) -> list:
        """Batched lazy decode -> list of str (device unpack + one host
        transfer; the batched form of str(seq), reference
        short_seq_64.pyx:114-121)."""
        from .ops.bitpack import unpack_ascii

        if len(self) == 0:
            return []
        ascii_mat = np.asarray(unpack_ascii(self.words))
        lengths = np.asarray(self.lengths)
        return [ascii_mat[i, :lengths[i]].tobytes().decode("ascii")
                for i in range(len(lengths))]

    def to_objects(self) -> list:
        """Materialize scalar ShortSeq objects directly from the packed
        words - one native call for the batch when the extension is built,
        no re-encoding either way."""
        from .native_build import load as _load_native

        words = np.ascontiguousarray(np.asarray(self.words), np.uint32)
        lengths = np.ascontiguousarray(np.asarray(self.lengths), np.int32)
        native = _load_native()
        if native is not None and hasattr(native, "seqs_from_rows"):
            return native.seqs_from_rows(words, lengths)
        from .api import from_blocks
        from .count.device import _rows_to_table

        table = _rows_to_table(words, lengths, np.zeros(len(self), np.int32))
        return [from_blocks(blocks, length) for (length, blocks), _ in table]


def pack_batch(seqs, width: int | None = None) -> PackedBatch:
    """Convenience: PackedBatch.from_seqs."""
    return PackedBatch.from_seqs(seqs, width)
