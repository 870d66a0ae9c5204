"""Lazy count-table handle: Counter-style reads without materialization.

The reference's dedup result is a dict whose consumers mostly LOOK AT it -
lookups, values(), most-common listings (reference counter.pyx:41-54 and the
profiling harness's sorted(c.values()) parity check,
tests/unit_tests_profiling.py:136).  Materializing 10 M Python objects to
answer `--top 20` is pure waste, and on the device engine it used to
dominate end-to-end time (docs/PERF.md: ~5 s d2h of a 168 MB unique table
plus ~6 s of object construction for a 10 M-read count).

CountTable keeps the deduplicated table where the engine produced it - as
device arrays (live-prefix contract from count.device.unique_count) or host
numpy arrays (compact, from io.native.host_count_native) - one table per
width bucket, each at its OWN lane width (narrow buckets never ship
max-width padding), and answers:

  len(t)            number of unique sequences (one scalar fetch per bucket)
  t.total()         total read count (device-side sum, scalar fetch)
  t.most_common(n)  top-n by count: device lax.top_k -> fetch n rows ->
                    materialize n objects (not the whole table)
  key in t / t[key] pack the query on host, one fused device comparison
                    scan per matching bucket (O(rows) vector work, scalar
                    fetch)
  t.to_counter()    full reference-identical ShortSeqCounter (the old
                    eager behavior, now opt-in)

Unlike the dict, ordering of ties in most_common is deterministic by
(count desc, then key asc) rather than insertion order, and lookups are
sequence-keyed (ShortSeq / str / bytes all name the same key).
"""

from __future__ import annotations

from functools import partial

import numpy as np


class _Bucket:
    """One width-class table.  Device buckets hold padded arrays with the
    live-prefix contract (rows [0, n_unique) live, padding after); host
    buckets hold compact arrays."""

    __slots__ = ("words", "lengths", "counts", "_n", "device")

    def __init__(self, words, lengths, counts, n_unique, device: bool):
        self.words = words
        self.lengths = lengths
        self.counts = counts
        self._n = n_unique  # int for host; device scalar until first read
        self.device = device

    @property
    def n_unique(self) -> int:
        if not isinstance(self._n, int):
            import jax

            self._n = int(jax.device_get(self._n))
        return self._n

    @property
    def width(self) -> int:
        return self.words.shape[1]


def _pairs_from_rows(w, lens, cnts):
    """Host table rows -> [(ShortSeq, int), ...] (n objects, not the
    whole table)."""
    from .. import api
    from .device import _rows_to_table

    return [(api.from_blocks(blocks, length), count)
            for (length, blocks), count in _rows_to_table(w, lens, cnts)]


def _topk_rows_jit():
    import jax

    @partial(jax.jit, static_argnames=("k",))
    def _topk_rows(words, lengths, counts, k: int):
        import jax.numpy as jnp

        v, idx = jax.lax.top_k(counts, k)
        # min over ALL counts, not just the selected k: a poisoned
        # (int32-wrapped, -1) entry is by definition the LARGEST true
        # count, and top_k selects by signed value so it would never
        # surface - the caller must raise, not silently return a top
        # list missing the most frequent key.
        return words[idx], lengths[idx], v, jnp.min(counts)

    return _topk_rows


def _lookup_jit():
    import jax
    import jax.numpy as jnp

    @jax.jit
    def _lookup(words, lengths, counts, q_words, q_len):
        hit = (lengths == q_len) & jnp.all(words == q_words[None, :], axis=1)
        return jnp.sum(jnp.where(hit, counts, 0))

    return _lookup


def _total_jit():
    import jax
    import jax.numpy as jnp

    @jax.jit
    def _total(counts):
        # Padding rows carry count 0 (unique_count normalizes them), so a
        # straight sum is exact.  Device ints are 32-bit (x64 off); a
        # total past 2^31 wraps, so detect it with the same float32
        # shadow-sum trick as unique_count and poison to -1 (the host
        # raises); the 2^30 margin holds in any summation order, so the
        # GPU's unordered reduction changes nothing.  An entry already
        # poisoned upstream (-1 from unique_count's per-group wrap
        # detection) must also poison the total - it appears identically
        # in sum and shadow, so the shadow comparison alone would miss
        # it.
        s = jnp.sum(counts)
        shadow = jnp.sum(counts.astype(jnp.float32))
        wrapped = jnp.abs(shadow - s.astype(jnp.float32)) > jnp.float32(2**30)
        return jnp.where(wrapped | (jnp.min(counts) < 0), jnp.int32(-1), s)

    return _total


_TOPK = None
_LOOKUP = None
_TOTAL = None


def _topk():
    global _TOPK
    if _TOPK is None:
        _TOPK = _topk_rows_jit()
    return _TOPK


def _lookup():
    global _LOOKUP
    if _LOOKUP is None:
        _LOOKUP = _lookup_jit()
    return _LOOKUP


def _total():
    global _TOTAL
    if _TOTAL is None:
        _TOTAL = _total_jit()
    return _TOTAL


def _key_to_rows(key):
    """A lookup key (ShortSeq / str / bytes) -> (length, lanes list) in the
    repo's uint32 lane layout, or None for non-sequence types."""
    from .. import api
    from ..oracle import blocks_to_lanes, encode_bytes

    b = None
    if isinstance(key, str):
        b = key.encode("ascii", "replace")
    elif isinstance(key, (bytes, bytearray)):
        b = bytes(key)
    elif isinstance(key, (api.ShortSeq64, api.ShortSeq192, api.ShortSeqVar)):
        b = str(key).encode("ascii")
    if b is None:
        return None
    try:
        blocks = encode_bytes(b)
    except Exception:
        return None  # invalid bases can never be table keys
    return len(b), blocks_to_lanes(blocks, 2 * max(1, len(blocks)))


class CountTable:
    """Lazy, bucketed count table (see module docstring).  Build with the
    engine helpers (api.counter.read_and_count_fastq_table) or from_merged
    for distributed results."""

    def __init__(self, buckets):
        self._buckets = list(buckets)

    # -- construction -------------------------------------------------

    @classmethod
    def from_device_tables(cls, tables):
        """tables: iterable of unique_count results (padded live-prefix
        device arrays)."""
        return cls(_Bucket(w, l, c, n, device=True)
                   for w, l, c, n in tables)

    @classmethod
    def from_host_tables(cls, tables):
        """tables: iterable of compact host (words, lengths, counts)."""
        return cls(_Bucket(np.asarray(w), np.asarray(l), np.asarray(c),
                           len(np.asarray(l)), device=False)
                   for w, l, c in tables)

    @classmethod
    def from_merged(cls, table):
        """A merged distributed table (ShardedCountTable or plain 4-tuple,
        any layout) -> single-bucket CountTable on host arrays."""
        from ..dist.pipeline import _table_to_host

        w, l, c = _table_to_host(table)
        return cls.from_host_tables([(w, l, c)])

    # -- cheap reads ---------------------------------------------------

    def __len__(self) -> int:
        return sum(b.n_unique for b in self._buckets)

    def total(self) -> int:
        """Total read count (sum of all counts) without materialization."""
        import jax

        total = 0
        for b in self._buckets:
            if b.device:
                s = int(jax.device_get(_total()(b.counts)))
                if s < 0:
                    raise OverflowError(
                        "count total exceeded int32; use to_counter()")
                total += s
            else:
                cnts = np.asarray(b.counts, np.int64)
                if cnts.size and int(cnts.min()) < 0:
                    raise OverflowError(
                        "count table entry exceeded int32; use smaller "
                        "merges")
                total += int(cnts.sum())
        return total

    def most_common(self, n: int | None = None):
        """Top-n (ShortSeq, count) pairs by count desc (ties: key asc).
        Fetches and materializes only n rows per bucket; n=None returns
        the full table sorted.

        Tie handling: the returned list is ordered (count desc, key asc)
        deterministically, but WHICH members of a tie at the n-th-count
        boundary surface depends on the engine's table order (host hash
        order vs device sort order) - the same freedom the reference's
        Counter.most_common has with insertion order.  Entries with
        counts strictly above the boundary are always identical across
        engines."""
        import jax

        rows = []  # (count, length, blocks-key, w_row, l_val)
        for b in self._buckets:
            live = b.n_unique
            if live == 0:
                continue
            if n is None or not b.device:
                if b.device:
                    from .device import fetch_table

                    w, lens, cnts, _ = fetch_table(b.words, b.lengths,
                                                   b.counts, b._n)
                else:
                    w, lens, cnts = (np.asarray(b.words)[:live],
                                     np.asarray(b.lengths)[:live],
                                     np.asarray(b.counts)[:live])
                if len(cnts) and int(np.asarray(cnts).min()) < 0:
                    # Check BEFORE top-n selection: the partition would
                    # drop a poisoned (-1) row - the table's true maximum.
                    raise OverflowError(
                        "count table entry exceeded int32; merge in "
                        "smaller pieces")
                if n is not None and n < len(cnts):
                    # host top-n: argpartition, no full sort of 10M rows
                    part = np.argpartition(-cnts, n - 1)[:n]
                    w, lens, cnts = w[part], lens[part], cnts[part]
            else:
                # device top-k at a pow2-bucketed k (compile-cache reuse)
                k = min(b.words.shape[0],
                        max(16, 1 << max(n - 1, 0).bit_length()))
                w, lens, cnts, min_count = jax.device_get(
                    _topk()(b.words, b.lengths, b.counts, k))
                if int(min_count) < 0:
                    # A poisoned (-1) entry is the table's true maximum;
                    # top_k would silently omit it (see _topk_rows_jit).
                    raise OverflowError(
                        "count table entry exceeded int32; merge in "
                        "smaller pieces")
                w, lens, cnts = (np.asarray(w)[:n], np.asarray(lens)[:n],
                                 np.asarray(cnts)[:n])
                keep = cnts > 0  # k > live rows pulls in zero-count padding
                w, lens, cnts = w[keep], lens[keep], cnts[keep]
            # (both branches above already raised on any poisoned count)
            rows.extend(_pairs_from_rows(w, lens, cnts))
        # count desc, then key asc (length, then decoded order = block
        # tuple order is NOT string order, so compare by the string)
        rows.sort(key=lambda kv: (-kv[1], str(kv[0])))
        return rows if n is None else rows[:n]

    def values(self):
        """All live counts as a host numpy int64 array (order
        unspecified).  The reference's dedup-parity oracle compares
        `sorted(counter.values())` (tests/unit_tests_profiling.py:136);
        this answers it without materializing a single key object.
        Raises on poisoned (int32-wrapped) entries like every other read.
        """
        import jax

        out = []
        for b in self._buckets:
            n = b.n_unique
            if n == 0:
                continue
            if n > b.counts.shape[0]:
                # Same n_out-overflow contract as fetch_table: an
                # undersized table silently truncating the multiset would
                # pass the parity oracle against the wrong answer.
                raise ValueError(
                    f"count table overflow: {n} unique keys but only "
                    f"{b.counts.shape[0]} output rows (n_out too small)")
            if b.device:
                # counts-only prefix fetch: 4 B/key over the link instead
                # of fetch_table's full 4+4*W B/key rows.  The static
                # slice size is pow2-bucketed like fetch_table's so the
                # slice program comes from a closed shape set (plain lax
                # op, cached per shape - a fresh jit(lambda) would miss
                # the in-memory compile cache on every call).
                c = min(b.counts.shape[0],
                        max(256, 1 << max(n - 1, 0).bit_length()))
                cnts = np.asarray(jax.device_get(
                    jax.lax.slice_in_dim(b.counts, 0, c)))[:n]
            else:
                cnts = np.asarray(b.counts)[:n]
            cnts = np.asarray(cnts, np.int64)
            if cnts.size and int(cnts.min()) < 0:
                raise OverflowError(
                    "count table entry exceeded int32; merge in smaller "
                    "pieces")
            out.append(cnts)
        return (np.concatenate(out) if out
                else np.zeros(0, np.int64))

    # -- lookups --------------------------------------------------------

    def get(self, key, default=0):
        import jax
        import jax.numpy as jnp

        q = _key_to_rows(key)
        if q is None:
            return default
        q_len, lanes = q
        total = 0
        found = False
        for b in self._buckets:
            if b.n_unique == 0:
                continue
            width = b.width
            if q_len > 16 * width:
                continue  # key cannot fit this bucket's lanes
            q_words = np.zeros(width, np.uint32)
            q_words[:min(len(lanes), width)] = lanes[:width]
            if any(int(x) for x in lanes[width:]):
                continue  # key has live lanes beyond this bucket's width
            if b.device:
                c = int(jax.device_get(_lookup()(
                    b.words, b.lengths, b.counts,
                    jnp.asarray(q_words), jnp.int32(q_len))))
            else:
                hit = (np.asarray(b.lengths) == q_len) & (
                    np.asarray(b.words) == q_words[None, :]).all(axis=1)
                c = int(np.asarray(b.counts)[hit].sum())
            if c < 0:
                raise OverflowError(
                    "count table entry exceeded int32; merge in smaller "
                    "pieces")
            if c:
                total += c
                found = True
        return total if found else default

    def __contains__(self, key) -> bool:
        return self.get(key, None) is not None

    def __getitem__(self, key) -> int:
        c = self.get(key, None)
        if c is None:
            raise KeyError(key)
        return c

    # -- materialization -------------------------------------------------

    def to_counter(self):
        """Full reference-identical ShortSeqCounter (materializes every
        unique sequence as a Python object - the expensive path this
        class exists to avoid for partial reads)."""
        from ..api.counter import (ShortSeqCounter,
                                   update_counter_from_host_table)
        from .device import fetch_table

        out = ShortSeqCounter()
        for b in self._buckets:
            if b.device:
                w, lens, cnts, _ = fetch_table(b.words, b.lengths, b.counts,
                                               b._n)
            else:
                live = b.n_unique
                w, lens, cnts = (np.asarray(b.words)[:live],
                                 np.asarray(b.lengths)[:live],
                                 np.asarray(b.counts)[:live])
            update_counter_from_host_table(out, w, lens, cnts)
        return out
