"""Sort-unique-count over packed lane batches.

The reference counts uniques with a CPython dict keyed by prehashed ShortSeq
objects (reference counter.pyx:41-54, util.pxd:63-70).  A hash table is the
wrong shape for XLA: data-dependent probing defeats static-shape
compilation and vectorization.  Instead we use the classic sort-based
grouping, which is all dense vector work:

  1. group equal rows adjacently: narrow rows (<= _LEX_SORT_MAX_LANES
     lanes) by one multi-operand lexicographic `jax.lax.sort` over
     (length, lane_0, ..., lane_{W-1}); wide rows by a 64-bit row-hash
     sort (4 sort operands + one row gather - the comparator cost stays
     flat in W instead of the 65-operand sort the 1024-nt bucket would
     need), exact via a seeded re-hash retry loop on the ~2^-17-rare
     collision between distinct rows (_sort_rows_hash);
  2. segment boundaries: a row starts a new group iff any lane or the
     length differs from the previous row;
  3. per-group sums of the rows' weights via `jax.ops.segment_sum`.

Everything is static-shape: outputs are padded to N rows and accompanied
by an `n_unique` scalar.  Weights make the op associative - merging two
count tables is just concatenation + another unique_count - which is what
the distributed merge in shortseq_tpu.dist relies on.

Padding convention: callers mark dead rows with length PAD_LENGTH (an
impossible sequence length).  Dead rows sort to the end, collapse into at
most one trailing group, and are excluded from `n_unique`.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

# Sorts after every real length (0..1024).  int32 max keeps it impossible.
PAD_LENGTH = jnp.iinfo(jnp.int32).max

# Widest row (in uint32 lanes) that still sorts lexicographically with one
# multi-operand lax.sort; wider rows (the 1024-nt class, 64 lanes) take
# the hash-prefix sort, whose comparator cost stays flat in W.  The
# crossover was chosen on another chip and is not measured on the H100
# (ROADMAP queue 1 items 2 and 4).
_LEX_SORT_MAX_LANES = 6


def _sort_rows_lex(words, lengths, weights):
    """Exact (1 + W)-key lexicographic row sort: equal (length, row) keys
    become adjacent, PAD rows (length PAD_LENGTH, the int32 max, leading
    key) sort last.  Returns (s_lengths [N], s_words [N, W], s_weights)."""
    n, w = words.shape
    operands = (lengths,) + tuple(words[:, j] for j in range(w)) + (weights,)
    sorted_ops = jax.lax.sort(operands, num_keys=1 + w)
    return (sorted_ops[0], jnp.stack(sorted_ops[1:1 + w], axis=1),
            sorted_ops[-1])


def _row_hash(words, lengths, seed):
    """Two independent 32-bit mixes over a row's lanes + length (murmur-
    style multiply/xor-shift rounds + fmix32 finalizer), parameterized by
    a seed so the retry loop in _sort_rows_hash can draw a fresh hash
    family.  Equal rows hash equal by construction; distinct rows collide
    in the combined 64 bits with probability ~N^2 / 2^65 (~2^-17 at
    N = 16M) per family."""
    def fmix(h):
        h = h ^ (h >> 16)
        h = h * jnp.uint32(0x85EBCA6B)
        h = h ^ (h >> 13)
        h = h * jnp.uint32(0xC2B2AE35)
        return h ^ (h >> 16)

    s = seed.astype(jnp.uint32) * jnp.uint32(0x27D4EB2F)
    h1 = (lengths.astype(jnp.uint32) ^ s) * jnp.uint32(0x9E3779B1)
    h2 = (lengths.astype(jnp.uint32) + s + jnp.uint32(0x165667B1)) \
        * jnp.uint32(0x85EBCA77)
    for j in range(words.shape[1]):
        x = words[:, j]
        h1 = (h1 ^ x) * jnp.uint32(0xCC9E2D51)
        h1 = h1 ^ (h1 >> 15)
        h2 = (h2 ^ x) * jnp.uint32(0x1B873593)
        h2 = h2 ^ (h2 >> 13)
    return fmix(h1), fmix(h2)


#: Hash families tried before the wide path declares the input adversarial
#: and poisons the result (counts = -1 -> every materialization raises).
#: Random data re-draws with probability ~2^-17 per family; 8 independent
#: failures is ~2^-136 - unreachable except by inputs crafted against
#: these exact constants, which then get a loud error, never bad counts.
_HASH_MAX_TRIES = 8


def _sort_rows_hash(words, lengths, weights):
    """Row grouping for WIDE rows: sort a 64-bit row hash (+ length + iota
    payload; 4 sort operands regardless of W), then gather the rows
    through the permutation.  Equal rows share a hash, so they land
    contiguous; the epilogue's full-row compare draws the segment
    boundaries.

    The one hazard is two DISTINCT live rows sharing the 64-bit hash:
    interleaved equal keys (A, B, A inside one equal-hash run) would
    split a group.  Runs of equal (h1, h2) are contiguous after the sort,
    so any such pair implies an ADJACENT pair that differs in content but
    not in hash - detected below, and the lax.while_loop simply re-draws
    a fresh seeded hash family until no collision remains (expected
    iterations 1 + 2^-17).  The loop body holds the ONLY sort in the
    program: an earlier design instead fell back to the exact
    lexicographic sort under lax.cond, and carrying two sort programs in
    one conditional multiplied compile time.  PAD rows are
    forced to the maximal hash and carry the maximal length key, so live
    rows still form a prefix.

    Returns (s_lengths, s_words, s_weights, collision); collision is True
    only if every hash family collided (see _HASH_MAX_TRIES - the caller
    poisons the counts so nothing downstream can read a silently
    mis-grouped table)."""
    n = lengths.shape[0]
    live = lengths != PAD_LENGTH
    iota = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)

    def body(state):
        seed = state[0]
        h1, h2 = _row_hash(words, lengths, seed)
        h1 = jnp.where(live, h1, jnp.uint32(0xFFFFFFFF))
        h2 = jnp.where(live, h2, jnp.uint32(0xFFFFFFFF))
        s_h1, s_h2, s_lengths, s_idx = jax.lax.sort(
            (h1, h2, lengths, iota), num_keys=3)
        s_words = jnp.take(words, s_idx, axis=0)
        s_weights = jnp.take(weights, s_idx, axis=0)
        row_differs = (s_lengths[1:] != s_lengths[:-1]) \
            | jnp.any(s_words[1:] != s_words[:-1], axis=1)
        hash_same = (s_h1[1:] == s_h1[:-1]) & (s_h2[1:] == s_h2[:-1])
        both_live = (s_lengths[1:] != PAD_LENGTH) \
            & (s_lengths[:-1] != PAD_LENGTH)
        collision = jnp.any(row_differs & hash_same & both_live)
        return seed + 1, s_lengths, s_words, s_weights, collision

    def cond(state):
        return state[4] & (state[0] < _HASH_MAX_TRIES)

    # collision=True in the init state makes the first body run
    # unconditional; the init arrays are placeholders of the right shape.
    init = (jnp.int32(0), lengths, words, weights, jnp.bool_(True))
    _, s_lengths, s_words, s_weights, collision = jax.lax.while_loop(
        cond, body, init)
    return s_lengths, s_words, s_weights, collision


@partial(jax.jit, static_argnames=("n_out",))
def unique_count(words: jax.Array, lengths: jax.Array, weights: jax.Array,
                 n_out: int | None = None):
    """Group identical (length, words-row) keys and sum their weights.

    Args:
      words:   `[N, W]` uint32 packed lanes (zero-padded past each length).
      lengths: `[N]` int32; PAD_LENGTH marks dead rows (weight ignored via 0).
      weights: `[N]` int32 per-row counts (1 for raw reads; table counts
               when merging).
    Returns:
      (u_words `[M, W]`, u_lengths `[M]`, u_counts `[M]`, n_unique scalar)
      with M = n_out or N; groups are sorted ascending by key; rows at and
      past n_unique are padding (length PAD_LENGTH, count 0).
    """
    n, w = words.shape
    if n_out is None:
        n_out = n
    if n == 0:
        # Degenerate empty batch (e.g. counting an empty file): a 1-row
        # all-pad table keeps every downstream shape rule intact.
        return (jnp.zeros((max(n_out, 1), w), jnp.uint32),
                jnp.full((max(n_out, 1),), PAD_LENGTH, jnp.int32),
                jnp.zeros((max(n_out, 1),), jnp.int32),
                jnp.int32(0))

    from ..utils.profiling import named_scope

    # 1. Group equal rows adjacently.  Narrow rows: one multi-operand
    # lexicographic sort (length leads, so PAD rows group last; lanes
    # compare as uint32).  Wide rows: hash-prefix sort (4 sort operands +
    # a row gather instead of a W+1-operand comparator), exact via the
    # seeded re-hash retry loop in _sort_rows_hash; `exhausted` is True
    # only for inputs crafted to collide in every hash family, and those
    # get poisoned counts below instead of a silently mis-grouped table.
    exhausted = None
    with named_scope("ssq.unique_count"):
        if w <= _LEX_SORT_MAX_LANES:
            s_lengths, s_words, s_weights = _sort_rows_lex(
                words, lengths, weights)
        else:
            s_lengths, s_words, s_weights, exhausted = _sort_rows_hash(
                words, lengths, weights)

        # 2. Segment boundaries: a row starts a group iff it differs from
        # its predecessor in length or any lane.
        is_new = jnp.concatenate([
            jnp.ones((1,), jnp.bool_),
            (s_lengths[1:] != s_lengths[:-1])
            | jnp.any(s_words[1:] != s_words[:-1], axis=1)])
        seg_id = jnp.cumsum(is_new.astype(jnp.int32)) - 1       # [N]

        # 3. Per-group reductions.  All rows of a group carry identical keys,
        # so the duplicate scatter writes below are deterministic.
        live = s_lengths != PAD_LENGTH
        live_weights = jnp.where(live, s_weights, 0)
        # Poison closure: counts re-enter unique_count as WEIGHTS in every
        # device-side merge (chunked ingest, checkpoint merges, the
        # pre-dedup exchange tier, the all_gather merge).  A -1-poisoned
        # count from an upstream table (int32 wrap or hash-family
        # exhaustion) must therefore poison THIS result too - summing it
        # as an ordinary weight would land positive-but-wrong and no
        # materialization would ever raise.
        in_poison = jnp.any(live_weights < 0)
        counts = jax.ops.segment_sum(live_weights, seg_id, num_segments=n_out)
        # int32 wrap detection (device ints are 32-bit; jax_enable_x64 is off).
        # A wrap that lands negative is caught by the host-side min() < 0 check;
        # a wrap that lands positive (3+ large addends, e.g. 3 x 1.9e9 = +1.4e9
        # mod 2^32) is caught by comparing against a float32 shadow sum: any
        # wrap shifts the int32 result by >= 2^32 while float32 accumulation
        # error stays orders of magnitude below the 2^30 threshold - in any
        # summation order, so the GPU's unordered segment_sum changes
        # nothing.  Wrapped groups are poisoned to -1 so every
        # materialization path raises.
        counts_f = jax.ops.segment_sum(
            live_weights.astype(jnp.float32), seg_id, num_segments=n_out)
        wrapped = jnp.abs(counts_f - counts.astype(jnp.float32)) > jnp.float32(2**30)
        counts = jnp.where(wrapped, jnp.int32(-1), counts)
        # Whole-table poison: hash-family exhaustion (adversarial input)
        # or poisoned input weights.  Applied to every LIVE group in the
        # final normalization below - unconditionally, so even a group
        # whose weights cancelled to zero cannot read as clean - making
        # each materialization path raise (the same negative-count
        # tripwire as the per-group int32-wrap detection).
        poison_all = in_poison if exhausted is None \
            else (exhausted | in_poison)
        u_words = jnp.zeros((n_out, w), jnp.uint32).at[seg_id].set(
            s_words, mode="drop")
        u_lengths = jnp.full((n_out,), PAD_LENGTH, jnp.int32).at[seg_id].set(
            s_lengths, mode="drop")

        # PAD rows sort strictly after every live row (lex path: PAD_LENGTH
        # is the int32 max and length is the leading sort key; hash path:
        # PAD rows get the maximal hash and length breaks any tie with a
        # live row that reaches it), so live rows are a prefix.
        # Count the groups of that prefix - robust even when dead rows carry
        # stale words and split into several trailing pad groups.
        live_count = jnp.sum(live.astype(jnp.int32))
        n_unique = jnp.where(
            live_count > 0,
            seg_id[jnp.maximum(live_count - 1, 0)] + 1,
            0).astype(jnp.int32)
        # Normalize the pad group's slot so padding is canonical.
        u_lengths = jnp.where(jnp.arange(n_out) < n_unique, u_lengths, PAD_LENGTH)
        counts = jnp.where(jnp.arange(n_out) < n_unique,
                           jnp.where(poison_all, jnp.int32(-1), counts), 0)
    return u_words, u_lengths, counts, n_unique


@jax.jit
def count_batch(words: jax.Array, lengths: jax.Array):
    """Count a raw read batch: every row weight 1 (the single-shard
    equivalent of reference counter.pyx:31-39)."""
    return unique_count(words, lengths, jnp.ones(words.shape[0], jnp.int32))


@partial(jax.jit, static_argnames=("c",))
def _table_prefix(u_words, u_lengths, u_counts, c: int):
    return (jax.lax.dynamic_slice_in_dim(u_words, 0, c, 0),
            jax.lax.dynamic_slice_in_dim(u_lengths, 0, c, 0),
            jax.lax.dynamic_slice_in_dim(u_counts, 0, c, 0))


def fetch_table(u_words, u_lengths, u_counts, n_unique):
    """Fetch only the live prefix of a device count table to host.

    A count table is padded to its input size, but after dedup only
    `n_unique` rows are live; fetching the whole padding wastes
    device->host bandwidth.  Two round trips: the n_unique scalar, then a
    prefix slice whose static size is n_unique rounded up to a power of
    two (>=256) so the slice program compiles once per size bucket, not
    per value.

    Returns host numpy arrays (words [n, W], lengths [n], counts [n], n).
    """
    n = int(jax.device_get(n_unique))
    total = u_words.shape[0]
    if n > total:
        raise ValueError(
            f"count table overflow: {n} unique keys but only {total} "
            f"output rows (n_out too small)")
    c = min(total, max(256, 1 << max(n - 1, 0).bit_length()))
    import numpy as np

    w, lens, cnts = jax.device_get(
        _table_prefix(u_words, u_lengths, u_counts, c))
    return (np.asarray(w)[:n], np.asarray(lens)[:n],
            np.asarray(cnts)[:n], n)


def counts_to_host_scattered(u_words, u_lengths, u_counts):
    """Like counts_to_host for tables whose live rows are NOT contiguous
    (e.g. the bucketed-exchange merge gathers per-device compact tables
    with padding between segments): filters by the PAD_LENGTH sentinel
    instead of slicing a prefix."""
    import jax
    import numpy as np

    u_words, u_lengths, u_counts = jax.device_get(
        (u_words, u_lengths, u_counts))  # one round trip, not three
    lens = np.asarray(u_lengths)
    live = np.flatnonzero(lens != int(PAD_LENGTH))
    return _rows_to_table(np.asarray(u_words)[live], lens[live],
                          np.asarray(u_counts)[live])


def counts_to_host(u_words, u_lengths, u_counts, n_unique):
    """Device count table -> list of ((length, blocks tuple), count) on host.

    Blocks are reference uint64 values (lane pair 2b, 2b+1 fused), ready for
    the Counter materialization in api.counter.  Only the live prefix is
    transferred (fetch_table); a caller-supplied n_out smaller than the true
    unique count raises instead of silently dropping keys (unique_count's
    scatters use mode="drop").
    """
    w, lens, cnts, _n = fetch_table(u_words, u_lengths, u_counts, n_unique)
    return _rows_to_table(w, lens, cnts)


def _rows_to_table(w, lens, cnts):
    import numpy as np

    # Device counts are int32 (jax_enable_x64 is off); a single table row
    # overflowing it would wrap negative - detect instead of silently
    # corrupting (the reference's Python ints are unbounded).  Hitting this
    # requires >2^31 occurrences of one sequence within one merge tree;
    # split the merge into sub-merges materialized to host (Python ints)
    # if a dataset ever does.
    cnts = np.asarray(cnts)
    if len(cnts) and int(cnts.min()) < 0:
        raise OverflowError(
            "count table entry exceeded int32; merge in smaller pieces")
    w = w.astype(np.uint64)
    if w.shape[1] % 2:  # odd lane count: pad to a full 64-bit block
        w = np.pad(w, ((0, 0), (0, 1)))
    blocks64 = w[:, 0::2] | (w[:, 1::2] << np.uint64(32))
    out = []
    for i in range(len(lens)):
        length = int(lens[i])
        nblocks = max(1, -(-length // 32))
        out.append(((length, tuple(int(b) for b in blocks64[i, :nblocks])),
                    int(cnts[i])))
    return out
