"""Sharded dedup: per-shard sort-unique count + collective merge.

The sharded replacement for the reference's single hash table
(reference counter.pyx:41-54).  Each device counts its shard locally
(dense sort-unique, count/device.py), then the shards' padded count tables
are `all_gather`ed over the `data` axis and reduced with one more
unique_count - exact because counting is associative.  The gather moves
only the deduplicated tables (typically << reads) between devices.

All shapes are static: a shard of N reads yields a table padded to N rows;
the merged table is padded to N * n_devices rows.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..count.device import PAD_LENGTH, unique_count
from ..ops.bitpack import pack_words, validate


class ShardedCountTable(NamedTuple):
    """A merged count table plus the layout contract its consumers need.

    layout:
      "prefix"    - live rows form a contiguous [0, n_unique) prefix and
                    the arrays are replicated (count_sharded's contract);
                    safe for fetch_table/counts_to_host.
      "scattered" - live rows are PAD-interleaved and the arrays may be
                    device-SHARDED over the mesh (count_sharded_bucketed
                    replicate=False); materialize with
                    dist.pipeline.table_to_host_rows / table_to_counter,
                    which handle multi-controller fetches.
    """

    words: jax.Array
    lengths: jax.Array
    counts: jax.Array
    n_unique: jax.Array
    layout: str


def _local_count_and_merge(words, lengths, weights):
    """shard_map body: local unique -> all_gather tables -> re-unique."""
    from ..utils.profiling import named_scope

    u_words, u_lengths, u_counts, _ = unique_count(words, lengths, weights)
    with named_scope("ssq.merge_allgather"):
        g_words = jax.lax.all_gather(u_words, "data", tiled=True)
        g_lengths = jax.lax.all_gather(u_lengths, "data", tiled=True)
        g_counts = jax.lax.all_gather(u_counts, "data", tiled=True)
    return unique_count(g_words, g_lengths, g_counts)


def count_sharded(mesh: Mesh):
    """Build a jitted sharded counter: `[N, W]`/`[N]` (N divisible by mesh
    size) -> replicated (u_words, u_lengths, u_counts, n_unique)."""
    mapped = shard_map(
        _local_count_and_merge,
        mesh=mesh,
        in_specs=(P("data"), P("data"), P("data")),
        out_specs=(P(), P(), P(), P()),
        check_vma=False,
    )
    return jax.jit(mapped)


def _bucket_hash(words, lengths, n_buckets):
    """Cheap uniform bucket id per row from the packed key.  Fibonacci
    multiplicative hash over the XOR of lanes + length, then a
    multiply-shift range map on the TOP 16 bits: bucket = (h>>16)*D >> 16.

    Why not `(top bits) % D`: for non-power-of-two D the top
    bit_length(D-1) bits span [0, 2^b) with 2^b > D, so the values that
    wrap (e.g. 6, 7 for D = 6) alias onto buckets 0, 1 and those buckets
    get exactly 2x the expected load - CPU meshes and some device
    counts are not powers of two.  The multiply-shift map partitions the
    16-bit hash space into D equal-width ranges (max imbalance 1 part in
    65536/D, < 0.1% for any mesh <= 64 devices), and a multiplicative
    hash concentrates its entropy in the high bits, which are exactly the
    bits this map consumes.  All arithmetic stays in uint32 (no x64
    requirement): (h >> 16) < 2^16 and D <= 2^16 keep the product exact.
    """
    if not (0 < n_buckets <= 1 << 16):
        raise ValueError(f"n_buckets must be in [1, 65536], got {n_buckets}")
    h = lengths.astype(jnp.uint32)
    for j in range(words.shape[1]):
        h = h ^ words[:, j]
    h = h * jnp.uint32(2654435761)
    return ((h >> jnp.uint32(16)) * jnp.uint32(n_buckets)) >> jnp.uint32(16)


def count_sharded_bucketed(mesh: Mesh, capacity_factor: float = 2.0,
                           replicate: bool = True,
                           pre_dedup: bool = False):
    """Scalable sharded counter: instead of replicating every shard's table
    on every device (all_gather + re-sort of N*D rows per device,
    count_sharded above), keys are exchanged by hash bucket with
    all_to_all so each device dedups a DISJOINT key range - per-device
    merge work stays O(N/D log N/D) regardless of device count.

    Rows are routed to bucket h(key) % D with per-destination capacity
    ceil(N/D * capacity_factor); an overflow flag is returned (True means
    a pathological key skew exceeded capacity and the caller must fall
    back to count_sharded, which is always exact).

    Returns a jitted fn: (words [N, W], lengths [N], weights [N]) ->
    (u_words, u_lengths, u_counts, n_unique, overflowed).

    pre_dedup=True runs a LOCAL unique_count before the exchange, so
    duplicate keys collapse into one weighted row per device.  On benign
    data this only adds a sort (measured -35% at D=1, the NOTE below), so
    the fast path skips it - but it is the right FIRST fallback when the
    raw exchange overflows on a duplicate-heavy batch (one dominant
    sequence - adapter dimers - is a real FASTQ shape, not an attack):
    the dominant key becomes <= 1 row per device and the exchange fits,
    keeping per-device cost flat in D instead of count_sharded's
    all_gather re-sort of N*D rows.  Only distinct-key hash skew can
    still overflow it.

    With replicate=True the deduplicated disjoint tables are all_gathered
    once at the end for a replicated result whose live rows are compacted
    to a prefix (one single-key stable sort on the pad flag - far cheaper
    than a re-unique - so the result obeys the same prefix contract as
    count_sharded and is safe for counts_to_host/fetch_table; traffic
    grows with total uniques).  With
    replicate=False the table stays SHARDED over the mesh (device d holds
    bucket d's uniques; rows are PAD-interleaved, materialize with
    counts_to_host_scattered) - per-device time and memory are then flat
    in device count, which is the production configuration for large
    meshes (n_unique and the overflow flag are still replicated scalars).
    """
    n_dev = mesh.devices.size

    def body(words, lengths, weights):
        n, w = words.shape
        if pre_dedup:
            # Collapse local duplicates into weighted rows (shapes are
            # unchanged: the table stays padded to n with PAD_LENGTH
            # rows, which the exchange below already drops).
            words, lengths, weights, _ = unique_count(
                words, lengths, weights)
        # NOTE: deduplicating locally before the exchange looks like it
        # should shrink traffic, but with static shapes it cannot - the
        # all_to_all buffers and the post-exchange sort are sized by the
        # static capacity either way, so a pre-dedup only adds a sort
        # (measured: -35% at D=1 on the CPU mesh).  Raw rows go straight
        # to their buckets.
        # Mean load is n/D; the factor covers hash skew at scale and the
        # +16 constant covers small-shard balls-in-bins variance (expected
        # max load of m balls in D bins is m/D + O(sqrt(m/D log D))).
        cap = min(n, int(np.ceil(n / n_dev * capacity_factor)) + 16)
        bucket = _bucket_hash(words, lengths, n_dev)
        # Padding rows (PAD_LENGTH sentinel, e.g. from power-of-two batch
        # padding) are dropped before the exchange: they must not consume
        # bucket capacity or trip the overflow flag.  Assign them a
        # virtual bucket D so they sort after every live row.
        live = lengths != PAD_LENGTH
        bucket = jnp.where(live, bucket, jnp.uint32(n_dev))

        # Stable sort rows by destination bucket, then slot rows into a
        # [D, cap, ...] send buffer; row r of its bucket goes to slot r.
        order = jnp.argsort(bucket, stable=True)
        s_bucket = bucket[order]
        s_words = words[order]
        s_lengths = lengths[order]
        s_weights = weights[order]
        s_live = s_bucket < n_dev
        # rank within bucket = position - first position of that bucket
        pos = jnp.arange(n)
        first = jnp.searchsorted(s_bucket, jnp.arange(n_dev, dtype=s_bucket.dtype))
        rank = pos - first[jnp.minimum(s_bucket, n_dev - 1)]
        overflow = jnp.any(s_live & (rank >= cap))
        # Overflow and pad rows scatter out of bounds and are dropped (on
        # overflow the flag tells the caller to discard the whole result).
        dest = jnp.where(s_live & (rank < cap),
                         s_bucket.astype(jnp.int32) * cap + rank,
                         n_dev * cap)

        send_words = jnp.zeros((n_dev * cap, w), jnp.uint32).at[dest].set(
            s_words, mode="drop")
        send_lengths = jnp.full(
            (n_dev * cap,), PAD_LENGTH, jnp.int32).at[dest].set(
            s_lengths, mode="drop")
        send_weights = jnp.zeros((n_dev * cap,), jnp.int32).at[dest].set(
            s_weights, mode="drop")

        # all_to_all: device d receives every device's bucket-d slab.
        def a2a(x):
            parts = x.reshape(n_dev, cap, *x.shape[1:])
            return jax.lax.all_to_all(
                parts, "data", split_axis=0, concat_axis=0, tiled=False
            ).reshape(n_dev * cap, *x.shape[1:])

        from ..utils.profiling import named_scope

        with named_scope("ssq.bucket_exchange"):
            r_words = a2a(send_words)
            r_lengths = a2a(send_lengths)
            r_weights = a2a(send_weights)

        # Local dedup of this device's disjoint key range.
        u_w, u_l, u_c, n_u = unique_count(r_words, r_lengths, r_weights)

        total = jax.lax.psum(n_u, "data")
        any_overflow = jax.lax.pmax(overflow.astype(jnp.int32), "data")
        if not replicate:
            # Keep the table sharded: device d's slab holds bucket d's
            # uniques.  No collective traffic proportional to the table.
            return u_w, u_l, u_c, total, any_overflow
        # Replicate the (already-disjoint, deduplicated) tables, then
        # compact live rows to a prefix: the gather interleaves each
        # slab's padding, and prefix consumers (counts_to_host,
        # fetch_table, pipeline._table_to_host) slice [:n_unique] - they
        # would silently read slab-0 padding and drop slabs 1+ otherwise.
        g_w = jax.lax.all_gather(u_w, "data", tiled=True)
        g_l = jax.lax.all_gather(u_l, "data", tiled=True)
        g_c = jax.lax.all_gather(u_c, "data", tiled=True)
        perm = jnp.argsort((g_l == PAD_LENGTH).astype(jnp.int32),
                           stable=True)
        return g_w[perm], g_l[perm], g_c[perm], total, any_overflow

    table_spec = P() if replicate else P("data")
    mapped = shard_map(
        body,
        mesh=mesh,
        in_specs=(P("data"), P("data"), P("data")),
        out_specs=(table_spec, table_spec, table_spec, P(), P()),
        check_vma=False,
    )
    return jax.jit(mapped)


def count_sharded_auto(mesh: Mesh, capacity_factor: float = 2.0):
    """The production merge: scalable bucketed exchange first, two exact
    fallback tiers on overflow.

    Tier 1 runs count_sharded_bucketed(replicate=False) - per-device
    merge work and memory flat in device count - then checks the
    replicated overflow flag on the host.  On overflow, tier 2 reruns the
    exchange with a LOCAL pre-dedup (pre_dedup=True): a duplicate-heavy
    batch (one dominant sequence - the adapter-dimer scenario, which real
    FASTQ dedup absolutely produces) collapses to <= 1 row of that key
    per device and fits the buckets, so per-device cost stays flat in D
    instead of paying the all_gather re-sort of N*D rows every batch.
    Only if tier 2 ALSO overflows (distinct-key hash skew: hash flooding
    or adversarial inputs) does tier 3 run the always-exact count_sharded.
    Each flag is replicated, so every process takes the same tier in
    multi-controller runs.

    Returns a callable (words [N, W], lengths [N], weights [N]) ->
    ShardedCountTable; layout is "scattered" from tiers 1-2 (table
    sharded over the mesh) and "prefix" after tier 3 (replicated).
    """
    bucketed = count_sharded_bucketed(mesh, capacity_factor,
                                      replicate=False)
    dedup_first = gather = None

    def run(words, lengths, weights) -> ShardedCountTable:
        nonlocal dedup_first, gather
        u_w, u_l, u_c, n_u, overflow = bucketed(words, lengths, weights)
        if int(jax.device_get(overflow)):
            if dedup_first is None:
                dedup_first = count_sharded_bucketed(
                    mesh, capacity_factor, replicate=False, pre_dedup=True)
            u_w, u_l, u_c, n_u, overflow = dedup_first(
                words, lengths, weights)
        if int(jax.device_get(overflow)):
            if gather is None:
                gather = count_sharded(mesh)
            w2, l2, c2, n2 = gather(words, lengths, weights)
            return ShardedCountTable(w2, l2, c2, n2, "prefix")
        return ShardedCountTable(u_w, u_l, u_c, n_u, "scattered")

    return run


def make_sharded_counter(mesh: Mesh, capacity_factor: float = 2.0):
    """Full device pipeline: ASCII read matrix -> packed words -> validity ->
    sharded count (the distributed form of reference counter.pyx:57-71's
    pipeline).  Returns a callable of (ascii_u8 [N, L], lengths [N]) ->
    (ShardedCountTable, all_ok [N] bool replicated).

    Two compiled programs: a sharded pack+validate (elementwise, no
    collectives beyond the validity gather), then the count_sharded_auto
    merge - bucketed exchange with the overflow fallback, so the per-device
    merge work users actually hit is flat in device count.  The validity
    mask comes back replicated so any host can raise the reference's
    "Unsupported base character" error with the offending read index.
    """
    data = NamedSharding(mesh, P("data"))
    repl = NamedSharding(mesh, P())

    @jax.jit
    def prep(ascii_u8, lengths):
        words = pack_words(ascii_u8)
        ok = validate(ascii_u8, lengths)
        return (jax.lax.with_sharding_constraint(words, data),
                jax.lax.with_sharding_constraint(ok, repl))

    counter = count_sharded_auto(mesh, capacity_factor)

    def step(ascii_u8, lengths):
        ascii_u8 = jax.device_put(jnp.asarray(ascii_u8), data)
        lengths = jax.device_put(jnp.asarray(lengths), data)
        words, ok = prep(ascii_u8, lengths)
        table = counter(words, lengths, jnp.ones(words.shape[0], jnp.int32))
        return table, ok

    return step
