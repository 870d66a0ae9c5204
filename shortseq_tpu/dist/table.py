"""Lazy reads over a mesh-SHARDED count table.

count.table.CountTable gives single-device tables Counter-style reads
without materialization; this is the same contract for the production
distributed merge's output (count_sharded_auto, layout="scattered":
device d holds hash-bucket d's uniques, rows PAD-interleaved).  Without
it, a multi-host `top 20` would pull the ENTIRE sharded table to every
host (table_to_host_rows) just to discard all but 20 rows.

All reads run as collectives over the mesh and return replicated
results, so every process computes the same answer with no host-side
exchange:

  len(t)           replicated n_unique scalar (already computed)
  t.total()        one replicated sum (padding counts are 0), int32-wrap
                   poisoned like unique_count
  t.most_common(n) per-shard lax.top_k -> all_gather of D*k candidate
                   rows -> host merge of k*D rows, never the table
  key in t / t[k]  per-shard comparison scan -> psum -> one scalar
  t.values()       per-process addressable counts + host allgather
  t.to_counter()   full materialization via dist.pipeline.table_to_counter

Prefix-layout tables (the overflow fallback's replicated output) don't
need any of this - distributed_count_table() routes them to the plain
CountTable, whose device ops run replicated.
"""

from __future__ import annotations

import numpy as np

# Process-wide cache of the jitted per-mesh top-k steps, keyed by
# (mesh, k): a per-instance cache would re-trace identical programs for
# every table built over the same mesh.  BOUNDED as a simple FIFO-evicting
# dict (each entry pins a compiled shard_map closure and a
# Mesh with device refs; long-lived processes querying many n values or
# rebuilding meshes would otherwise accumulate them without limit).  k is
# already pow2-bucketed, so 16 slots cover several meshes x several k.
_TOPK_STEPS: dict = {}
_TOPK_STEPS_MAX = 16


def _topk_step_put(key, step):
    while len(_TOPK_STEPS) >= _TOPK_STEPS_MAX:
        _TOPK_STEPS.pop(next(iter(_TOPK_STEPS)))
    _TOPK_STEPS[key] = step


def distributed_count_table(table, mesh):
    """The right lazy view for a merged table: plain CountTable for
    replicated prefix layouts, DistributedCountTable for mesh-sharded
    scattered layouts."""
    from ..count.table import CountTable
    from .count import ShardedCountTable

    if not isinstance(table, ShardedCountTable) or table.layout == "prefix":
        return CountTable.from_device_tables([tuple(table[:4])])
    return DistributedCountTable(table, mesh)


class DistributedCountTable:
    def __init__(self, table, mesh):
        from .count import ShardedCountTable

        if not (isinstance(table, ShardedCountTable)
                and table.layout == "scattered"):
            raise ValueError("expected a scattered-layout ShardedCountTable")
        self._t = table
        self._mesh = mesh
        self._n = None

    # -- cheap reads ----------------------------------------------------

    def __len__(self) -> int:
        import jax

        if self._n is None:
            self._n = int(jax.device_get(self._t.n_unique))
        return self._n

    def total(self) -> int:
        import jax

        from ..count.table import _total

        # count.table's module-level jitted reducer: jit is sharding-
        # polymorphic, so the same program cache serves single-device and
        # mesh-sharded arrays (no duplicated wrap-detection logic either).
        s = int(jax.device_get(_total()(self._t.counts)))
        if s < 0:
            raise OverflowError(
                "count table entry/total exceeded int32; merge in smaller "
                "pieces")
        return s

    def most_common(self, n: int | None = None):
        """Top-n (ShortSeq, count) pairs, count desc then key asc.  Only
        D*k candidate rows cross the mesh and the link (k = n rounded to
        a pow2 bucket); n=None falls back to full materialization order.
        Tie members at the boundary follow shard order (same freedom as
        CountTable.most_common documents)."""
        if n is None:
            from .pipeline import table_to_host_rows

            rows = _pairs(table_to_host_rows(self._t))
            rows.sort(key=lambda kv: (-kv[1], str(kv[0])))
            return rows
        import jax
        import jax.numpy as jnp
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        k = max(16, 1 << max(n - 1, 0).bit_length())
        k = max(1, min(k, self._t.counts.shape[0]
                       // self._mesh.devices.size))

        key = (self._mesh, k)
        if key not in _TOPK_STEPS:
            def body(words, lengths, counts):
                # shard_map body: per-shard [rows/D(, W)] views
                v, idx = jax.lax.top_k(counts, k)
                return (jax.lax.all_gather(words[idx], "data", tiled=True),
                        jax.lax.all_gather(lengths[idx], "data", tiled=True),
                        jax.lax.all_gather(v, "data", tiled=True),
                        jax.lax.pmin(jnp.min(counts), "data"))

            mapped = shard_map(
                body, mesh=self._mesh,
                in_specs=(P("data"), P("data"), P("data")),
                out_specs=(P(), P(), P(), P()),
                check_vma=False)
            _topk_step_put(key, jax.jit(mapped))

        w, lens, cnts, mn = jax.device_get(_TOPK_STEPS[key](
            self._t.words, self._t.lengths, self._t.counts))
        if int(mn) < 0:
            raise OverflowError(
                "count table entry exceeded int32; merge in smaller pieces")
        w, lens, cnts = np.asarray(w), np.asarray(lens), np.asarray(cnts)
        keep = cnts > 0  # pad rows carry count 0
        rows = _pairs_from_arrays(w[keep], lens[keep], cnts[keep])
        rows.sort(key=lambda kv: (-kv[1], str(kv[0])))
        return rows[:n]

    def values(self):
        """All live counts as host numpy int64 (order unspecified);
        multi-controller processes exchange per-host count slabs so every
        process returns the identical multiset.  Only lengths + counts
        cross the link (8 B/key) - never the words matrix - and the live
        row count is checked against n_unique like every other scattered
        materialization."""
        import jax

        from ..count.device import PAD_LENGTH

        lens_a, cnts_a = self._t.lengths, self._t.counts
        if not isinstance(lens_a, jax.Array) or lens_a.is_fully_addressable:
            lens, cnts = (np.asarray(x) for x in
                          jax.device_get((lens_a, cnts_a)))
            cnts = cnts[lens != int(PAD_LENGTH)].astype(np.int64)
        else:
            def _local(x):
                shards = sorted(x.addressable_shards, key=lambda s: s.index)
                return np.concatenate([np.asarray(s.data) for s in shards])

            from jax.experimental import multihost_utils

            lens, cnts = _local(lens_a), _local(cnts_a)
            cnts = np.ascontiguousarray(
                cnts[lens != int(PAD_LENGTH)], np.int32)
            sizes = multihost_utils.process_allgather(
                np.asarray([len(cnts)], np.int32))
            max_rows = int(sizes.max())
            # Sentinel must survive the allgather: jax runs with x64
            # disabled, so int64 payloads silently truncate to int32 (an
            # out-of-range sentinel like -2^40 became 0 and leaked a
            # phantom zero count).  int32 min is distinct from live
            # counts (>= 1) and from the poison value (-1).
            sentinel = np.iinfo(np.int32).min
            pad = np.full(max_rows - len(cnts), sentinel, np.int32)
            g = multihost_utils.process_allgather(
                np.concatenate([cnts, pad])).reshape(-1)
            cnts = g[g != sentinel].astype(np.int64)
        if len(cnts) != len(self):
            raise ValueError(
                f"scattered table live rows ({len(cnts)}) disagree with "
                f"n_unique ({len(self)})")
        if cnts.size and int(cnts.min()) < 0:
            raise OverflowError(
                "count table entry exceeded int32; merge in smaller pieces")
        return cnts

    # -- lookups ----------------------------------------------------------

    def get(self, key, default=0):
        import jax
        import jax.numpy as jnp

        from ..count.table import _key_to_rows

        q = _key_to_rows(key)
        if q is None:
            return default
        q_len, lanes = q
        width = self._t.words.shape[1]
        if q_len > 16 * width or any(int(x) for x in lanes[width:]):
            return default
        q_words = np.zeros(width, np.uint32)
        q_words[:min(len(lanes), width)] = lanes[:width]

        from ..count.table import _lookup

        # count.table's module-level jitted scan (sharding-polymorphic:
        # the reduction partitions over the mesh automatically).
        c = int(jax.device_get(_lookup()(
            self._t.words, self._t.lengths, self._t.counts,
            jnp.asarray(q_words), jnp.int32(q_len))))
        if c < 0:
            raise OverflowError(
                "count table entry exceeded int32; merge in smaller pieces")
        return c if c else default

    def __contains__(self, key) -> bool:
        return self.get(key, None) is not None

    def __getitem__(self, key) -> int:
        c = self.get(key, None)
        if c is None:
            raise KeyError(key)
        return c

    # -- materialization --------------------------------------------------

    def to_counter(self):
        from .pipeline import table_to_counter

        return table_to_counter(self._t)


def _pairs(rows_to_table_out):
    from .. import api

    return [(api.from_blocks(blocks, length), count)
            for (length, blocks), count in rows_to_table_out]


def _pairs_from_arrays(w, lens, cnts):
    from ..count.device import _rows_to_table

    return _pairs(_rows_to_table(w, lens, cnts))
