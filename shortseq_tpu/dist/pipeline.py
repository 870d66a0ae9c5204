"""Streaming multi-shard / multi-host FASTQ dedup pipeline.

The production form of read_and_count_fastq (SURVEY.md section 3.5 "north
star"): the file is split into byte-range shards (native sharder,
csrc/fastq_index.cpp ssq_fastq_sync), each shard is packed and counted on
device in fixed-size padded batches (one compiled program per bucket), the
partial tables are optionally checkpointed (count/checkpoint.py, resume =
skip completed shards), and the final table is one associative merge.

Multi-host: host h processes shards h, h+H, h+2H...; each host spills its
tables to the shared checkpoint directory and host 0 merges.  Single-host
runs do the same loop in-process, so the code path is identical.
"""

from __future__ import annotations

import os

import numpy as np

from ..config import DEFAULT_CONFIG, PipelineConfig


def _batched_count_tables(data, starts, lengths, config: PipelineConfig,
                          device=None):
    """Yield count tables for one shard's indexed reads, counted on
    `device` (default: JAX's default device), one padded batch per width
    bucket per batch_size chunk.  Packing + bloom validation happen in the
    host gather (count/ingest.packed_buckets), so only 2-bit words cross
    to the device."""
    import jax

    from ..count import unique_count
    from ..count.ingest import packed_buckets

    for words, sub_len in packed_buckets(
            data, starts, lengths, batch_size=config.batch_size,
            min_pad=config.min_batch_pad):
        words, sub_len, ones = jax.device_put(
            (words, sub_len, np.ones(len(sub_len), np.int32)), device)
        yield unique_count(words, sub_len, ones)


def count_fastq_sharded(filename, n_shards: int = 1, host: int = 0,
                        n_hosts: int = 1,
                        config: PipelineConfig = DEFAULT_CONFIG):
    """Count `filename`'s reads across byte-range shards; this host
    processes shards host, host+n_hosts, ...  Returns the merged device
    table for THIS host's shards (merge across hosts with
    count/checkpoint.merge_tables or dist.count_sharded).

    With config.checkpoint_dir set, each shard's table is spilled after
    counting and completed shards are skipped on resume.
    """
    return _merge_host_tables(_count_shards_to_host(
        filename, n_shards, host, n_hosts, config))


def _count_shards_to_host(filename, n_shards: int, host: int, n_hosts: int,
                          config: PipelineConfig):
    """count_fastq_sharded without the final merge: one list of host
    (words, lengths, counts) tables for this host's shards.  This host's
    i-th shard counts on its local device i mod (local device count), so
    a process that drives several cards spreads the counting over all of
    them."""
    import jax

    from ..count.checkpoint import (check_manifest, completed_shards,
                                    file_fingerprint, load_table, save_table,
                                    shard_path)
    from ..io.fastq import read_fastq_index

    size = os.path.getsize(filename)
    ckpt = config.checkpoint_dir
    done = set()
    if ckpt:
        # Refuse to resume with incompatible sharding, a different file,
        # or modified content (size alone misses same-size edits -
        # fingerprint covers head/tail bytes).
        check_manifest(ckpt, file=os.path.basename(str(filename)),
                       size=size, n_shards=n_shards, n_hosts=n_hosts,
                       fingerprint=file_fingerprint(filename))
        done = completed_shards(ckpt, host)

    devices = jax.local_devices()
    tables = []  # host tables: freshly counted shards + resumed loads
    for i, shard in enumerate(range(host, n_shards, n_hosts)):
        if shard in done:
            tables.append(load_table(shard_path(ckpt, host, shard)))
            continue
        lo = shard * size // n_shards
        hi = (shard + 1) * size // n_shards
        # n_shards == 1 reads the whole file directly - no byte-range path,
        # so single-shard runs also accept gzip input.
        rng = (lo, hi) if n_shards > 1 else None
        data, starts, lengths = read_fastq_index(filename, byte_range=rng)
        # Fetch each batch table as it is produced: device memory stays
        # O(batch), not O(shard) (the whole point of config.batch_size).
        host_tables = [_table_to_host(t) for t in _batched_count_tables(
            data, starts, lengths, config, devices[i % len(devices)])]
        if ckpt:
            merged = _merge_host_tuples_device(host_tables)
            w, l, c = _table_to_host(merged)  # one live-prefix fetch...
            save_table(shard_path(ckpt, host, shard), w, l, c, len(l))
            tables.append((w, l, c))          # ...shared with the spill
        else:
            tables.extend(host_tables)
    return tables


def _table_to_host(table):
    """Fetch a count table to host numpy, raising on n_out overflow and on
    int32-wrapped (poisoned, count < 0) entries - a poisoned count
    re-merged with more weight could land positive and pass every later
    check (unique_count's wrap detection promises every materialization
    path raises).

    Accepts plain (w, l, c, n) prefix tables (device or host) and
    ShardedCountTable; "scattered" layouts - PAD-interleaved rows, the
    arrays possibly device-sharded over the mesh - route through
    _scattered_to_host, which handles multi-controller fetches."""
    import jax

    from .count import ShardedCountTable
    from ..count.device import fetch_table

    if isinstance(table, ShardedCountTable) and table.layout == "scattered":
        w, lens, cnts = _scattered_to_host(table.words, table.lengths,
                                           table.counts)
        if len(cnts) != int(jax.device_get(table.n_unique)):
            raise ValueError(
                f"scattered table live rows ({len(cnts)}) disagree with "
                f"n_unique ({int(jax.device_get(table.n_unique))})")
        if len(cnts) and int(np.asarray(cnts).min()) < 0:
            raise OverflowError(
                "count table entry exceeded int32; merge in smaller pieces")
        return w, lens, cnts
    u_words, u_lengths, u_counts, n_unique = table[:4]
    if isinstance(u_words, jax.Array):
        # Live-prefix fetch: never ship the padding rows over the link.
        w, lens, cnts, _n = fetch_table(u_words, u_lengths, u_counts,
                                        n_unique)
    else:
        n = int(n_unique)
        lens = np.asarray(u_lengths)
        if n > len(lens):
            raise ValueError(
                f"count table overflow: {n} unique keys but only "
                f"{len(lens)} output rows (n_out too small)")
        w, lens, cnts = (np.asarray(u_words)[:n], lens[:n],
                         np.asarray(u_counts)[:n])
    if len(cnts) and int(np.asarray(cnts).min()) < 0:
        raise OverflowError(
            "count table entry exceeded int32; merge in smaller pieces")
    return w, lens, cnts


def _scattered_to_host(words, lengths, counts):
    """Host arrays of a scattered-layout table's live rows.

    Single-process (or fully-replicated) arrays: one device_get + PAD
    filter.  Multi-controller sharded arrays: each process fetches only
    its addressable shards (buckets are disjoint, so local live rows are
    globally unique keys with final counts), then the per-host slabs are
    exchanged with process_allgather so every process returns the
    identical full table - the host-side analog of the all_gather the
    replicate=True layout would have paid on device."""
    import jax

    from ..count.device import PAD_LENGTH

    def _live(w, l, c):
        keep = np.flatnonzero(np.asarray(l) != int(PAD_LENGTH))
        return (np.asarray(w)[keep], np.asarray(l)[keep],
                np.asarray(c)[keep])

    if not isinstance(words, jax.Array) or words.is_fully_addressable:
        return _live(*jax.device_get((words, lengths, counts)))

    def _local(x):
        shards = sorted(x.addressable_shards, key=lambda s: s.index)
        return np.concatenate([np.asarray(s.data) for s in shards])

    from jax.experimental import multihost_utils

    w, l, c = _live(_local(words), _local(lengths), _local(counts))
    # int32 on purpose: jax runs with x64 disabled, so int64 payloads
    # silently truncate through process_allgather.
    rows = multihost_utils.process_allgather(
        np.asarray([len(l)], np.int32))
    max_rows = int(rows.max())
    pad = max_rows - len(l)
    w_pad = np.pad(w, ((0, pad), (0, 0)))
    l_pad = np.pad(l, (0, pad), constant_values=int(PAD_LENGTH))
    c_pad = np.pad(c, (0, pad))
    g_w = multihost_utils.process_allgather(w_pad)
    g_l = multihost_utils.process_allgather(l_pad)
    g_c = multihost_utils.process_allgather(c_pad)
    return _live(g_w.reshape(-1, w.shape[1]), g_l.reshape(-1),
                 g_c.reshape(-1))


def gather_row_sharded(x):
    """Host numpy of a ROW-sharded mesh output in global row order,
    multi-controller safe for ANY mesh device order: each process fetches
    its addressable shards together with their global row offsets, the
    (rows, offsets) pairs are allgathered, and rows are scattered back to
    their offsets - no assumption that processes own contiguous ascending
    bands (an interleaved device order or a reversed device list would
    silently permute a rank-order concatenation)."""
    import jax

    if not isinstance(x, jax.Array) or x.is_fully_addressable:
        return np.asarray(jax.device_get(x))
    from jax.experimental import multihost_utils

    shards = sorted(x.addressable_shards, key=lambda s: s.index[0].start)
    local = np.concatenate([np.asarray(s.data) for s in shards])
    offs = np.concatenate([
        np.arange(s.index[0].start, s.index[0].stop, dtype=np.int32)
        for s in shards])
    g_rows = multihost_utils.process_allgather(local)
    g_offs = multihost_utils.process_allgather(offs).reshape(-1)
    g_rows = np.asarray(g_rows).reshape(-1, *local.shape[1:])
    out = np.empty((x.shape[0], *local.shape[1:]), local.dtype)
    out[g_offs] = g_rows
    return out


def table_to_host_rows(table):
    """Materialize any count table (prefix or scattered, replicated or
    mesh-sharded) as [((length, blocks64 tuple), count), ...] host rows -
    the layout-agnostic consumption path for merged tables."""
    from ..count.device import _rows_to_table

    return _rows_to_table(*_table_to_host(table))


def _merge_host_tables(tables):
    if not tables:
        from ..count.checkpoint import empty_table

        return empty_table(1)
    return _merge_host_tuples_device(tables)


def _merge_host_tuples_device(host_tables):
    """Concat + one device unique_count (count/checkpoint.py owns the
    shared implementation: pow2 row padding, PAD sentinels)."""
    from ..count.checkpoint import merge_host_tuples

    return merge_host_tuples(host_tables)


def read_and_count_fastq_distributed(filename, n_shards: int | None = None,
                                     config: PipelineConfig = DEFAULT_CONFIG):
    """Multi-host entry point: every host calls this with the same
    filename; host h parses and counts its byte-range shards locally, then
    the per-host tables are merged exactly with one collective pass over
    the global `data` mesh.  The merge is count_sharded_auto: the scalable
    bucketed all_to_all exchange (per-device merge work flat in device
    count, table stays sharded) with the exact all_gather strategy as the
    implemented overflow fallback.  Returns a ShardedCountTable; consume
    it with table_to_counter / table_to_host_rows, which handle both
    layouts in multi-controller runs.

    Shards default to one per device, and each host counts its shards on
    its own devices in turn (_count_shards_to_host), so one process that
    drives several cards spreads the counting over all of them before
    the mesh merge.  With a single device this degenerates to
    count_fastq_sharded (no mesh merge), so it is also the simplest
    correct entry point everywhere.
    """
    import jax

    from .count import ShardedCountTable, count_sharded_auto
    from .mesh import data_mesh, initialize_distributed

    initialize_distributed()
    host, n_hosts = jax.process_index(), jax.process_count()
    if n_shards is None:
        n_shards = jax.device_count()
    tables = _count_shards_to_host(filename, n_shards=n_shards, host=host,
                                   n_hosts=n_hosts, config=config)
    if jax.device_count() == 1:
        return ShardedCountTable(*_merge_host_tables(tables), "prefix")

    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..count.device import PAD_LENGTH

    # This host's shard tables stacked as rows (the merge sums duplicate
    # keys across shards through the weights).  Agree on a common
    # per-host row count and lane width, then build a global
    # [hosts*rows, W] array with each host contributing its padded slab.
    n_rows = sum(len(l) for _, l, _ in tables)
    width = max([w.shape[1] for w, _, _ in tables if w.size], default=1)
    # int32: int64 would silently truncate through the x64-disabled jax.
    sizes = multihost_utils.process_allgather(
        np.asarray([n_rows, width], np.int32))
    rows = int(sizes[:, 0].max())
    width = int(sizes[:, 1].max())
    # Round rows up so the global batch divides the mesh evenly.
    dev_per_host = len(jax.local_devices())
    rows = max(dev_per_host, -(-rows // dev_per_host) * dev_per_host)

    w_pad = np.zeros((rows, width), np.uint32)
    l_pad = np.full(rows, PAD_LENGTH, np.int32)
    c_pad = np.zeros(rows, np.int32)
    at = 0
    for w, l, c in tables:
        w_pad[at:at + len(l), :w.shape[1]] = w
        l_pad[at:at + len(l)] = l
        c_pad[at:at + len(l)] = c
        at += len(l)

    mesh = data_mesh()
    sharding = NamedSharding(mesh, P("data"))
    g_w = jax.make_array_from_process_local_data(sharding, w_pad)
    g_l = jax.make_array_from_process_local_data(sharding, l_pad)
    g_c = jax.make_array_from_process_local_data(sharding, c_pad)
    return count_sharded_auto(mesh)(g_w, g_l, g_c)


def table_to_counter(table):
    """Merged device table -> reference-identical ShortSeqCounter (one
    native call for the whole table, api.counter.update_counter_from_host_table).
    Routes through _table_to_host so an n_out-too-small table raises the
    overflow error instead of silently dropping keys, and so scattered /
    mesh-sharded layouts (ShardedCountTable) materialize correctly."""
    from ..api.counter import ShortSeqCounter, update_counter_from_host_table

    out = ShortSeqCounter()
    w, l, c = _table_to_host(table)
    update_counter_from_host_table(out, w, l, c)
    return out
