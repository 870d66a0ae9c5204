"""ShortSeqCounter - Counter-style exact deduplication.

Parity type for the reference counter (reference counter.pyx:10-54): a dict
subclass whose keys are restricted to ShortSeq types and whose counting
ingest accepts a list of PyBytes.  The reference's private
_PyDict_*_KnownHash entry points exist to skip re-hashing; here __hash__ is
a trivial field read (the packed word), so the public dict protocol is the
same speed class - and the *throughput* path is not this object at all but
the device sort-unique-count in shortseq_tpu.count, which this class
materializes from.
"""

from __future__ import annotations

import functools
import time


def _backend():
    """The resolved object backend (native extension or pure Python).
    Lazy to avoid a circular import with the package __init__."""
    from .. import api

    return api


class ShortSeqCounter(dict):
    def __init__(self, source=None):
        super().__init__()
        if type(source) is list:
            self._count_py_bytes_list(source)

    def __setitem__(self, key, val):
        # Key-type restriction (reference counter.pyx:17-19)
        b = _backend()
        if type(key) not in (b.ShortSeq64, b.ShortSeq192, b.ShortSeqVar):
            raise TypeError(f"{self.__class__} does not support {type(key)} keys")
        dict.__setitem__(self, key, val)

    def _count_py_bytes_list(self, it):
        # C-speed ingest loop when the native extension is built
        # (reference counter.pyx:22-29's role).
        from ..native_build import load as _load_native

        native = _load_native()
        if native is not None and hasattr(native, "count_bytes_list"):
            native.count_bytes_list(self, it)
            return
        from_bytes = _backend().from_bytes
        get = self.get
        setter = dict.__setitem__
        for seqbytes in it:
            s = from_bytes(seqbytes)
            setter(self, s, get(s, 0) + 1)

    def count_sequences(self, seqs):
        """Ingest an iterable of already-packed ShortSeq objects."""
        get = self.get
        setter = dict.__setitem__
        for s in seqs:
            setter(self, s, get(s, 0) + 1)

    def update_counts(self, pairs):
        """Merge (ShortSeq, count) pairs - used by the device-count and
        distributed-merge paths to materialize their tables."""
        get = self.get
        setter = dict.__setitem__
        for s, c in pairs:
            setter(self, s, get(s, 0) + c)


def update_counter_from_host_table(counter, words, lengths, counts) -> None:
    """Add a host count table (words `[M, W]` uint32, lengths `[M]` int32,
    counts `[M]` int32/int64) into `counter` - one native call for the
    whole table when the extension is built (the role of the reference's
    known-hash dict inserts, counter.pyx:41-54), a Python loop otherwise.
    """
    import numpy as np

    from ..native_build import load as _load_native

    counts = np.asarray(counts)
    # Counts must be signed integers BEFORE the negative check: the native
    # table view reinterprets the buffer bitwise, so a uint32 2^31 (or a
    # float) would silently wrap/scramble.  Unsigned widens exactly.
    if not np.issubdtype(counts.dtype, np.integer):
        raise TypeError(f"counts must be an integer array, got {counts.dtype}")
    if np.issubdtype(counts.dtype, np.unsignedinteger):
        counts = counts.astype(np.int64)
    # int32 device counts that wrapped negative must fail loudly, on every
    # backend (see count/device._rows_to_table).
    if counts.size and int(counts.min()) < 0:
        raise OverflowError(
            "count table entry exceeded int32; merge in smaller pieces")
    words = np.ascontiguousarray(words, dtype=np.uint32)
    lengths64 = np.asarray(lengths, dtype=np.int64)
    # A length beyond the table's lane capacity would materialize keys
    # with fabricated 'A' tail bases (truncated/width-mismatched table).
    if lengths64.size and (int(lengths64.min()) < 0
                           or int(lengths64.max()) > 16 * words.shape[1]):
        raise ValueError(
            f"table row length out of range for {words.shape[1]} lanes "
            f"(lengths span [{lengths64.min()}, {lengths64.max()}], "
            f"capacity {16 * words.shape[1]} nt)")
    native = _load_native()
    if native is not None and hasattr(native, "update_from_table"):
        native.update_from_table(
            counter, words,
            np.ascontiguousarray(lengths64, dtype=np.int32),
            np.ascontiguousarray(counts))
        return
    from ..count.device import _rows_to_table

    b = _backend()
    setter = dict.__setitem__
    for (length, blocks), count in _rows_to_table(
            np.asarray(words), np.asarray(lengths), counts):
        key = b.from_blocks(blocks, length)
        setter(counter, key, counter.get(key, 0) + count)


def count_matrix_device(mat, lengths) -> ShortSeqCounter:
    """Count a padded ASCII read matrix on device and materialize a
    reference-identical ShortSeqCounter.

    Reads are bucketed by width class (<=32, <=96, <=1024 nt - the
    reference's ladder, short_seq.pyx:54-74) so each device batch is as
    narrow as possible; bucket tables are disjoint by length, so the final
    dict is their union.  Raises the reference's error on invalid bases.
    """
    import numpy as np

    from ..constants import MAX_VAR_NT, TOO_LONG_MSG, UNSUPPORTED_BASE_MSG

    counts = ShortSeqCounter()
    if len(lengths) == 0:
        return counts
    if int(np.max(lengths)) > MAX_VAR_NT:
        raise Exception(TOO_LONG_MSG)

    import jax.numpy as jnp

    from ..count import count_batch
    from ..count.device import PAD_LENGTH, fetch_table
    from ..count.ingest import WIDTH_EDGES, pack_validate_padded
    from ..oracle import first_invalid_char

    for lo, hi, width in WIDTH_EDGES:
        sel = (lengths > lo) & (lengths <= hi)
        if lo == 0:
            sel |= lengths == 0
        if not sel.any():
            continue
        rows = np.ascontiguousarray(mat[sel][:, :width]) if mat.shape[1] >= width \
            else np.pad(mat[sel], ((0, 0), (0, width - mat.shape[1])))
        sub_len = lengths[sel].astype(np.int32)
        m = len(sub_len)
        # Batch-dim pow2 padding + validation live in one shared helper
        # (count/ingest.pack_validate_padded); pad rows for unique_count
        # carry PAD_LENGTH and are dropped.
        words, ok = pack_validate_padded(rows, sub_len)
        if not ok.all():
            bad_idx = int(np.argmin(ok))
            bad = first_invalid_char(rows[bad_idx][:int(sub_len[bad_idx])])
            raise Exception(f"{UNSUPPORTED_BASE_MSG}: {bad}")
        m_pad = words.shape[0]
        if m_pad != m:
            sub_len = np.pad(sub_len, (0, m_pad - m),
                             constant_values=PAD_LENGTH)
        table = count_batch(words, jnp.asarray(sub_len))
        u_w, u_l, u_c, n_live = fetch_table(*table)
        update_counter_from_host_table(counts, u_w, u_l, u_c)
    return counts


#: Buckets at or above this many padded rows stream to the device in 4
#: fixed-size chunks with the per-chunk counts dispatched between the
#: transfers (h2d hidden behind sort work); smaller buckets keep the
#: single-transfer path whose merge-free sort is cheaper than the overlap
#: is worth.  The threshold was chosen on another chip and is not measured
#: on the H100 (ROADMAP queue 1 items 2 and 4; queue 3 item 1).  Override
#: (e.g. 0 to disable chunking) with SHORTSEQ_TPU_H2D_CHUNK_ROWS.
H2D_CHUNK_MIN_ROWS = 1 << 21


def _env_int(name: str, default: int) -> int:
    import os

    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _h2d_chunks(rows_pad: int) -> int:
    min_rows = _env_int("SHORTSEQ_TPU_H2D_CHUNK_ROWS", H2D_CHUNK_MIN_ROWS)
    if min_rows <= 0 or rows_pad < min_rows or rows_pad % 4:
        return 1
    return 4


def _put_lengths(sub_len):
    """Ship per-row lengths to the device as int16 and widen there:
    lengths are <= 1024 (and PAD_LENGTH maps to -1), so the int16 wire
    format cuts the host->device bytes per read at the 2-lane width class
    from 12 to 10.  Whether that saving is worth a second program on a
    directly attached card is not measured (ROADMAP queue 3 item 1).
    """
    import jax
    import numpy as np

    from ..constants import MAX_VAR_NT
    from ..count.device import PAD_LENGTH

    sub_len = np.asarray(sub_len)
    live = sub_len != PAD_LENGTH
    if live.any() and not (0 <= int(sub_len[live].min())
                           and int(sub_len[live].max()) <= MAX_VAR_NT):
        # A length past int16 would wrap and miscount silently.
        raise ValueError(
            f"read lengths must lie in [0, {MAX_VAR_NT}] for the int16 "
            f"wire format, got [{sub_len[live].min()}, "
            f"{sub_len[live].max()}]")
    l16 = np.where(live, sub_len, -1).astype(np.int16)
    return _widen_lengths()(jax.device_put(l16))


@functools.lru_cache(maxsize=None)
def _widen_lengths():
    import jax
    import jax.numpy as jnp

    from ..count.device import PAD_LENGTH

    @jax.jit
    def widen(l16):
        l = l16.astype(jnp.int32)
        return jnp.where(l < 0, jnp.int32(PAD_LENGTH), l)

    return widen


def count_indexed_device_table(data, starts, lengths,
                               batch_size: int | None = None):
    """Count indexed FASTQ rows (io.fastq.read_fastq_index output) on
    device: host gather+pack per width bucket, device sort-unique-count.
    Returns a lazy count.table.CountTable whose buckets STAY device-
    resident - `most_common(n)` / lookups fetch O(n) rows, never the 10 M-
    object dict.  Bucket tables are disjoint by length, so the logical
    table is their union.

    One quarter-pow2-padded batch per width bucket (ingest.quarter_pow2:
    bounded 25% pad waste vs pow2's worst-case +100% - pad rows ride the
    h2d transfer AND the sort); buckets >= H2D_CHUNK_MIN_ROWS stream in 4
    fixed-shape chunks whose transfers overlap the per-chunk counts, with
    one associative on-device merge (see the inline comment).  Every
    shape is on the quarter-pow2 grid, so the set of compiled programs
    stays closed.  batch_size is accepted for API compatibility and caps
    the gather granularity only (chunks are concatenated on HOST before
    the device_put).
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ..count.device import PAD_LENGTH, unique_count
    from ..count.ingest import packed_buckets
    from ..count.table import CountTable

    if len(lengths) == 0:
        return CountTable([])
    from ..count.ingest import quarter_pow2

    by_width = {}
    # Chunks arrive UNPADDED and each bucket pads exactly once, to a
    # quarter-pow2 step: pad rows ride the h2d transfer AND the sort, so
    # the pow2 rule's worst case (+100%) was real time here, and padding
    # per-chunk before a final re-pad would compound back to ~56% waste.
    for words, sub_len in packed_buckets(data, starts, lengths,
                                         batch_size=batch_size,
                                         pad_pow2=False):
        by_width.setdefault(words.shape[1], []).append((words, sub_len))
    tables = []
    for w, parts in by_width.items():
        rows = sum(len(p[1]) for p in parts)
        rows_pad = quarter_pow2(rows)
        if len(parts) == 1 and rows_pad == len(parts[0][1]):
            words, sub_len = parts[0]
        else:
            words = np.zeros((rows_pad, w), np.uint32)
            sub_len = np.full(rows_pad, PAD_LENGTH, np.int32)
            at = 0
            for pw, pl in parts:
                words[at:at + len(pl)] = pw
                sub_len[at:at + len(pl)] = pl
                at += len(pl)
        n_chunks = _h2d_chunks(rows_pad)
        if n_chunks == 1:
            dw = jax.device_put(words)
            dl = _put_lengths(sub_len)
            tables.append(unique_count(dw, dl,
                                       jnp.ones(dw.shape[0], jnp.int32)))
            continue
        # Large bucket: pipeline the h2d transfer behind the count.
        # Fixed-count chunking keeps every shape in the closed compile
        # set (C = rows_pad / 4, rows_pad on the quarter-pow2 grid):
        # device_put and unique_count are both async dispatches, so
        # chunk k+1's transfer overlaps chunk k's sort; the per-chunk
        # tables then merge associatively in ONE unique_count at the
        # rows_pad shape the unchunked path already compiles.
        c = rows_pad // n_chunks
        parts_t = []
        for i in range(n_chunks):
            dw = jax.device_put(words[i * c:(i + 1) * c])
            dl = _put_lengths(sub_len[i * c:(i + 1) * c])
            parts_t.append(unique_count(dw, dl, jnp.ones(c, jnp.int32)))
        tables.append(unique_count(
            jnp.concatenate([t[0] for t in parts_t]),
            jnp.concatenate([t[1] for t in parts_t]),
            jnp.concatenate([t[2] for t in parts_t])))
    return CountTable.from_device_tables(tables)


def count_indexed_device(data, starts, lengths,
                         batch_size: int | None = None) -> ShortSeqCounter:
    """Eager form of count_indexed_device_table: materializes the full
    reference-identical dict (one native call per bucket)."""
    return count_indexed_device_table(data, starts, lengths,
                                      batch_size=batch_size).to_counter()


def count_indexed_host_table(data, starts, lengths):
    """Count indexed FASTQ rows entirely on the host: fused native gather +
    2-bit pack + bloom validate, threaded partitioned hash count
    (csrc ssq_host_count).  Returns a lazy CountTable over the compact
    host arrays (no Python objects until to_counter()/most_common ask),
    or None when the native library is unavailable (callers fall back to
    the device engine)."""
    from ..count.ingest import packed_buckets
    from ..count.table import CountTable
    from ..io.native import get_lib, host_count_native

    if get_lib() is None:
        return None  # decide BEFORE packing: a late None would waste a
        # full numpy gather+pack pass only to repeat it on the device path
    if len(lengths) == 0:
        return CountTable([])
    tables = []
    for words, sub_len in packed_buckets(data, starts, lengths,
                                         pad_pow2=False):
        tables.append(host_count_native(words, sub_len))
    return CountTable.from_host_tables(tables)


def count_indexed_host(data, starts, lengths) -> ShortSeqCounter | None:
    """Eager form of count_indexed_host_table: same table contents as the
    device engine - exact dedup is engine-independent."""
    table = count_indexed_host_table(data, starts, lengths)
    return None if table is None else table.to_counter()


def read_and_count_fastq(filename, engine: str = "auto") -> ShortSeqCounter:
    """End-to-end FASTQ dedup pipeline with the reference's phase-timing
    print (reference counter.pyx:57-71).

    All engines share the ingest path - native index (starts/lengths only,
    no row copy) -> fused host gather + 2-bit pack + bloom validate - and
    produce bit-identical Counter contents; they differ only in where the
    unique-count reduction runs:

    * "host": threaded native hash count.  Fastest single-host engine -
      nothing crosses to the device (the reference's entry point is also
      host-only, counter.pyx:57-71).
    * "device": accelerator sort-unique-count over packed words - the
      engine the distributed pipeline scales with (dist/pipeline.py);
      on-device tables feed collective merges without a host round trip.
    * "auto" (default): "host" when the native library is built, else
      "device" - a rule argued on another chip, where single-file
      counting was transfer-bound; not measured on the H100 (ROADMAP
      queue 1 item 3).  Multi-device runs use
      read_and_count_fastq_distributed, which is always on-device.
    """
    from ..utils.profiling import PhaseTimings, phase_timer

    timings = PhaseTimings()
    with phase_timer("total", timings):
        table, n_reads = _read_and_count_table(filename, engine)
        counts = table.to_counter()
    timings.add("read", table._read_seconds)
    timings.add("count", timings.phases["total"] - table._read_seconds)
    print(f"{timings.phases['read']:.2f}s to read {n_reads} total seqs, "
          f"and {timings.phases['count']:.2f}s to count "
          f"{len(counts)} unique sequences")
    return counts


#: Files larger than this stream through byte-range slices instead of one
#: whole-file read, bounding host RSS at O(slice + unique table) rather
#: than O(file) (the reference's getline loop streams too,
#: fast_read.pyx:3-20).  Override with the
#: SHORTSEQ_TPU_STREAM_BYTES env var (also the slice size).
DEFAULT_STREAM_BYTES = 1 << 30


def _stream_bytes() -> int:
    return _env_int("SHORTSEQ_TPU_STREAM_BYTES", DEFAULT_STREAM_BYTES)


def _read_and_count_table(filename, engine: str):
    """Shared engine policy: index the FASTQ, count with the requested
    engine, return (CountTable, n_reads).  The read-phase seconds are
    stashed on the table for the reference-style timing print.

    Files above the streaming threshold are counted in byte-range slices
    (same record-sync boundaries as the multi-host sharder) so host
    memory stays O(slice + unique table), not O(file); plain gzip streams
    have no random access and keep the whole-file path, while BGZF
    (bgzip) files stream block-aligned slices (io/bgzf.py)."""
    from ..io.fastq import _is_gzip, read_fastq_index

    if engine not in ("auto", "host", "device"):
        raise ValueError(f"unknown engine {engine!r}")
    import os

    stream_bytes = _stream_bytes()
    try:
        size = os.path.getsize(filename)
    except OSError:
        size = 0

    def _range_shardable() -> bool:
        if not _is_gzip(filename):
            return True
        from ..io.bgzf import is_bgzf

        return is_bgzf(filename)

    if size > stream_bytes and _range_shardable():
        return _read_and_count_table_streamed(filename, engine, size,
                                              stream_bytes)
    t1 = time.time()
    data, starts, lengths = read_fastq_index(filename)
    t2 = time.time()
    table = None
    if engine in ("auto", "host"):
        table = count_indexed_host_table(data, starts, lengths)
        if table is None and engine == "host":
            raise RuntimeError(
                "engine='host' requires the native library (g++)")
    if table is None:
        table = count_indexed_device_table(data, starts, lengths)
    table._read_seconds = t2 - t1
    return table, len(lengths)


def _read_and_count_table_streamed(filename, engine: str, size: int,
                                   stream_bytes: int):
    """Bounded-memory ingest: index+gather+count one byte-range slice at
    a time (record-synced boundaries - the exact decisions of the
    multi-host sharder, io.fastq.fastq_sync), keep only each slice's
    compact unique table, and merge once at the end.

    Host engine: per-slice native hash counts, merged with ONE weighted
    native count over the concatenated unique rows (counts as weights -
    csrc ssq_host_count_w), all host-side.  Device engine: per-slice
    device tables fetched to compact host tuples, merged with one device
    unique_count per width (count/checkpoint.merge_host_tuples).  Either
    way peak RSS is O(slice + total uniques) instead of O(file)
    (tests/test_streaming_ingest.py asserts the cap in a subprocess).
    """
    import numpy as np

    from ..count.ingest import packed_buckets
    from ..count.table import CountTable
    from ..io.fastq import read_fastq_index
    from ..io.native import get_lib, host_count_native, \
        host_count_weighted_native

    use_host = engine in ("auto", "host") and get_lib() is not None
    if engine == "host" and get_lib() is None:
        raise RuntimeError("engine='host' requires the native library (g++)")
    n_slices = -(-size // stream_bytes)
    by_width: dict[int, list] = {}
    t_read = 0.0
    n_reads = 0
    for s in range(n_slices):
        lo = s * size // n_slices
        hi = (s + 1) * size // n_slices
        t0 = time.time()
        data, starts, lengths = read_fastq_index(filename,
                                                 byte_range=(lo, hi))
        t_read += time.time() - t0
        n_reads += len(lengths)
        if len(lengths) == 0:
            continue
        if use_host:
            for words, sub_len in packed_buckets(data, starts, lengths,
                                                 pad_pow2=False):
                by_width.setdefault(words.shape[1], []).append(
                    host_count_native(words, sub_len))
        else:
            from ..dist.pipeline import _table_to_host

            t = count_indexed_device_table(data, starts, lengths)
            for b in t._buckets:
                by_width.setdefault(b.width, []).append(
                    _table_to_host((b.words, b.lengths, b.counts,
                                    b.n_unique)))
        del data, starts, lengths  # the slice buffer must not outlive
        # the iteration - holding two slices would double the RSS bound
    if use_host:
        tables = []
        for width, parts in sorted(by_width.items()):
            if len(parts) == 1:
                tables.append(parts[0])
                continue
            w = np.concatenate([p[0] for p in parts])
            lens = np.concatenate([p[1] for p in parts])
            c = np.concatenate([p[2] for p in parts]).astype(np.int64)
            tables.append(host_count_weighted_native(w, lens, c))
        table = CountTable.from_host_tables(tables)
    else:
        from ..count.checkpoint import merge_host_tuples

        table = CountTable.from_device_tables(
            [merge_host_tuples(parts)
             for _, parts in sorted(by_width.items())])
    table._read_seconds = t_read
    return table, n_reads


def read_and_count_fastq_table(filename, engine: str = "auto"):
    """Lazy form of read_and_count_fastq: returns a count.table.CountTable
    instead of a materialized dict, so partial consumers (`--top N`,
    len/total, membership probes) never pay for constructing millions of
    Python objects.  Same engine policy and identical logical contents;
    call .to_counter() for the reference-identical dict."""
    from ..utils.profiling import PhaseTimings, phase_timer

    timings = PhaseTimings()
    with phase_timer("total", timings):
        table, n_reads = _read_and_count_table(filename, engine)
        n_unique = len(table)  # forces the device n_unique fetch: honest
    timings.add("read", table._read_seconds)
    timings.add("count", timings.phases["total"] - table._read_seconds)
    print(f"{timings.phases['read']:.2f}s to read {n_reads} total seqs, "
          f"and {timings.phases['count']:.2f}s to count "
          f"{n_unique} unique sequences")
    return table
