"""Exact parity checks of the device paths at real widths.

One set of functions serves three callers: `chip_smoke.py`, which runs
them on the GPU at the sizes of the reference's profiling scenario; the
`chip`-marked tests (tests/test_chip.py), which run them on the card and
skip where JAX finds no GPU; and small-size CPU tests that keep the
checks themselves exercised.  Every result on these paths is an integer
(words, counts, distances, flags), so every comparison is exact.  Each
reference is independent of the code under test: the native host hash
count, numpy bit arithmetic, the scalar oracle (shortseq_tpu.oracle) or
the pure-Python UMI oracle (tests/test_umi_differential.py).

Each check raises AssertionError on a mismatch (explicitly, so it also
holds under `python -O`) and returns a dict of facts for the caller to
report.
"""

from __future__ import annotations

import os
import time

import numpy as np

_ACTG = np.frombuffer(b"ACTG", np.uint8)


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def popcount32(x: np.ndarray) -> np.ndarray:
    """Bit count of each uint32 (SWAR; no dependence on numpy's version)."""
    x = x.astype(np.uint32)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * np.uint32(0x01010101)) >> 24).astype(np.int32)


def numpy_pack(mat: np.ndarray) -> np.ndarray:
    """Plain 2-bit pack of an [N, L] ASCII matrix (L % 16 == 0): base i of
    a row at lane i // 16, bits 2 * (i % 16), code (byte >> 1) & 3.
    Zero tail bytes give code 0."""
    n, width = mat.shape
    codes = ((mat >> 1) & 3).astype(np.uint32).reshape(n, width // 16, 16)
    shifts = (2 * np.arange(16, dtype=np.uint32))
    return np.bitwise_or.reduce(codes << shifts, axis=2)


def numpy_hamming(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Hamming distance of packed rows, broadcasting a against b: XOR,
    collapse each 2-bit field to one bit, popcount, sum over lanes."""
    c = a ^ b
    c = ((c >> 1) | c) & np.uint32(0x55555555)
    return popcount32(c).sum(axis=-1)


def make_fastq(path, n, seed=0, ladder=False):
    """The reference's profiling-scenario FASTQ (uniform A/C/T/G reads of
    15-32 nt), or with ladder=True a file split about evenly over the
    15-32, 33-96 and 97-1,024 nt width classes."""
    from benchmarks.profile_10m import make_fastq as _make

    classes = [(15, 32), (33, 96), (97, 1024)] if ladder else None
    return _make(path, n, seed=seed, length_classes=classes)


def check_fastq_dedup(path, n_reads, top=20):
    """read_and_count_fastq(engine="device") and the CLI's
    `count --engine device --top N` against the native host engine, which
    shares nothing with the device sort."""
    from shortseq_tpu import pack
    from shortseq_tpu.__main__ import main as cli_main
    from shortseq_tpu.api.counter import read_and_count_fastq

    host = read_and_count_fastq(path, engine="host")
    _check(sum(host.values()) == n_reads,
           f"host engine counted {sum(host.values())} reads, not {n_reads}")
    t0 = time.perf_counter()
    device = read_and_count_fastq(path, engine="device")
    device_s = time.perf_counter() - t0
    _check(len(device) == len(host),
           f"device engine: {len(device)} unique keys, host {len(host)}")
    _check(device == host, "device engine counts differ from the host engine")
    del device

    out = f"{path}.top.tsv"
    t0 = time.perf_counter()
    rc = cli_main(["count", str(path), "--engine", "device", "--top",
                   str(top), "--output", out])
    cli_s = time.perf_counter() - t0
    _check(rc == 0, f"CLI count exited {rc}")
    with open(out) as f:
        rows = [line.split("\t") for line in f.read().splitlines()]
    os.unlink(out)
    _check(len(rows) == min(top, len(host)),
           f"CLI printed {len(rows)} rows, expected {min(top, len(host))}")
    for seq, count in rows:
        _check(host[pack(seq)] == int(count),
               f"CLI count for {seq}: {count}, host {host[pack(seq)]}")
    want = sorted(host.values())[-len(rows):] if rows else []
    _check(sorted(int(c) for _, c in rows) == want,
           "CLI top counts are not the host engine's top counts")
    return {"reads": n_reads, "unique": len(host),
            "device_engine_s": device_s, "cli_top_s": cli_s}


def check_width_ladder(path, n_reads):
    """The device engine on a file that fills the 2-, 6- and 64-lane
    unique_count (the 64-lane class takes the hash-prefix sort), against
    the host engine."""
    from shortseq_tpu.api.counter import (read_and_count_fastq,
                                          read_and_count_fastq_table)

    host = read_and_count_fastq(path, engine="host")
    _check(sum(host.values()) == n_reads, "host engine lost reads")
    table = read_and_count_fastq_table(path, engine="device")
    widths = sorted(b.width for b in table._buckets)
    _check(widths == [2, 6, 64], f"device buckets have lane widths {widths}")
    device = table.to_counter()
    _check(device == host, "device engine counts differ from the host engine "
                           "on the width ladder")
    return {"reads": n_reads, "unique": len(host), "lane_widths": widths}


def _ragged_batch(n, width, seed):
    """[n, width] ACTG rows of random lengths, zero past each length, with
    rows 0..255 each holding one byte value 0..255 at a random in-range
    position (every bloom alias and every rejected byte)."""
    rng = np.random.default_rng(seed)
    mat = _ACTG[rng.integers(0, 4, size=(n, width), dtype=np.uint8)]
    lengths = rng.integers(0, width + 1, size=n).astype(np.int32)
    k = min(256, n)
    lengths[:k] = np.maximum(lengths[:k], 1)
    pos = rng.integers(0, lengths[:k])
    mat[np.arange(k), pos] = np.arange(k, dtype=np.uint8)
    mat[np.arange(width)[None, :] >= lengths[:, None]] = 0
    return np.ascontiguousarray(mat), lengths


def check_pack_validate(n, width, seed=0, sample=64):
    """pack_and_validate_rows and pack_batch on an [n, width] batch
    against a plain numpy pack and the reference bloom, plus the scalar
    oracle (encode_bytes + blocks_to_lanes) on a sample of rows; then
    hamming_rows and PackedBatch.pairwise against numpy XOR + collapse +
    popcount."""
    import jax.numpy as jnp

    from shortseq_tpu import oracle
    from shortseq_tpu.batch import PackedBatch, pack_batch
    from shortseq_tpu.ops import hamming_rows, pack_and_validate_rows

    mat, lengths = _ragged_batch(n, width, seed)
    words_d, ok_d = pack_and_validate_rows(mat.view(np.uint32), lengths)
    words, ok = np.asarray(words_d), np.asarray(ok_d)

    byte_ok = np.array([oracle.is_base(b) for b in range(256)])
    in_row = np.arange(width)[None, :] < lengths[:, None]
    ok_ref = np.all(byte_ok[mat] | ~in_row, axis=1)
    _check(np.array_equal(ok, ok_ref), "validity flags differ from the bloom")
    _check(ok_ref[:256].sum() < 256 and ok_ref.sum() > n // 2,
           "the batch must hold both valid and rejected rows")
    words_ref = numpy_pack(mat)
    _check(np.array_equal(words[ok_ref], words_ref[ok_ref]),
           "packed words differ from the numpy pack")
    lanes = width // 16
    good = np.flatnonzero(ok_ref)
    for i in good[:: max(1, len(good) // sample)][:sample]:
        want = oracle.blocks_to_lanes(
            oracle.encode_bytes(mat[i, :lengths[i]].tobytes()), lanes)
        _check(words[i].tolist() == want, f"row {i} differs from the oracle")

    # pack_batch: the object-list entry point on valid rows.
    rows = good[:4096]
    batch = pack_batch([mat[i, :lengths[i]].tobytes() for i in rows])
    bw = np.asarray(batch.words)
    _check(np.array_equal(bw, words_ref[rows, :bw.shape[1]])
           and not words_ref[rows, bw.shape[1]:].any(),
           "pack_batch words differ from the numpy pack")

    half = len(good) // 2
    a, b = good[:half], good[half:2 * half]
    dist = np.asarray(hamming_rows(words_d[a], words_d[b]))
    _check(np.array_equal(dist, numpy_hamming(words_ref[a], words_ref[b])),
           "hamming_rows differs from numpy")

    m = min(1024, half)
    pb = PackedBatch(words_d[good[:m]], jnp.asarray(lengths[good[:m]]))
    other = PackedBatch(words_d[good[m:3 * m]],
                        jnp.asarray(lengths[good[m:3 * m]]))
    pair = np.asarray(pb.pairwise(other))
    want = numpy_hamming(words_ref[good[:m]][:, None, :],
                         words_ref[good[m:3 * m]][None, :, :])
    _check(np.array_equal(pair, want), "PackedBatch.pairwise differs from "
                                       "numpy")
    return {"rows": n, "width_nt": width, "rejected_rows": int((~ok).sum()),
            "pairs_checked": int(pair.size)}


def rand_umis(u, length=12, seed=0):
    """u DISTINCT random UMIs of `length` nt, as an [u, length] uint8
    matrix."""
    rng = np.random.default_rng(seed)
    ids = rng.choice(4 ** length, size=u, replace=False)
    digits = (ids[:, None] >> (2 * np.arange(length))[None, :]) & 3
    return np.ascontiguousarray(_ACTG[digits])


def check_umi_dedup(u=100_000, dup=3, slabs=4, seed=0):
    """dedup_umis(method="directional") on u distinct 12-nt UMIs x dup
    (the bench shape).  Equal counts admit no directional edge, so every
    distinct UMI must be its own cluster; and the device neighbour lists
    of `slabs` 512-row slabs must equal a numpy XOR + popcount
    adjacency."""
    from shortseq_tpu.umi.dedup import (_neighbor_lists,
                                        _pack_validate_umis, dedup_umis)

    mat = rand_umis(u, seed=seed)
    uniq = [mat[i].tobytes() for i in range(u)]
    items = uniq * dup
    t0 = time.perf_counter()
    labels, reps = dedup_umis(items, threshold=1, method="directional")
    dedup_s = time.perf_counter() - t0
    _check(len(labels) == len(items) and len(reps) == u,
           f"{len(reps)} clusters for {u} equal-count UMIs")
    rep_of = np.asarray(reps, dtype=f"S{mat.shape[1]}")[labels]
    _check(np.array_equal(rep_of, np.asarray(items, dtype=rep_of.dtype)),
           "a UMI is not the representative of its own cluster")

    words, lengths = _pack_validate_umis(uniq)
    words = np.asarray(words)
    ref = numpy_pack(np.pad(mat, ((0, 0), (0, 32 - mat.shape[1]))))
    _check(np.array_equal(words, ref), "UMI words differ from the numpy pack")
    nbrs = _neighbor_lists(words, lengths, 1)
    rows = min(512, u)
    starts = np.linspace(0, u - rows, slabs).astype(int)
    edges = 0
    for lo in starts:
        for r0 in range(lo, lo + rows, 128):
            r1 = min(r0 + 128, lo + rows)
            dist = numpy_hamming(ref[r0:r1, None, :], ref[None, :, :])
            for r in range(r0, r1):
                want = np.flatnonzero(dist[r - r0] <= 1)
                want = want[want != r]
                _check(np.array_equal(np.sort(nbrs[r]), want),
                       f"neighbours of UMI {r} differ from numpy")
                edges += len(want)
    return {"umis": len(items), "unique": u, "clusters": len(reps),
            "dedup_s": dedup_s, "slab_rows_checked": int(slabs * rows),
            "slab_edges": edges}


def clustered_umis(n_true, seed=0, length=12):
    """True molecules with skewed duplication plus 1-3-substitution error
    variants: the structure directional collapse exists for."""
    import random

    rng = random.Random(seed)
    out = []
    for base in rand_umis(n_true, length, seed):
        base = base.tobytes()
        dup = rng.choice([1, 2, 3, 5, 9, 17, 40])
        out += [base] * dup
        for _ in range(rng.randint(0, 3)):
            var = bytearray(base)
            for _ in range(rng.randint(1, 2)):
                i = rng.randrange(length)
                var[i] = rng.choice([c for c in b"ACGT" if c != var[i]])
            out += [bytes(var)] * rng.choice([1, 1, 2, dup])
    rng.shuffle(out)
    return out


def check_umi_oracle(n_true=3600, seed=0):
    """dedup_umis against the pure-Python O(U^2) oracle: the same
    representative for every input UMI and the same cluster count."""
    from tests.test_umi_differential import oracle_dedup_umis

    from shortseq_tpu.umi.dedup import dedup_umis

    items = clustered_umis(n_true, seed)
    labels, reps = dedup_umis(items, threshold=1, method="directional")
    t0 = time.perf_counter()
    want, n_clusters = oracle_dedup_umis(items, 1, "directional")
    oracle_s = time.perf_counter() - t0
    _check(len(reps) == n_clusters,
           f"{len(reps)} clusters, oracle {n_clusters}")
    _check([reps[i] for i in labels] == want,
           "representatives differ from the oracle")
    return {"umis": len(items), "unique": len(set(items)),
            "clusters": n_clusters, "oracle_s": oracle_s}


def check_pairwise_formulations(widths=(2, 6, 64), rows=512, cols=16384,
                                ref_cols=2048, seed=0):
    """Every pairwise formulation (ops.pallas_kernels._FORMULATIONS) at
    each lane width on a [rows] x [cols] slab: all bit-identical, and
    equal to numpy on the first ref_cols columns."""
    import jax.numpy as jnp

    from shortseq_tpu.ops.pallas_kernels import _FORMULATIONS

    rng = np.random.default_rng(seed)
    out = {}
    for w in widths:
        a = rng.integers(0, 2**32, size=(rows, w), dtype=np.uint64) \
            .astype(np.uint32)
        b = rng.integers(0, 2**32, size=(cols, w), dtype=np.uint64) \
            .astype(np.uint32)
        want = numpy_hamming(a[:, None, :], b[None, :ref_cols, :])
        results = {name: np.asarray(fn(jnp.asarray(a), jnp.asarray(b)))
                   for name, fn in _FORMULATIONS.items()}
        first = next(iter(results.values()))
        for name, got in results.items():
            _check(got.shape == (rows, cols), f"{name} w={w}: {got.shape}")
            _check(np.array_equal(got[:, :ref_cols], want),
                   f"{name} differs from numpy at w={w}")
            _check(np.array_equal(got, first),
                   f"{name} differs from the other formulations at w={w}")
        out[f"w{w}"] = sorted(results)
    return out
