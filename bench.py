"""Benchmark harness: the LAST stdout line is ONE compact JSON object with
the headline metric.  Per-run spread statistics go to a separate preceding
stdout line and the BENCH_STATS.json sidecar, never onto the headline line.

Headline: fused 2-bit pack + bloom-validate throughput in nucleotides/second
on one GPU, vs the BASELINE.json target of 1e9 nt/s/chip (the reference
publishes no absolute throughput - see BASELINE.md - so the target is the
baseline).  It runs only on a GPU and fails anywhere else.

Method: each kernel bench runs K iterations INSIDE one compiled program
(lax.fori_loop cycling over disjoint slices of a resident buffer, results
folded into a loop-carried scalar so nothing is eliminated), and the
reported time is the SLOPE between a K_LO- and a K_HI-iteration dispatch,
so fixed costs (dispatch, transfers, loop setup) cancel; the MEDIAN of
per-round slopes filters stalls (see slope_time).

Also measured (in "extra"): device pack without validation, raw
read-reduce, row-wise hamming, all-pairs hamming over EVERY formulation
(asserting the calibrated auto choice is the fastest measured), device
dedup, host table materialization, end-to-end FASTQ counts and UMI dedup,
and per-dispatch latency.  Every entry ships with {median, min, max,
n_runs} and a separated cold-compile cost in the BENCH_STATS.json sidecar.
"""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

BASELINE_NT_PER_S = 1e9
K_LO, K_HI = 8, 40

#: Per-bench run statistics: {name: {median, min, max, n_runs,
#: cold_first_dispatch_s}} - every headline number ships with its spread
#: and its cold-compile cost separated from steady state, so a reader can
#: tell signal from noise.
RUN_STATS = {}


def _record_stats(name, per_run, cold_s=None):
    import statistics

    runs = sorted(float(x) for x in per_run)
    if not runs:
        return
    RUN_STATS[name] = {
        "median": statistics.median(runs),
        "min": runs[0],
        "max": runs[-1],
        "n_runs": len(runs),
        **({"cold_first_dispatch_s": round(cold_s, 3)}
           if cold_s is not None else {}),
    }


def _make_batch(n, width, seed=0):
    rng = np.random.default_rng(seed)
    lengths = np.full(n, width, dtype=np.int32)
    codes = rng.integers(0, 4, size=(n, width)).astype(np.uint8)
    ascii_mat = np.frombuffer(b"ACTG", dtype=np.uint8)[codes]
    return np.ascontiguousarray(ascii_mat.astype(np.uint8)), lengths


def slope_time(loop, args, rounds=5, k_lo=K_LO, k_hi=K_HI, name=None):
    """Per-iteration seconds: slope between k_lo- and k_hi-iteration
    dispatches of `loop(*args, k)`, MEDIAN of per-round slopes.

    k_hi must be large enough that the k_hi - k_lo work delta is >= ~5 ms,
    else the slope drowns in per-dispatch jitter.

    Median, not min: a min-per-K aggregation takes min(t_lo) and min(t_hi)
    from DIFFERENT rounds, so one fast t_hi under a stalled t_lo yields an
    impossible rate.  The median of per-round slopes is robust to that;
    per-round slopes + the cold first dispatch (compile) are recorded in
    RUN_STATS with median/min/max so the spread stays visible."""
    import statistics

    k_span = k_hi - k_lo
    k_lo, k_hi = jnp.int32(k_lo), jnp.int32(k_hi)
    # device_get of the loop-carried scalar waits for the program; the
    # fetch is a fixed cost per dispatch, which the slope cancels.
    t_cold0 = time.perf_counter()
    jax.device_get(loop(*args, k_hi))  # compile + warm
    cold_s = time.perf_counter() - t_cold0
    round_slopes = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        jax.device_get(loop(*args, k_lo))
        t1 = time.perf_counter()
        jax.device_get(loop(*args, k_hi))
        t2 = time.perf_counter()
        round_slopes.append(((t2 - t1) - (t1 - t0)) / k_span)
    if name is not None:
        _record_stats(name, round_slopes, cold_s=cold_s)
    return statistics.median(round_slopes)


def bench_pack(n=1 << 18, width=160, k0=8, pad_valid=True,
               stat_name="pack_nt_per_s_chip"):
    """Fused pack + bloom-validate per pass over an [n, width] slice - the
    production row-folded one-dot kernel (ops.bitpack.
    pack_and_validate_folded, what pack_and_validate_rows dispatches for
    host batches).  The headline measures the pad_valid contract the
    in-repo matrix builders satisfy (constants.PAD_BYTE tails); the
    length-masked general path is reported as pack_masked_nt_per_s."""
    from shortseq_tpu.ops.bitpack import fold_for, pack_and_validate_folded

    w4 = width // 4
    fold = fold_for(w4, n)
    mat, lens = _make_batch(k0 * n, width)
    big = jnp.asarray(mat.view(np.uint32).reshape(k0 * n // fold, fold * w4))
    lengths_f = jnp.asarray(lens[:n].reshape(n // fold, fold))
    nf = n // fold

    @jax.jit
    def loop(x_all, lengths_f, k):
        def body(i, acc):
            x = jax.lax.dynamic_slice_in_dim(x_all, (i % k0) * nf, nf, 0)
            w, ok = pack_and_validate_folded(x, lengths_f, w4, unfold=False,
                                             pad_valid=pad_valid)
            # XOR fold blocks reduce(dot) -> dot(reduce) rewrites (see
            # bench_pack_only).
            return (acc ^ jnp.bitwise_xor.reduce(w.ravel())
                    ^ jnp.sum(ok).astype(jnp.uint32))
        return jax.lax.fori_loop(0, k, body, jnp.uint32(0))

    # 42 MB/pass: k_hi=232 keeps the slope's work delta ~9.4 GB of
    # input, far above the host's timer jitter.
    dt = slope_time(loop, (big, lengths_f), k_hi=232, name=stat_name)
    return n * width / dt


def bench_pack_only(n=1 << 18, width=160, k0=8):
    """Pack without validation (the from_matrix construction path):
    pack-only folded kernel at its larger fold (ops.bitpack.pack_rows
    dispatch)."""
    from shortseq_tpu.ops.bitpack import fold_for, pack_folded

    w4 = width // 4
    fold = fold_for(w4, n, target_lanes=512)
    mat, _ = _make_batch(k0 * n, width)
    big = jnp.asarray(mat.view(np.uint32).reshape(k0 * n // fold, fold * w4))
    nf = n // fold

    @jax.jit
    def loop(x_all, k):
        def body(i, acc):
            x = jax.lax.dynamic_slice_in_dim(x_all, (i % k0) * nf, nf, 0)
            w = pack_folded(x, w4, unfold=False)
            # XOR fold, not a plain sum: XLA's algebraic simplifier can
            # rewrite reduce(dot(...)) into dot(reduce(...)) and skip the
            # pack entirely.
            return acc ^ jnp.bitwise_xor.reduce(w.ravel())
        return jax.lax.fori_loop(0, k, body, jnp.uint32(0))

    dt = slope_time(loop, (big,), k_hi=232, name="pack_only_nt_per_s")
    return n * width / dt


def bench_pack_unfolded(n=1 << 18, width=160, k0=8):
    """The pre-fold formulation (pack_and_validate_u32 on [n, w4] rows),
    kept for regression context."""
    from shortseq_tpu.ops.bitpack import pack_and_validate_u32

    mat, lens = _make_batch(k0 * n, width)
    big = jnp.asarray(mat.view(np.uint32))
    lengths = jnp.asarray(lens[:n])

    @jax.jit
    def loop(x_all, lengths, k):
        def body(i, acc):
            x = jax.lax.dynamic_slice_in_dim(x_all, (i % k0) * n, n, 0)
            w, ok = pack_and_validate_u32(x, lengths)
            return (acc ^ jnp.bitwise_xor.reduce(w.ravel())
                    ^ jnp.sum(ok).astype(jnp.uint32))
        return jax.lax.fori_loop(0, k, body, jnp.uint32(0))

    dt = slope_time(loop, (big, lengths), name="pack_unfolded_nt_per_s")
    return n * width / dt


def bench_raw_stream(n=1 << 18, width=160, k0=8):
    """Roofline context: raw uint32 read-reduce over the same buffer, GB/s."""
    mat, _ = _make_batch(k0 * n, width)
    big = jnp.asarray(mat.view(np.uint32))
    w4 = width // 4

    @jax.jit
    def loop(x_all, k):
        def body(i, acc):
            x = jax.lax.dynamic_slice_in_dim(x_all, (i % k0) * n, n, 0)
            return acc + jnp.sum(x, dtype=jnp.uint32)
        return jax.lax.fori_loop(0, k, body, jnp.uint32(0))

    # A 42 MB/pass read-reduce is short; k_hi=264 keeps the span's work
    # delta far above the host's timer jitter.
    dt = slope_time(loop, (big,), k_hi=264, name="raw_stream_bytes_per_s")
    return n * w4 * 4 / dt


def bench_hamming(n=1 << 18, lanes=6, k0=8):
    from shortseq_tpu.ops.hamming import hamming_rows

    rng = np.random.default_rng(1)
    a = jnp.asarray(rng.integers(0, 2**32, size=(k0 * n, lanes),
                                 dtype=np.uint64).astype(np.uint32))
    b = jnp.asarray(rng.integers(0, 2**32, size=(k0 * n, lanes),
                                 dtype=np.uint64).astype(np.uint32))

    @jax.jit
    def loop(a_all, b_all, k):
        def body(i, acc):
            x = jax.lax.dynamic_slice_in_dim(a_all, (i % k0) * n, n, 0)
            y = jax.lax.dynamic_slice_in_dim(b_all, (i % k0) * n, n, 0)
            return acc + jnp.sum(hamming_rows(x, y))
        return jax.lax.fori_loop(0, k, body, jnp.int32(0))

    # ~6 MB/pass: needs many more iterations than the default for a
    # measurable slope.
    dt = slope_time(loop, (a, b), k_hi=512, name="hamming_pairs_per_s")
    return n / dt


def bench_pairwise(n=4096, lanes=2, k0=8):
    """All-pairs hamming: slope-times EVERY formulation
    (pallas_kernels._FORMULATIONS), returns the auto-selected path's
    pairs/s, and asserts the calibrated auto choice is the fastest
    measured (within 15% jitter tolerance).  SHORTSEQ_TPU_PAIRWISE
    overrides still narrow the bench to that single path.  The per-
    formulation rates and the choice are returned for the report."""
    import os

    from shortseq_tpu.ops import pallas_kernels

    rng = np.random.default_rng(4)
    a = jnp.asarray(rng.integers(0, 2**32, size=(k0 * n, lanes),
                                 dtype=np.uint64).astype(np.uint32))
    b = jnp.asarray(rng.integers(0, 2**32, size=(n, lanes),
                                 dtype=np.uint64).astype(np.uint32))

    # Path canary: the auto dispatch must honor an override.
    override = os.environ.get("SHORTSEQ_TPU_PAIRWISE", "")
    jax.block_until_ready(pallas_kernels.pairwise_hamming_auto(a[:256], b[:256]))
    choice = pallas_kernels.LAST_PAIRWISE_PATH
    if override and choice != override:
        raise RuntimeError(
            f"pairwise override {override!r} not honored: {choice}")

    fns = dict(pallas_kernels._FORMULATIONS)
    if override:
        fns = {override: fns[override]}

    def _rate(pair_fn, stat_name):
        @jax.jit
        def loop(a_all, b_one, k):
            def body(i, acc):
                x = jax.lax.dynamic_slice_in_dim(a_all, (i % k0) * n, n, 0)
                # XOR fold, never a sum: a sum-consumed dot lets XLA
                # rewrite reduce(dot) into dot(reduce) and skip the
                # matmul.
                return acc ^ jnp.bitwise_xor.reduce(pair_fn(x, b_one).ravel())
            return jax.lax.fori_loop(0, k, body, jnp.int32(0))

        # k_hi=512: each iteration is short, and the span must hold
        # >= ~5 ms of work (slope_time docstring).
        return n * n / slope_time(loop, (a, b), k_hi=512,
                                  name=f"pairwise_{stat_name}_pairs_per_s")

    rates = {name: _rate(fn, name) for name, fn in fns.items()}
    if not override:
        fastest = max(rates, key=rates.get)
        if choice != fastest and rates[fastest] > 1.15 * rates[choice]:
            raise RuntimeError(
                f"calibrated pairwise choice {choice!r} is not the fastest "
                f"measured path ({fastest!r} wins: "
                f"{ {k: f'{v:.3g}' for k, v in rates.items()} })")
    return rates.get(choice, max(rates.values())), rates, choice


def bench_dedup(n=1 << 18, width=32, k0=4, k_hi=K_HI,
                stat_name="dedup_reads_per_s"):
    """Pack + sort-unique-count per pass (device-side dedup rate).

    Run per width class (32/96/1024 nt -> 2/6/64-lane unique_count; the
    BASELINE.json metric line asks for all three).
    Wider widths use smaller n so every pass stays tens of MB."""
    from shortseq_tpu.count.device import unique_count
    from shortseq_tpu.ops.bitpack import pack_words_u32

    rng = np.random.default_rng(2)
    pool, _ = _make_batch(n // 4, width, seed=3)
    idx = rng.integers(0, n // 4, size=k0 * n)
    big = jnp.asarray(np.ascontiguousarray(pool[idx]).view(np.uint32))
    lengths = jnp.asarray(np.full(n, width, np.int32))

    @jax.jit
    def loop(x_all, lengths, k):
        def body(i, acc):
            x = jax.lax.dynamic_slice_in_dim(x_all, (i % k0) * n, n, 0)
            _, _, counts, n_u = unique_count(
                pack_words_u32(x), lengths, jnp.ones(n, jnp.int32))
            return acc + jnp.sum(counts) + n_u
        return jax.lax.fori_loop(0, k, body, jnp.int32(0))

    dt = slope_time(loop, (big, lengths), rounds=3, k_hi=k_hi,
                    name=stat_name)
    return n / dt


def bench_materialize(n=1 << 20, lanes=2):
    """Host materialization: device count table -> ShortSeqCounter keys/s
    (native update_from_table)."""
    from shortseq_tpu.api.counter import ShortSeqCounter, \
        update_counter_from_host_table

    rng = np.random.default_rng(5)
    words = rng.integers(0, 2**32, size=(n, lanes), dtype=np.uint64) \
        .astype(np.uint32)
    lengths = np.full(n, 16, np.int32)
    counts = np.ones(n, np.int32)
    runs = []
    for _ in range(3):
        c = ShortSeqCounter()
        t0 = time.perf_counter()
        update_counter_from_host_table(c, words, lengths, counts)
        runs.append(time.perf_counter() - t0)
    _record_stats("materialize_keys_per_s", runs)
    return n / min(runs)


def bench_end_to_end(n=1_000_000, engine="host"):
    """read_and_count_fastq reads/s on a generated 1M-read file (the
    reference's profiling scenario shape, unit_tests_profiling.py:24-37,
    scaled 10x down to keep the bench round short)."""
    import os
    import tempfile

    from benchmarks.profile_10m import make_fastq
    from shortseq_tpu.api.counter import read_and_count_fastq

    import shutil

    tmpdir = tempfile.mkdtemp()
    path = os.path.join(tmpdir, "bench_e2e.fastq")
    try:
        make_fastq(path, n)
        # The FIRST run is recorded separately as the cold run (a device
        # run pays a one-time XLA compile for this batch shape when the
        # persistent cache is cold).  The headline is the best warm run;
        # the stats carry the spread.
        runs = []
        for _ in range(4):  # 1 cold + 3 warm
            t0 = time.perf_counter()
            counts = read_and_count_fastq(path, engine=engine)
            runs.append(time.perf_counter() - t0)
            assert sum(counts.values()) == n
        _record_stats(f"end_to_end_{engine}_reads_per_s", runs[1:],
                      cold_s=runs[0])
        return n / min(runs[1:])
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def bench_umi_dedup(u=100_000, dup=3):
    """Directional UMI dedup at production scale, total UMIs/s (wall,
    warm-cache steady state; benchmarks/umi_scale.py has the validated
    harness + adjacency spot-checks)."""
    from shortseq_tpu.umi import dedup_umis

    rng = np.random.default_rng(0)
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    mat = alphabet[rng.integers(0, 4, size=(u, 12))]
    umis = [mat[i].tobytes() for i in range(u)] * dup
    runs = []
    for _ in range(4):  # 1 cold + 3 warm
        t0 = time.perf_counter()
        labels, reps = dedup_umis(umis, threshold=1, method="directional")
        runs.append(time.perf_counter() - t0)
    assert len(labels) == len(umis) and 0 < len(reps) <= u
    _record_stats("umi_dedup_100k_umis_per_s", runs[1:], cold_s=runs[0])
    return len(umis) / min(runs[1:])


def bench_dispatch(width=160, n=1 << 16):
    """Per-dispatch wall time for a small pack call - isolates the
    dispatch latency the slope benches cancel."""
    from shortseq_tpu.ops.bitpack import pack_and_validate_u32

    a, l = _make_batch(n, width)
    a, l = jnp.asarray(a.view(np.uint32)), jnp.asarray(l)
    jax.block_until_ready(pack_and_validate_u32(a, l))
    runs = []
    for _ in range(8):
        t0 = time.perf_counter()
        jax.block_until_ready(pack_and_validate_u32(a, l))
        runs.append(time.perf_counter() - t0)
    _record_stats("dispatch_latency_s", runs)
    return min(runs)


def _require_gpu():
    """The benchmark measures the GPU and nothing else: fail on any other
    backend instead of reporting its numbers."""
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX finds {platform!r}")


def main():
    _require_gpu()
    nt_per_s = bench_pack()
    rate, rates, choice = bench_pairwise()
    extra = {
        "pack_masked_nt_per_s": bench_pack(1 << 18, 160, 8, False,
                                           "pack_masked_nt_per_s"),
        "pack_only_nt_per_s": bench_pack_only(),
        "pack_unfolded_nt_per_s": bench_pack_unfolded(),
        "raw_stream_bytes_per_s": bench_raw_stream(),
        "hamming_pairs_per_s": bench_hamming(),
        "dedup_reads_per_s": bench_dedup(),
        "dedup_w96_reads_per_s": bench_dedup(1 << 17, 96, 4, K_HI,
                                             "dedup_w96_reads_per_s"),
        "dedup_w1024_reads_per_s": bench_dedup(1 << 15, 1024, 4, 24,
                                               "dedup_w1024_reads_per_s"),
        "materialize_keys_per_s": bench_materialize(),
        "end_to_end_host_reads_per_s": bench_end_to_end(1_000_000, "host"),
        "end_to_end_device_reads_per_s": bench_end_to_end(1_000_000,
                                                          "device"),
        "umi_dedup_100k_umis_per_s": bench_umi_dedup(),
        "dispatch_latency_s": bench_dispatch(),
        "backend": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "pairwise_hamming_pairs_per_s": rate,
        "pairwise_formulation_pairs_per_s": rates,
        "pairwise_auto_choice": choice,
    }
    emit_report(nt_per_s, extra)


def emit_report(nt_per_s, extra, stats=None, stats_path=None):
    """Emit the report.  Contract: the LAST stdout line is ONE compact
    (<4000 B) JSON object with metric/value/unit/vs_baseline/extra.  The
    spread and cold/warm separation behind every number goes to a SIDECAR
    file + a separate PRECEDING stdout line, never onto the headline line,
    whose readers may keep only the tail of the output.  Stats entries
    are per-run SECONDS (invert for rates); slope-timed headline values
    are median-of-rounds, wall benches report best-warm with the spread
    alongside."""
    stats = RUN_STATS if stats is None else stats
    if stats_path is None:
        stats_path = os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "BENCH_STATS.json")
    try:
        with open(stats_path, "w") as f:
            json.dump(stats, f, indent=1, sort_keys=True)
    except OSError:
        pass
    print(json.dumps({"run_stats": stats}), flush=True)
    ok = isinstance(nt_per_s, float)
    report = {
        "metric": "pack_nt_per_s_chip",
        "value": nt_per_s if ok else 0.0,
        "unit": "nt/s",
        "vs_baseline": (nt_per_s / BASELINE_NT_PER_S) if ok else 0.0,
        "extra": extra if ok else {**extra, "pack_error": nt_per_s},
    }
    headline = json.dumps(report)
    if len(headline) >= 4000:  # bloat guard: keep the line parseable
        report["extra"] = {"truncated": "extras exceeded the line budget; "
                                        "see BENCH_STATS.json",
                           "backend": extra.get("backend")}
        headline = json.dumps(report)
    print(headline, flush=True)


if __name__ == "__main__":
    main()
