"""Reference-shaped benchmark suite (reference tests/benchmark.py:44-165):
memory by length, construction time, hamming time - plus the device
batch throughputs the reference cannot express.  Results are printed as
aligned tables and saved as a timestamped .txt next to this file
(mirroring the reference's benchmarks/*/*.txt flow, :207-275).

--plots additionally reproduces the reference's three README figures
(doc/plots/{mem_by_length,from_bytes_time,edit_distance_time}.svg,
generators reference benchmark.py:44-79,88-123,125-165,207-275) with this
repo's numbers, committed to docs/plots/.  Deep sizes come from
utils.memory.deep_sizeof (a pympler.asizeof equivalent - pympler is not
in this environment); the memory plot adds the batched SoA bytes/read
series the reference has no analog for, and the gzip-9 per-sequence
floor.  umi_tools and SciPy are absent here, so the edit-distance plot
compares object / str-zip / numpy / batched-device instead of the
reference's umi_tools/SciPy columns (noted on the figure).

Run: python benchmarks/benchmark.py [--quick] [--plots]
"""

from __future__ import annotations

import argparse
import random
import sys
import time
from datetime import datetime
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def rand_seq(rng, length):
    return "".join(rng.choice("ACTG") for _ in range(length))


def bench_memory_by_length(out):
    """Object bytes per sequence length vs str/bytes (the reference's
    mem_by_length plot, benchmark.py:44-79)."""
    import shortseq_tpu as sq

    rng = random.Random(0)
    print("\n== memory by length (bytes/object) ==", file=out)
    print(f"{'nt':>5} {'ShortSeq':>9} {'str':>6} {'bytes':>6} {'saving':>7}",
          file=out)
    for length in (1, 16, 32, 33, 64, 96, 97, 256, 512, 1024):
        s = rand_seq(rng, length)
        obj = sys.getsizeof(sq.pack(s))
        st = sys.getsizeof(s)
        by = sys.getsizeof(s.encode())
        print(f"{length:>5} {obj:>9} {st:>6} {by:>6} "
              f"{100 * (1 - obj / st):>6.1f}%", file=out)


def bench_construction(out, n=20000):
    """Scalar construction time from bytes (reference benchmark.py:88-123
    asserts the microsecond scale) and batched construction throughput."""
    import shortseq_tpu as sq

    rng = random.Random(1)
    print("\n== construction from bytes ==", file=out)
    for length in (16, 32, 64, 96, 256, 1024):
        data = [rand_seq(rng, length).encode() for _ in range(n)]
        t0 = time.perf_counter()
        for b in data:
            sq.from_bytes(b)
        dt = (time.perf_counter() - t0) / n
        print(f"{length:>5} nt: {dt * 1e6:>8.2f} us/seq  "
              f"({sq.BACKEND} objects)", file=out)

    print("\n== batched device pack (PackedBatch) ==", file=out)
    import jax

    for length in (32, 96, 160):
        seqs = [rand_seq(rng, length) for _ in range(n)]
        sq.pack_batch(seqs)  # compile
        t0 = time.perf_counter()
        b = sq.pack_batch(seqs)
        jax.block_until_ready(b.words)
        dt = time.perf_counter() - t0
        print(f"{length:>5} nt x {n}: {n * length / dt / 1e9:>6.2f} B nt/s "
              f"(incl. host staging)", file=out)


def bench_hamming(out, n=20000):
    """Hamming time: scalar objects vs str-zip oracle vs batched device
    rows (reference benchmark.py:125-165's comparison shape)."""
    import jax

    import shortseq_tpu as sq

    rng = random.Random(2)
    print("\n== hamming distance ==", file=out)
    for length in (32, 96, 512):
        a = [rand_seq(rng, length) for _ in range(n)]
        b = [rand_seq(rng, length) for _ in range(n)]
        pa = [sq.pack(s) for s in a]
        pb = [sq.pack(s) for s in b]

        t0 = time.perf_counter()
        for x, y in zip(pa, pb):
            x ^ y
        t_obj = (time.perf_counter() - t0) / n

        t0 = time.perf_counter()
        for x, y in zip(a[:2000], b[:2000]):
            sum(c != d for c, d in zip(x, y))
        t_str = (time.perf_counter() - t0) / 2000

        ba, bb = sq.pack_batch(a), sq.pack_batch(b)
        ba.hamming(bb)  # compile
        t0 = time.perf_counter()
        jax.block_until_ready(ba.hamming(bb))
        t_dev = (time.perf_counter() - t0) / n

        print(f"{length:>5} nt: object {t_obj * 1e9:>8.1f} ns  "
              f"str-zip {t_str * 1e9:>10.1f} ns  "
              f"device-row {t_dev * 1e9:>8.1f} ns", file=out)


def bench_dedup(out, n=1 << 18):
    """End-to-end dedup throughput vs collections.Counter
    (reference unit_tests_profiling.py:107-136's comparison)."""
    import collections

    import numpy as np

    import shortseq_tpu as sq
    from shortseq_tpu.batch import PackedBatch

    rng = np.random.default_rng(3)
    pool = ["".join(random.Random(i).choices("ACTG", k=24))
            for i in range(n // 8)]
    reads = [pool[i] for i in rng.integers(0, len(pool), n)]

    t0 = time.perf_counter()
    c_py = collections.Counter(reads)
    t_py = time.perf_counter() - t0

    batch = PackedBatch.from_seqs(reads[:1024])  # compile
    batch.counts()
    t0 = time.perf_counter()
    c_dev = PackedBatch.from_seqs(reads).counts()
    t_dev = time.perf_counter() - t0

    assert sorted(c_dev.values()) == sorted(c_py.values()), "dedup mismatch"
    print(f"\n== dedup {n} reads ({len(c_py)} unique) ==", file=out)
    print(f"collections.Counter: {n / t_py / 1e6:>6.2f} M reads/s", file=out)
    print(f"device sort-unique : {n / t_dev / 1e6:>6.2f} M reads/s "
          f"(incl. host staging + Counter materialization)", file=out)


# -- plots (reference doc/plots/*.svg shapes) ---------------------------

# dataviz reference palette, categorical slots in fixed order (validated
# instance; see the skill's references/palette.md)
_SURFACE = "#fcfcfb"
_TEXT = "#0b0b0b"
_TEXT2 = "#52514e"
_GRID = "#e7e6e2"
_SERIES = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100", "#e87ba4"]
_NEUTRAL = "#8a8984"

_PLOT_LENGTHS = [1, 4, 8, 16, 32, 33, 48, 64, 96, 97, 128, 256, 512, 1024]


def _styled_axes(plt, title, xlabel, ylabel):
    fig, ax = plt.subplots(figsize=(7.2, 4.2), dpi=100)
    fig.patch.set_facecolor(_SURFACE)
    ax.set_facecolor(_SURFACE)
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    for side in ("left", "bottom"):
        ax.spines[side].set_color(_GRID)
    ax.grid(True, color=_GRID, linewidth=0.7)
    ax.set_axisbelow(True)
    ax.tick_params(colors=_TEXT2, labelsize=9)
    ax.set_title(title, color=_TEXT, fontsize=12, loc="left", pad=12)
    ax.set_xlabel(xlabel, color=_TEXT2, fontsize=10)
    ax.set_ylabel(ylabel, color=_TEXT2, fontsize=10)
    return fig, ax


def _finish(fig, ax, path):
    leg = ax.legend(frameon=False, fontsize=9, labelcolor=_TEXT2)
    for line in leg.get_lines():
        line.set_linewidth(2.5)
    fig.tight_layout()
    fig.savefig(path, format="svg", facecolor=_SURFACE)
    print(f"wrote {path}")


def _bucket_lanes(length):
    return 2 if length <= 32 else 6 if length <= 96 else 64


def plot_memory(plt, plots_dir):
    """Deep bytes per sequence vs length: objects, SoA batch, str, bytes,
    numpy, and the gzip-9 floor (reference benchmark.py:44-79)."""
    import gzip

    import numpy as np

    import shortseq_tpu as sq
    from shortseq_tpu.utils.memory import deep_sizeof

    rng = random.Random(0)
    rows = {k: [] for k in ("ShortSeq object", "PackedBatch (SoA, per read)",
                            "str", "bytes", "numpy array", "gzip -9 floor")}
    for length in _PLOT_LENGTHS:
        s = rand_seq(rng, length)
        rows["ShortSeq object"].append(deep_sizeof(sq.pack(s)))
        rows["PackedBatch (SoA, per read)"].append(
            4 * _bucket_lanes(length) + 4)  # words row + int32 length
        rows["str"].append(deep_sizeof(s))
        rows["bytes"].append(deep_sizeof(s.encode()))
        rows["numpy array"].append(
            deep_sizeof(np.frombuffer(s.encode(), np.uint8).copy()))
        rows["gzip -9 floor"].append(
            len(gzip.compress(s.encode(), 9)))

    fig, ax = _styled_axes(plt, "Memory per sequence (deep size)",
                           "sequence length (nt)", "bytes")
    ax.set_xscale("log", base=2)
    ax.set_yscale("log")
    for i, (name, ys) in enumerate(rows.items()):
        if name == "gzip -9 floor":
            ax.plot(_PLOT_LENGTHS, ys, "--", color=_NEUTRAL, linewidth=1.6,
                    label=name)
        else:
            ax.plot(_PLOT_LENGTHS, ys, "-o", color=_SERIES[i], linewidth=2,
                    markersize=4.5, label=name)
    _finish(fig, ax, plots_dir / "mem_by_length.svg")
    return rows


def _device_pack_per_seq(length, n=1 << 16, k0=4):
    """Per-sequence seconds of the device pack kernel at this length,
    loop-slope-timed (bench.slope_time): per-dispatch latency is of the
    order of the whole batch's kernel, so K iterations run inside one
    compiled fori_loop and fixed costs cancel."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bench import _make_batch, slope_time
    from shortseq_tpu.ops.bitpack import pack_words

    width = max(16, -(-length // 16) * 16)
    mat, _ = _make_batch(k0 * n, width, seed=length)
    big = jnp.asarray(mat)

    @jax.jit
    def loop(x_all, k):
        def body(i, acc):
            x = jax.lax.dynamic_slice_in_dim(x_all, (i % k0) * n, n, 0)
            return acc ^ jnp.bitwise_xor.reduce(pack_words(x).ravel())
        return jax.lax.fori_loop(0, k, body, jnp.uint32(0))

    k_hi = int(max(64, min(512, 2e9 / (n * width))))
    return slope_time(loop, (big,), rounds=3, k_lo=4, k_hi=k_hi) / n


def plot_construction(plt, plots_dir, n=5000):
    """Seconds per sequence constructed from bytes: scalar objects, the
    batched path including its Python-string host staging, and the raw
    device pack kernel (reference benchmark.py:88-123; its y-axis
    assertion is the 1e-6 s scale, marked)."""
    import jax

    import shortseq_tpu as sq

    rng = random.Random(1)
    scalar, staged, kernel = [], [], []
    for length in _PLOT_LENGTHS:
        data = [rand_seq(rng, length).encode() for _ in range(n)]
        t0 = time.perf_counter()
        for b in data:
            sq.from_bytes(b)
        scalar.append((time.perf_counter() - t0) / n)

        # Two-size slope cancels the fixed ~29 ms dispatch cost; what
        # remains is dominated by staging n Python strings into a matrix,
        # which is the honest cost of feeding the device FROM strings.
        seqs = [d.decode() for d in data]
        big = seqs * 4
        sq.pack_batch(seqs), sq.pack_batch(big)  # compile both shapes
        t0 = time.perf_counter()
        jax.block_until_ready(sq.pack_batch(seqs).words)
        t1 = time.perf_counter()
        jax.block_until_ready(sq.pack_batch(big).words)
        t2 = time.perf_counter()
        staged.append(max((t2 - t1) - (t1 - t0), 1e-12) / (3 * n))

        kernel.append(_device_pack_per_seq(length))

    fig, ax = _styled_axes(plt, "Construction from bytes",
                           "sequence length (nt)", "seconds per sequence")
    ax.set_xscale("log", base=2)
    ax.set_yscale("log")
    ax.axhline(1e-6, color=_NEUTRAL, linewidth=1.2, linestyle="--")
    ax.text(_PLOT_LENGTHS[0], 1.15e-6, "1 µs (reference's asserted "
            "scale)", color=_TEXT2, fontsize=8)
    ax.plot(_PLOT_LENGTHS, scalar, "-o", color=_SERIES[0], linewidth=2,
            markersize=4.5, label=f"scalar pack ({sq.BACKEND} objects)")
    ax.plot(_PLOT_LENGTHS, staged, "-o", color=_SERIES[1], linewidth=2,
            markersize=4.5, label="batched pack incl. Python-string staging")
    ax.plot(_PLOT_LENGTHS, kernel, "-o", color=_SERIES[2], linewidth=2,
            markersize=4.5, label="device pack kernel (matrix input)")
    _finish(fig, ax, plots_dir / "from_bytes_time.svg")
    return {"scalar": scalar, "staged": staged, "device_kernel": kernel}


def _device_hamming_per_pair(length, n=1 << 17, k0=4):
    """Per-pair seconds of the batched row-hamming kernel, loop-slope-
    timed (see _device_pack_per_seq for why two-dispatch deltas fail)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bench import slope_time
    from shortseq_tpu.ops.hamming import hamming_rows

    lanes = 2 * max(1, -(-length // 32))
    rng = np.random.default_rng(length)
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

    k_hi = int(max(64, min(512, 2e9 / (n * lanes * 8))))
    return slope_time(loop, (a, b), rounds=3, k_lo=4, k_hi=k_hi) / n


def plot_hamming(plt, plots_dir, n=5000):
    """Seconds per hamming pair: objects, str-zip, numpy vectorized,
    batched device rows (reference benchmark.py:125-165; umi_tools and
    SciPy are not installed in this environment - noted on the figure)."""
    import jax
    import numpy as np

    import shortseq_tpu as sq

    rng = random.Random(2)
    series = {"ShortSeq ^ (objects)": [], "str zip": [],
              "numpy (vectorized)": [], "device rows (amortized)": []}
    lengths = [L for L in _PLOT_LENGTHS if L >= 4]
    for length in lengths:
        a = [rand_seq(rng, length) for _ in range(n)]
        b = [rand_seq(rng, length) for _ in range(n)]
        pa, pb = [sq.pack(s) for s in a], [sq.pack(s) for s in b]
        t0 = time.perf_counter()
        for x, y in zip(pa, pb):
            x ^ y
        series["ShortSeq ^ (objects)"].append((time.perf_counter() - t0) / n)

        m = min(n, 1000)
        t0 = time.perf_counter()
        for x, y in zip(a[:m], b[:m]):
            sum(c != d for c, d in zip(x, y))
        series["str zip"].append((time.perf_counter() - t0) / m)

        na = np.frombuffer("".join(a).encode(), np.uint8).reshape(n, length)
        nb = np.frombuffer("".join(b).encode(), np.uint8).reshape(n, length)
        t0 = time.perf_counter()
        (na != nb).sum(axis=1)
        series["numpy (vectorized)"].append((time.perf_counter() - t0) / n)

        series["device rows (amortized)"].append(
            _device_hamming_per_pair(length))

    fig, ax = _styled_axes(plt, "Hamming distance per pair",
                           "sequence length (nt)", "seconds per pair")
    ax.set_xscale("log", base=2)
    ax.set_yscale("log")
    for i, (name, ys) in enumerate(series.items()):
        ax.plot(lengths, ys, "-o", color=_SERIES[i], linewidth=2,
                markersize=4.5, label=name)
    ax.text(0.0, -0.18, "umi_tools / SciPy not installed in this "
            "environment; reference compares those too",
            transform=ax.transAxes, color=_TEXT2, fontsize=8)
    _finish(fig, ax, plots_dir / "edit_distance_time.svg")
    return series


def make_plots(out, quick=False):
    import matplotlib

    matplotlib.use("svg")
    import matplotlib.pyplot as plt

    plots_dir = Path(__file__).resolve().parent.parent / "docs" / "plots"
    plots_dir.mkdir(parents=True, exist_ok=True)
    n = 500 if quick else 5000
    mem = plot_memory(plt, plots_dir)
    print("\n== plot data: memory (bytes) ==", file=out)
    for name, ys in mem.items():
        print(f"{name:>28}: {ys}", file=out)
    cons = plot_construction(plt, plots_dir, n=n)
    print("\n== plot data: construction (s/seq) ==", file=out)
    for name, ys in cons.items():
        print(f"{name:>28}: {['%.2e' % y for y in ys]}", file=out)
    ham = plot_hamming(plt, plots_dir, n=n)
    print("\n== plot data: hamming (s/pair) ==", file=out)
    for name, ys in ham.items():
        print(f"{name:>28}: {['%.2e' % y for y in ys]}", file=out)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--plots", action="store_true",
                        help="write the reference's three figures to "
                             "docs/plots/*.svg")
    args = parser.parse_args()

    n = 2000 if args.quick else 20000

    class Tee:
        def __init__(self, *files):
            self.files = files

        def write(self, s):
            for f in self.files:
                f.write(s)

        def flush(self):
            for f in self.files:
                f.flush()

    stamp = datetime.now().strftime("%Y%m%d-%H%M%S")
    out_path = Path(__file__).parent / f"results-{stamp}.txt"
    with open(out_path, "w") as f:
        out = Tee(sys.stdout, f)
        if args.plots:
            make_plots(out, quick=args.quick)
        else:
            bench_memory_by_length(out)
            bench_construction(out, n)
            bench_hamming(out, n)
            bench_dedup(out, 1 << (14 if args.quick else 18))
    print(f"\nsaved {out_path}")


if __name__ == "__main__":
    main()
