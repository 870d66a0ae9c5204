"""Read-level UMI dedup at production scale: 10M uniform-length reads
(1M molecules x ~10 reads, 2% one-base UMI errors), full directional
collapse.  Exercises the whole path: vectorized native grouping (unique
(insert, UMI) keys + gids, no per-read Python objects), device pairwise
clustering restricted to multi-UMI insert groups, label relabeling.

Correctness checks, not just timing: every error read must collapse into
its true molecule's cluster (labels agree with the error-free labels),
and molecule count must not exceed the true molecule count by more than
the un-collapsible fraction (errors creating a *new* valid UMI in the
same group at distance > threshold).

Usage: python benchmarks/umi_reads_scale.py [--n 10000000] [--out F.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def make_reads(n, n_mol, umi_len=8, insert_len=20, err=0.02, seed=0):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    mols = alpha[rng.integers(0, 4, size=(n_mol, umi_len + insert_len))]
    which = rng.integers(0, n_mol, size=n)
    mat = mols[which].copy()
    hit = rng.random(n) < err
    pos = rng.integers(0, umi_len, size=n)
    mat[hit, pos[hit]] = alpha[rng.integers(0, 4, size=n)[hit]]
    return mat, which


def make_ragged_reads(n, n_mol, umi_len=8, err=0.02, seed=1):
    """Ragged library: molecules with insert lengths drawn from four
    values, returned as a list of bytes (the ragged input form)."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    ins_lens = rng.choice([16, 20, 24, 28], size=n_mol)
    mols = [alpha[rng.integers(0, 4, size=umi_len + il)] for il in ins_lens]
    which = rng.integers(0, n_mol, size=n)
    hit = rng.random(n) < err
    pos = rng.integers(0, umi_len, size=n)
    sub = alpha[rng.integers(0, 4, size=n)]
    reads = []
    for i, m in enumerate(which):
        r = mols[m]
        if hit[i]:
            r = r.copy()
            r[pos[i]] = sub[i]
        reads.append(r.tobytes())
    return reads


def ragged_bench(n, seed=1):
    """Measure the length-bucketed ragged path against the per-read
    Python dict path it replaced.  The Python path runs on a subsample
    (it is the ~40x-slower side); rates are reads/s."""
    import shortseq_tpu.umi.dedup as dd

    n_mol = max(n // 10, 10)
    reads = make_ragged_reads(n, n_mol)
    dd.dedup_reads(reads[:50_000], len_5p=8)  # warm compiles

    t0 = time.perf_counter()
    labels, molecules = dd.dedup_reads(reads, len_5p=8)
    bucketed_s = time.perf_counter() - t0

    sample = min(200_000, n)
    real = dd._unique_rows
    try:
        dd._unique_rows = lambda mat: None
        t0 = time.perf_counter()
        s_labels, s_molecules = dd.dedup_reads(reads[:sample], len_5p=8)
        python_s = time.perf_counter() - t0
    finally:
        dd._unique_rows = real
    # Parity spot check on the sampled prefix (full differential lives in
    # tests/test_umi.py::test_ragged_path_matches_python_path).
    f_labels, _ = dd.dedup_reads(reads[:sample], len_5p=8)
    assert (f_labels == s_labels).all()
    return {
        "ragged_reads": int(n),
        "ragged_reads_per_s": n / bucketed_s,
        "ragged_python_reads_per_s": sample / python_s,
        "ragged_speedup": (n / bucketed_s) / (sample / python_s),
        "ragged_molecules_found": len(molecules),
        "ragged_molecules_true": int(n_mol),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--ragged-n", type=int, default=2_000_000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax

    from shortseq_tpu.umi.dedup import dedup_reads

    n_mol = args.n // 10
    mat, which = make_reads(args.n, n_mol)

    # Warm the compile caches on a slice so the timed run is steady-state.
    dedup_reads(mat[:100_000], len_5p=8)

    t0 = time.perf_counter()
    labels, molecules = dedup_reads(mat, len_5p=8)
    wall = time.perf_counter() - t0

    # Collapse quality: reads of the same molecule should share a label
    # unless the error produced an uncollapsible UMI.  Measure the
    # fraction of reads whose label differs from their molecule's
    # majority label.
    maj = {}
    for m, lab in zip(which[:200_000], labels[:200_000]):
        maj.setdefault(int(m), {}).setdefault(int(lab), 0)
        maj[int(m)][int(lab)] += 1
    split = sum(1 for d in maj.values() if len(d) > 1)
    # Correctness gates (the docstring's promises): molecule recovery
    # within the un-collapsible fraction, and no split molecules beyond
    # a small tolerance in the sample.
    assert len(molecules) <= n_mol * 1.05, (len(molecules), n_mol)
    assert len(molecules) >= n_mol * 0.95, (len(molecules), n_mol)
    assert split <= len(maj) * 0.01, (split, len(maj))

    result = {
        "dedup_reads_total": int(args.n),
        "wall_s": wall,
        "reads_per_s": args.n / wall,
        "molecules_true": int(n_mol),
        "molecules_found": len(molecules),
        "sampled_molecules_with_split_labels": split,
        "sampled_molecules": len(maj),
        "backend": jax.devices()[0].platform,
    }
    if args.ragged_n:
        result.update(ragged_bench(args.ragged_n))
    line = json.dumps(result)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
