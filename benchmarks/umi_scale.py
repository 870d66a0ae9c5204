"""UMI clustering at production scale on the device, plus a pairwise
formulation sweep at the three lane widths (2/6/64).

Usage: python benchmarks/umi_scale.py [--u 100000] [--out FILE.json]

Checks, not just timings:
  * one random 512-row slab of the blocked neighbour-list adjacency is
    re-derived by direct dense pairwise and must agree exactly;
  * cluster labels are a valid partition (every UMI labelled, reps exist).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def _rand_umis(u, length, seed=0):
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    mat = alphabet[rng.integers(0, 4, size=(u, length))]
    return [mat[i].tobytes() for i in range(u)]


def pairwise_width_sweep():
    """Per-call seconds of every pairwise formulation at the three width
    classes (2/6/64 lanes) on the [512, 16384] calibration slab, by the
    calibration's own slope timing (ops.pallas_kernels)."""
    from shortseq_tpu.ops.pallas_kernels import calibrate_pairwise

    return {f"pairwise_w{w}_s": calibrate_pairwise(w, force=True)
            for w in (2, 6, 64)}


def umi_dedup_at_scale(u, length=12, dup=3):
    from shortseq_tpu.ops import pallas_kernels
    from shortseq_tpu.umi.dedup import (_neighbor_lists,
                                        _pack_validate_umis, dedup_umis)

    uniq = _rand_umis(u, length)
    umis = uniq * dup
    # Warm the compile caches on a slice first, so the timed run is
    # steady state (compilation is set-up, not throughput).
    dedup_umis(umis[: max(1000, len(umis) // 16)], threshold=1,
               method="directional")
    t0 = time.perf_counter()
    labels, reps = dedup_umis(umis, threshold=1, method="directional")
    wall = time.perf_counter() - t0

    assert len(labels) == len(umis)
    assert labels.min() >= 0 and labels.max() < len(reps)

    # Spot-check one slab of the blocked adjacency against dense pairwise.
    words, lengths = _pack_validate_umis(uniq)
    nbrs = _neighbor_lists(np.asarray(words), lengths, 1)
    rng = np.random.default_rng(7)
    lo = int(rng.integers(0, max(1, u - 512)))
    from shortseq_tpu.ops import hamming_pairwise

    dense = np.asarray(hamming_pairwise(words[lo:lo + 512], words))
    for r in range(0, 512, 97):
        want = set(np.flatnonzero(dense[r] <= 1)) - {lo + r}
        got = set(nbrs[lo + r])
        assert got == want, (lo + r, len(got), len(want))

    return {
        "umi_dedup_wall_s": wall,
        "umi_unique": u,
        "umi_total": len(umis),
        "umi_clusters": len(reps),
        "umis_per_s": len(umis) / wall,
        "pairwise_path": pallas_kernels.LAST_PAIRWISE_PATH,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--u", type=int, default=100_000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    result = umi_dedup_at_scale(args.u)
    result.update(pairwise_width_sweep())
    line = json.dumps(result)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
