"""Scaling-efficiency harness: reads/s of the sharded count pipeline at
1..N devices over a `data` mesh (BASELINE target: >=85% efficiency at 2+
hosts).

Weak scaling: per-device load is fixed, so perfect scaling = flat
per-device time = efficiency 1.0 at every device count.

Three merge strategies:
  all_gather       - every device re-sorts all D gathered tables; merge
                     work grows ~linearly with D (simple exact baseline,
                     fine at small D).
  bucketed         - all_to_all key exchange into disjoint ranges, then a
                     final all_gather replication of the dedup'd tables.
  bucketed_sharded - same exchange, table stays SHARDED (production
                     configuration): per-device work and traffic are flat
                     in D, so this is the strategy that meets the >=85%
                     target at scale.

On a machine with several GPUs it runs on the real cards (one process
drives them all); on a dev box run it under a simulated CPU mesh:

    PYTHONPATH=. JAX_PLATFORMS=cpu \
    XLA_FLAGS=--xla_force_host_platform_device_count=4 \
    python benchmarks/scaling.py --out SCALING.json

CPU-mesh caveat: all virtual devices share the
host's cores and XLA:CPU thread pool, so absolute efficiency numbers are
distorted by host contention; the meaningful signal is the TREND across
strategies (whether per-device time grows with D), which is
hardware-independent because it reflects algorithmic work growth.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np


def _make_reads(n, width=32, seed=0, dup=4):
    rng = np.random.default_rng(seed)
    pool = np.frombuffer(b"ACTG", np.uint8)[
        rng.integers(0, 4, size=(n // dup, width))].astype(np.uint8)
    idx = rng.integers(0, n // dup, size=n)
    return pool[idx], np.full(n, width, np.int32)


def _build_step(method, mesh, words, lengths):
    from shortseq_tpu.dist.count import count_sharded, count_sharded_bucketed

    n = words.shape[0]
    ones = jnp.ones(n, jnp.int32)
    if method == "all_gather":
        step_g = count_sharded(mesh)
        return lambda: step_g(words, lengths, ones)[2]
    replicate = method != "bucketed_sharded"
    step_b = count_sharded_bucketed(mesh, replicate=replicate)
    return lambda: step_b(words, lengths, ones)[2]


def run(n_per_device=1 << 17, width=32, method="all_gather", rounds=5):
    from shortseq_tpu.dist.mesh import data_mesh
    from shortseq_tpu.ops.bitpack import pack_words

    devices = jax.devices()
    results = []
    base = None
    for nd in [d for d in (1, 2, 4, 8, 16) if d <= len(devices)]:
        mesh = data_mesh(devices[:nd])
        n = n_per_device * nd
        mat, lens = _make_reads(n, width)
        words = pack_words(jnp.asarray(mat))
        lengths = jnp.asarray(lens)
        step = _build_step(method, mesh, words, lengths)
        jax.block_until_ready(step())  # compile + warm
        best = float("inf")
        for _ in range(rounds):
            t0 = time.perf_counter()
            jax.block_until_ready(step())
            best = min(best, time.perf_counter() - t0)
        rps = n / best
        if base is None:
            base = rps
        eff = rps / (base * nd)
        results.append({"devices": nd, "method": method,
                        "reads_per_s": rps, "per_device_reads_per_s": rps / nd,
                        "efficiency": eff, "time_s": best})
        print(json.dumps(results[-1]))
    return results


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--method", default=None,
                   choices=["all_gather", "bucketed", "bucketed_sharded"])
    p.add_argument("--n-per-device", type=int, default=1 << 17)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    methods = [args.method] if args.method else [
        "all_gather", "bucketed", "bucketed_sharded"]
    all_results = []
    for m in methods:
        all_results += run(method=m, n_per_device=args.n_per_device)
    if args.out:
        payload = {
            "platform": jax.devices()[0].platform,
            "device_kind": jax.devices()[0].device_kind,
            "n_devices_available": len(jax.devices()),
            "n_per_device": args.n_per_device,
            "results": all_results,
        }
        Path(args.out).write_text(json.dumps(payload, indent=1) + "\n")
