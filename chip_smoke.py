"""Smoke run of the device paths on an NVIDIA GPU.

    python chip_smoke.py             # one card: every phase below
    python chip_smoke.py --cards 4   # four cards: only the sharded path

One card runs, through the entry points a user calls and at the size of
the reference's profiling scenario:

  fastq_10m      10 M reads of 15-32 nt through
                 read_and_count_fastq(engine="device") and the CLI's
                 `count --engine device --top 20`, against the host engine;
  width_ladder   1 M reads over the 15-32 / 33-96 / 97-1,024 nt classes
                 (2-, 6- and 64-lane unique_count), against the host engine;
  pack_validate  pack_and_validate_rows / pack_batch / hamming_rows /
                 PackedBatch.pairwise at 2^18 x 160 nt and 2^15 x 1,024 nt,
                 against numpy and the scalar oracle;
  pairwise       every pairwise-Hamming formulation at 2, 6 and 64 lanes on
                 the [512, 16384] calibration slab, against numpy;
  umi_dedup      dedup_umis(method="directional") on 100 k 12-nt UMIs x 3,
                 with neighbour slabs against numpy;
  umi_oracle     dedup_umis against the pure-Python oracle;
  kernel_times   the pairwise formulations, the dot pack beside a plain
                 shift-or pack, and the UMI dedup under each formulation.

Four cards run read_and_count_fastq_distributed on the 10 M-read file over
a 4-card `data` mesh against the host engine, the checks of
__graft_entry__.dryrun_multichip(4), and the sharded UMI adjacency against
the single-card one.

Every check is exact (tests/chip_checks.py; the `chip`-marked tests run
the same functions).  Times printed are wall-clock smoke timings of one
run, not benchmark numbers.  Everything runs in this one process: a second
JAX process on the card would fail for want of memory.  The last stdout
line is one JSON object; the script exits non-zero, without it, when JAX
finds no GPU, the native host library did not build, or any check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

import shortseq_tpu  # noqa: E402
from tests import chip_checks  # noqa: E402

FASTQ_READS = 10_000_000
LADDER_READS = 1_000_000
UMIS = 100_000


def _say(msg):
    print(msg, flush=True)


def _card_lines():
    """The cards' name and power limit, from a child that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()


def _peak_bytes():
    import jax

    return max((d.memory_stats() or {}).get("peak_bytes_in_use", 0)
               for d in jax.local_devices())


def _phase(name, fn, *args, **kwargs):
    t0 = time.perf_counter()
    facts = fn(*args, **kwargs)
    wall = time.perf_counter() - t0
    _say(f"phase {name}: ok wall_s={wall:.3f} (smoke timing, not a "
         f"benchmark) peak_bytes_in_use={_peak_bytes()} "
         f"{json.dumps(facts, default=str)}")
    return facts


def _fastq(workdir, name, n, **kwargs):
    path = os.path.join(workdir, name)
    t0 = time.perf_counter()
    size = chip_checks.make_fastq(path, n, **kwargs)
    _say(f"generated {name}: {n} reads, {size} bytes in "
         f"{time.perf_counter() - t0:.1f}s")
    return path


def _device_seconds(fn, *args, reps=50):
    """Mean seconds per call of a jitted device function: one compiling
    call, then `reps` back-to-back calls (they queue on the device in
    order) and one wait on the last."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def _shift_or_pack(x_u32):
    """Plain elementwise 2-bit pack of [N, W4] uint32 (4 ASCII bytes per
    lane) -> [N, W4 / 4]: per-lane SWAR compaction of the 4 codes into the
    low byte, then four shifted ORs."""
    import jax.numpy as jnp

    c = (x_u32 >> 1) & jnp.uint32(0x03030303)
    c = (c | (c >> 6) | (c >> 12) | (c >> 18)) & jnp.uint32(0xFF)
    c = c.reshape(c.shape[0], -1, 4)
    return (c[..., 0] | (c[..., 1] << 8) | (c[..., 2] << 16)
            | (c[..., 3] << 24))


def kernel_times():
    """Times of the formulations the ROADMAP asks about, on this card."""
    import jax
    import jax.numpy as jnp

    from shortseq_tpu.ops.bitpack import (fold_for, pack_and_validate_folded,
                                          pack_folded)
    from shortseq_tpu.ops.pallas_kernels import calibrate_pairwise
    from shortseq_tpu.umi import dedup

    facts = {}
    # Pairwise Hamming: per-call seconds on the [512, 16384] slab, by the
    # calibration's own slope timing.
    for w in (2, 6, 64):
        facts[f"pairwise_w{w}_s"] = calibrate_pairwise(w, force=True)

    # Pack: the row-folded dot formulations beside a plain shift-or pack,
    # on 2^18 rows x 160 nt resident on the device.
    n, width = 1 << 18, 160
    w4 = width // 4
    rng = np.random.default_rng(0)
    mat = chip_checks._ACTG[rng.integers(0, 4, size=(n, width),
                                         dtype=np.uint8)]
    x = np.ascontiguousarray(mat).view(np.uint32)
    lengths = np.full(n, width, np.int32)
    plain = jax.jit(_shift_or_pack)
    x_d = jnp.asarray(x)
    f_pack = fold_for(w4, n, target_lanes=512)
    f_fused = fold_for(w4, n)
    x_pack = jnp.asarray(x.reshape(n // f_pack, f_pack * w4))
    x_fused = jnp.asarray(x.reshape(n // f_fused, f_fused * w4))
    l_fused = jnp.asarray(lengths.reshape(n // f_fused, f_fused))
    dot_words = np.asarray(pack_folded(x_pack, w4))
    chip_checks._check(np.array_equal(np.asarray(plain(x_d)), dot_words),
                       "shift-or pack differs from the dot pack")
    nt = n * width
    for name, fn, args in (
            ("pack_dot", lambda a: pack_folded(a, w4), (x_pack,)),
            ("pack_validate_dot",
             lambda a, b: pack_and_validate_folded(a, b, w4, pad_valid=True),
             (x_fused, l_fused)),
            ("pack_shift_or", plain, (x_d,))):
        s = _device_seconds(fn, *args)
        facts[f"{name}_s"] = s
        facts[f"{name}_nt_per_s"] = nt / s

    # The 100 k-UMI directional dedup under each pairwise formulation.
    # The neighbour program resolves its formulation when it is traced,
    # so each formulation gets a fresh program.
    mat = chip_checks.rand_umis(UMIS)
    items = [mat[i].tobytes() for i in range(UMIS)] * 3
    from shortseq_tpu.ops.pallas_kernels import _FORMULATIONS

    saved = os.environ.get("SHORTSEQ_TPU_PAIRWISE")
    try:
        for name in _FORMULATIONS:
            os.environ["SHORTSEQ_TPU_PAIRWISE"] = name
            dedup._NEIGHBOR_STEP = None
            dedup.dedup_umis(items, threshold=1, method="directional")
            runs = []
            for _ in range(3):
                t0 = time.perf_counter()
                dedup.dedup_umis(items, threshold=1, method="directional")
                runs.append(time.perf_counter() - t0)
            facts[f"umi_dedup_{name}_s"] = sorted(runs)
    finally:
        if saved is None:
            os.environ.pop("SHORTSEQ_TPU_PAIRWISE", None)
        else:
            os.environ["SHORTSEQ_TPU_PAIRWISE"] = saved
        dedup._NEIGHBOR_STEP = None
    return facts


def one_card(workdir):
    path = _fastq(workdir, "reads10m.fastq", FASTQ_READS)
    _phase("fastq_10m", chip_checks.check_fastq_dedup, path, FASTQ_READS)
    os.unlink(path)
    path = _fastq(workdir, "ladder1m.fastq", LADDER_READS, seed=1,
                  ladder=True)
    _phase("width_ladder", chip_checks.check_width_ladder, path,
           LADDER_READS)
    os.unlink(path)
    _phase("pack_validate_160", chip_checks.check_pack_validate, 1 << 18, 160)
    _phase("pack_validate_1024", chip_checks.check_pack_validate, 1 << 15,
           1024, seed=1)
    _phase("pairwise", chip_checks.check_pairwise_formulations)
    _phase("umi_dedup", chip_checks.check_umi_dedup, UMIS)
    _phase("umi_oracle", chip_checks.check_umi_oracle)
    _phase("kernel_times", kernel_times)


def four_cards(workdir):
    import jax

    import __graft_entry__
    from shortseq_tpu.api.counter import read_and_count_fastq
    from shortseq_tpu.dist import (data_mesh, read_and_count_fastq_distributed,
                                   table_to_counter)
    from shortseq_tpu.umi.dedup import _neighbor_lists, _pack_validate_umis

    check = chip_checks._check
    mesh = data_mesh()
    check(mesh.devices.size == 4, f"mesh has {mesh.devices.size} devices")

    def sharded_count(path):
        host = read_and_count_fastq(path, engine="host")
        t0 = time.perf_counter()
        table = read_and_count_fastq_distributed(path)
        jax.block_until_ready(table.counts)
        dist_s = time.perf_counter() - t0
        cards = len(table.counts.sharding.device_set)
        check(table.layout == "scattered" and cards == 4,
              f"merged table: layout {table.layout}, on {cards} card(s)")
        check(table_to_counter(table) == host,
              "sharded count differs from the host engine")
        return {"reads": FASTQ_READS, "unique": len(host),
                "layout": table.layout, "table_cards": cards,
                "distributed_s": dist_s}

    path = _fastq(workdir, "reads10m.fastq", FASTQ_READS)
    _phase("sharded_fastq_10m", sharded_count, path)
    os.unlink(path)

    def dryrun():
        __graft_entry__.dryrun_multichip(4)
        return {"checks": ["bucketed layouts", "skewed-key all_gather "
                           "fallback", "adapter-dimer pre-dedup stays "
                           "scattered", "lazy distributed top-k",
                           "sharded UMI step"]}

    _phase("dryrun_multichip", dryrun)

    def sharded_umi():
        mat = chip_checks.rand_umis(UMIS)
        words, lengths = _pack_validate_umis(
            [mat[i].tobytes() for i in range(UMIS)])
        words = np.asarray(words)
        one = _neighbor_lists(words, lengths, 1)
        four = _neighbor_lists(words, lengths, 1, mesh=mesh)
        check(all(np.array_equal(a, b) for a, b in zip(one, four)),
              "sharded UMI neighbours differ from the single-card ones")
        return {"unique": UMIS, "edges": int(sum(map(len, one)))}

    _phase("sharded_umi_adjacency", sharded_umi)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4 runs only the sharded path, on four cards")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"error: JAX finds no GPU (platform {devices[0].platform!r})",
              file=sys.stderr)
        return 1
    if len(devices) < args.cards:
        print(f"error: {args.cards} cards asked, JAX finds {len(devices)}",
              file=sys.stderr)
        return 1
    from shortseq_tpu.io.native import get_lib

    native = get_lib() is not None
    if not native or shortseq_tpu.BACKEND != "native":
        print(f"error: native host library not built (io {native}, "
              f"objects {shortseq_tpu.BACKEND})", file=sys.stderr)
        return 1

    _say("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader:")
    for line in _card_lines():
        _say(line)
    _say(f"device_kind: {devices[0].device_kind}; devices: {len(devices)}")
    _say(f"shortseq_tpu.BACKEND: {shortseq_tpu.BACKEND}; native io "
         f"library loaded: {native}")
    _say("compile cache: "
         f"{jax.config.jax_compilation_cache_dir or 'none'}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        if args.cards == 4:
            four_cards(workdir)
        else:
            one_card(workdir)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
