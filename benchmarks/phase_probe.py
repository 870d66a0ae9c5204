"""Phase-by-phase timing of the end-to-end dedup pipeline at scale.

Decomposes read_and_count_fastq's wall time into parse / h2d+pack /
sort-count / d2h fetch / dict materialization so the slow phase is
identifiable.

Usage: python benchmarks/phase_probe.py [--n 10000000] [--keep PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

from benchmarks.profile_10m import make_fastq


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--keep", default="/tmp/profile10m.fastq")
    args = ap.parse_args()

    path = args.keep
    if not os.path.exists(path):
        t0 = time.time()
        make_fastq(path, args.n)
        print(f"gen: {time.time()-t0:.1f}s", flush=True)

    import jax
    import jax.numpy as jnp

    from shortseq_tpu.api.counter import (ShortSeqCounter,
                                          update_counter_from_host_table)
    from shortseq_tpu.count import count_batch
    from shortseq_tpu.count.device import PAD_LENGTH
    from shortseq_tpu.io.fastq import read_fastq_matrix
    from shortseq_tpu.ops.bitpack import pack_and_validate_u32

    t0 = time.time()
    mat, lengths = read_fastq_matrix(path)
    t_parse = time.time() - t0
    print(f"parse: {t_parse:.2f}s  ({len(lengths)} reads, mat {mat.shape})",
          flush=True)

    # Bucket prep (all reads are <=32 nt in this scenario)
    t0 = time.time()
    m = len(lengths)
    m_pad = max(256, 1 << (m - 1).bit_length())
    rows = np.ascontiguousarray(mat[:, :32])
    sub_len = lengths.astype(np.int32)
    if m_pad != m:
        rows = np.pad(rows, ((0, m_pad - m), (0, 0)))
        sub_len = np.pad(sub_len, (0, m_pad - m), constant_values=PAD_LENGTH)
    val_len = np.where(sub_len == PAD_LENGTH, 0, sub_len).astype(np.int32)
    rows_u32 = np.ascontiguousarray(rows).view(np.uint32)
    t_prep = time.time() - t0
    print(f"host pad/prep: {t_prep:.2f}s (m_pad={m_pad})", flush=True)

    t0 = time.time()
    d_rows = jnp.asarray(rows_u32)
    d_vlen = jnp.asarray(val_len)
    d_slen = jnp.asarray(sub_len)
    jax.block_until_ready((d_rows, d_vlen, d_slen))
    t_h2d = time.time() - t0
    print(f"h2d ({rows_u32.nbytes/1e6:.0f} MB): {t_h2d:.2f}s", flush=True)

    t0 = time.time()
    words, ok = pack_and_validate_u32(d_rows, d_vlen)
    jax.block_until_ready((words, ok))
    t_pack = time.time() - t0
    print(f"pack+validate (incl. compile): {t_pack:.2f}s", flush=True)

    t0 = time.time()
    ok_host = np.asarray(ok)[:m]
    t_okfetch = time.time() - t0
    print(f"ok fetch: {t_okfetch:.2f}s  all_ok={bool(ok_host.all())}",
          flush=True)

    t0 = time.time()
    u_w, u_l, u_c, n_u = count_batch(words, d_slen)
    jax.block_until_ready((u_w, u_l, u_c, n_u))
    t_count = time.time() - t0
    print(f"sort-count (incl. compile): {t_count:.2f}s", flush=True)

    t0 = time.time()
    u_w, u_l, u_c, n_u = jax.device_get((u_w, u_l, u_c, n_u))
    t_d2h = time.time() - t0
    nbytes = u_w.nbytes + u_l.nbytes + u_c.nbytes
    print(f"d2h ({nbytes/1e6:.0f} MB): {t_d2h:.2f}s  n_unique={int(n_u)}",
          flush=True)

    t0 = time.time()
    counts = ShortSeqCounter()
    n_live = int(n_u)
    update_counter_from_host_table(
        counts, np.asarray(u_w)[:n_live], np.asarray(u_l)[:n_live],
        np.asarray(u_c)[:n_live])
    t_mat = time.time() - t0
    print(f"materialize ({n_live} keys): {t_mat:.2f}s", flush=True)

    total = t_parse + t_prep + t_h2d + t_pack + t_okfetch + t_count + t_d2h + t_mat
    print(json.dumps({
        "parse": round(t_parse, 2), "prep": round(t_prep, 2),
        "h2d": round(t_h2d, 2), "pack": round(t_pack, 2),
        "ok_fetch": round(t_okfetch, 2), "count": round(t_count, 2),
        "d2h": round(t_d2h, 2), "materialize": round(t_mat, 2),
        "total": round(total, 2)}), flush=True)


if __name__ == "__main__":
    main()
