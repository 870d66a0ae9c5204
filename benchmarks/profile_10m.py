"""The reference's 10M-read profiling scenario, end to end on the device.

Mirrors /root/reference/shortseq/tests/unit_tests_profiling.py:24-37 and
107-136: generate ~10M reads of 15-32 nt, run the full dedup pipeline
(read_and_count_fastq: file I/O -> native sharder -> device pack+count ->
host Counter materialization), and compare wall time, RSS and the count
multiset against collections.Counter over the same bytes.

Usage: python benchmarks/profile_10m.py [--n 10000000] [--out FILE.json]
Prints one JSON line; also exercises count-multiset parity (the
reference's dedup-parity oracle, :136) unless --no-parity.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def make_fastq(path, n, seed=0, min_len=15, max_len=32,
               length_classes=None):
    """Write `n` uniform random ACTG reads as FASTQ (reference make_data's
    shape: reads of min_len..max_len nt).  `length_classes`, a list of
    (min_len, max_len) ranges, instead draws each read's range uniformly
    from the list (the width ladder).  Vectorized: each chunk is one
    padded byte matrix whose live cells are compacted with one mask, so
    10 M reads take seconds.  Returns the file size in bytes."""
    rng = np.random.default_rng(seed)
    classes = np.asarray(length_classes or [(min_len, max_len)], np.int64)
    top = int(classes[:, 1].max())
    alphabet = np.frombuffer(b"ACTG", np.uint8)
    head = 11                    # "@r" + 8 digits + "\n"
    width = head + 2 * top + 4   # + seq + "\n+\n" + qual + "\n"
    chunk = max(1, (256 << 20) // width)
    col = np.arange(width)
    with open(path, "wb") as f:
        for lo in range(0, n, chunk):
            m = min(chunk, n - lo)
            cls = classes[rng.integers(0, len(classes), size=m)]
            lens = rng.integers(cls[:, 0], cls[:, 1] + 1)[:, None]
            rec = np.full((m, width), ord("I"), np.uint8)
            rec[:, 0], rec[:, 1] = ord("@"), ord("r")
            ids = (lo + np.arange(m)) % 10**8
            for d in range(8):
                rec[:, 9 - d] = 48 + (ids // 10**d) % 10
            rec[:, 10] = ord("\n")
            seq = alphabet[rng.integers(0, 4, size=(m, top), dtype=np.uint8)]
            in_seq = col[None, head:head + top] < head + lens
            rec[:, head:head + top] = np.where(in_seq, seq, ord("I"))
            # Place "\n+\n", the quality run and the final newline right
            # after each read's sequence, then drop the unused tail.
            sep = head + lens                 # [m, 1]
            rec[col[None, :] == sep] = ord("\n")
            rec[col[None, :] == sep + 1] = ord("+")
            rec[col[None, :] == sep + 2] = ord("\n")
            end = sep + 3 + lens
            rec[col[None, :] == end] = ord("\n")
            keep = col[None, :] <= end
            f.write(rec[keep].tobytes())
    return os.path.getsize(path)


def rss_mb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--out", default=None)
    ap.add_argument("--no-parity", action="store_true")
    ap.add_argument("--keep", default=None,
                    help="reuse/keep the FASTQ at this path")
    ap.add_argument("--engine", default="auto",
                    choices=("auto", "host", "device"))
    ap.add_argument("--top", type=int, default=0,
                    help="lazy-table mode: fetch only the top-N rows "
                         "(read_and_count_fastq_table + most_common), the "
                         "production `count --top N` path")
    ap.add_argument("--runs", type=int, default=1,
                    help="repeat the pipeline N times; report the first "
                         "run separately as cold and {median,min,max} over "
                         "the warm runs")
    args = ap.parse_args()

    path = args.keep or os.path.join(tempfile.mkdtemp(), "profile10m.fastq")
    if not (args.keep and os.path.exists(path)):
        t0 = time.time()
        size = make_fastq(path, args.n)
        gen_s = time.time() - t0
    else:
        size, gen_s = os.path.getsize(path), 0.0

    from shortseq_tpu.api.counter import read_and_count_fastq

    rss0 = rss_mb()

    def one_run():
        if args.top:
            from shortseq_tpu.api.counter import read_and_count_fastq_table

            t0 = time.time()
            table = read_and_count_fastq_table(path, engine=args.engine)
            t_count = time.time()
            top = table.most_common(args.top)
            wall = time.time() - t0
            n_unique = len(table)
            phases = {"count_s": round(t_count - t0, 2),
                      "topn_fetch_s": round(wall - (t_count - t0), 2),
                      "materialized_rows": len(top)}
            assert len(top) == min(args.top, n_unique)
            return wall, n_unique, phases, None
        t0 = time.time()
        counts = read_and_count_fastq(path, engine=args.engine)
        return time.time() - t0, len(counts), {}, counts

    walls = []
    for _ in range(max(1, args.runs)):
        wall, n_unique, phases, counts = one_run()
        walls.append(wall)
    rss1 = rss_mb()
    if len(walls) > 1:
        import statistics

        warm = sorted(walls[1:])
        wall = warm[0]  # headline: best warm run (steady state)
        stats = {"cold_first_run_s": round(walls[0], 2),
                 "warm_median_s": round(statistics.median(warm), 2),
                 "warm_min_s": round(warm[0], 2),
                 "warm_max_s": round(warm[-1], 2),
                 "n_runs": len(walls)}
    else:
        stats = {"n_runs": 1}

    result = {
        "metric": ("top_n_dedup_reads_per_s" if args.top
                   else "end_to_end_dedup_reads_per_s"),
        "engine": args.engine,
        "n_reads": args.n,
        "top": args.top or None,
        "file_bytes": size,
        "wall_s": wall,
        "reads_per_s": args.n / wall,
        "n_unique": n_unique,
        "rss_before_mb": round(rss0, 1),
        "rss_after_mb": round(rss1, 1),
        "gen_s": round(gen_s, 1),
        "backend": ("host-native" if args.engine != "device"
                    else __import__("jax").devices()[0].platform),
        **phases,
        **stats,
    }
    if args.top:
        args.no_parity = True  # nothing materialized to compare

    if not args.no_parity:
        # The reference's oracle: collections.Counter over the raw bytes,
        # compared as a count multiset (unit_tests_profiling.py:136).
        import collections

        from shortseq_tpu.io.fastq import read_fastq_lines

        t0 = time.time()
        py_counts = collections.Counter(read_fastq_lines(path))
        result["python_counter_s"] = round(time.time() - t0, 2)
        result["python_counter_reads_per_s"] = args.n / (time.time() - t0)
        assert sorted(counts.values()) == sorted(py_counts.values()), \
            "count multiset mismatch vs collections.Counter"
        assert len(counts) == len(py_counts)
        result["parity"] = "ok"
        result["speedup_vs_counter"] = result["python_counter_s"] / wall

    line = json.dumps(result)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")
    if not args.keep:
        os.unlink(path)


if __name__ == "__main__":
    main()
