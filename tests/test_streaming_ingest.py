"""Bounded-memory streaming ingest (VERDICT r03 next-step 3).

`read_and_count_fastq*` on a file above the streaming threshold counts
byte-range slices (record-synced like the multi-host sharder) and merges
compact unique tables, so host RSS is O(slice + unique table), not
O(file) - the repo analog of the reference's RSS harness
(unit_tests_profiling.py:110-131).  The weighted native count
(ssq_host_count_w) is the host-side exact merge primitive.
"""

import collections
import os
import random
import shutil
import subprocess
import sys

import numpy as np
import pytest

from tests.conftest import REPO_ROOT, scrubbed_cpu_env


def _write_fastq(path, reads):
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")


class TestWeightedNativeCount:
    def test_weighted_merge_is_exact(self):
        from shortseq_tpu.io.native import get_lib, host_count_native, \
            host_count_weighted_native

        if get_lib() is None:
            pytest.skip("native library unavailable")
        rng = np.random.default_rng(7)
        pool = rng.integers(0, 2**32, size=(50, 2), dtype=np.uint64) \
            .astype(np.uint32)
        idx1 = rng.integers(0, 50, 3000)
        idx2 = rng.integers(0, 50, 5000)
        lens = np.full(50, 20, np.int32)
        t1 = host_count_native(pool[idx1], lens[idx1])
        t2 = host_count_native(pool[idx2], lens[idx2])
        w = np.concatenate([t1[0], t2[0]])
        ln = np.concatenate([t1[1], t2[1]])
        c = np.concatenate([t1[2], t2[2]])
        mw, ml, mc = host_count_weighted_native(w, ln, c)
        ref = collections.Counter(
            pool[i].tobytes() for i in np.concatenate([idx1, idx2]))
        got = {mw[i].tobytes(): int(mc[i]) for i in range(len(mc))}
        assert got == dict(ref)
        assert int(mc.sum()) == 8000


class TestStreamedParity:
    """Forcing a tiny threshold must not change any counting result."""

    @pytest.mark.parametrize("engine", ["auto", "device"])
    def test_streamed_equals_whole_file(self, tmp_path, monkeypatch,
                                        engine):
        from shortseq_tpu.api.counter import read_and_count_fastq

        rng = random.Random(0)
        # multi-width + duplicates so every bucket and the merge path run
        pool = ["".join(rng.choices("ACGT", k=rng.choice([16, 40, 150])))
                for _ in range(200)]
        reads = [pool[rng.randrange(len(pool))] for _ in range(3000)]
        path = tmp_path / "s.fastq"
        _write_fastq(path, reads)
        whole = read_and_count_fastq(path, engine=engine)
        monkeypatch.setenv("SHORTSEQ_TPU_STREAM_BYTES", "4096")
        streamed = read_and_count_fastq(path, engine=engine)
        assert streamed == whole
        assert sum(streamed.values()) == 3000

    def test_streamed_lazy_table(self, tmp_path, monkeypatch):
        from shortseq_tpu.api.counter import read_and_count_fastq_table

        rng = random.Random(1)
        reads = ["ACGT" * rng.randint(1, 8) for _ in range(500)]
        path = tmp_path / "t.fastq"
        _write_fastq(path, reads)
        ref = collections.Counter(r.encode() for r in reads)
        monkeypatch.setenv("SHORTSEQ_TPU_STREAM_BYTES", "2048")
        table = read_and_count_fastq_table(path)
        assert len(table) == len(ref)
        assert table.total() == 500
        top = table.most_common(3)
        ref_top = ref.most_common(3)
        assert [c for _, c in top] == [c for _, c in ref_top]

    def test_gzip_keeps_whole_file_path(self, tmp_path, monkeypatch):
        import gzip

        from shortseq_tpu.api.counter import read_and_count_fastq

        reads = ["ACGTACGTACGTACGT"] * 400
        raw = "".join(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n"
                      for i, r in enumerate(reads))
        path = tmp_path / "g.fastq.gz"
        with gzip.open(path, "wb") as f:
            f.write(raw.encode())
        monkeypatch.setenv("SHORTSEQ_TPU_STREAM_BYTES", "1024")
        counts = read_and_count_fastq(path)
        assert sum(counts.values()) == 400 and len(counts) == 1


_RSS_SCRIPT = r"""
import os, sys
sys.path.insert(0, {repo!r})
import shortseq_tpu.api.counter as C
from shortseq_tpu.io.native import get_lib

def _hwm_mb():
    # VmHWM, NOT resource.getrusage: Linux carries ru_maxrss ACROSS
    # fork+exec, so under a fat parent (a long pytest session) getrusage
    # reports the PARENT'S peak at fork as this process's floor - that
    # false reading is exactly what this harness once tripped over.
    # VmHWM belongs to the mm, which exec replaces, so it is truly ours.
    for ln in open("/proc/self/status"):
        if ln.startswith("VmHWM"):
            return int(ln.split()[1]) / 1024
    raise RuntimeError("no VmHWM")

calls = {{}}
_orig_streamed = C._read_and_count_table_streamed
def _spy(filename, engine, size, stream_bytes):
    calls["streamed"] = (size, stream_bytes)
    return _orig_streamed(filename, engine, size, stream_bytes)
C._read_and_count_table_streamed = _spy

# Per-slice high-water trace: on a cap failure this shows whether slice
# buffers accumulate (a retention bug) or one allocation spikes.
import shortseq_tpu.io.fastq as F
_orig_index = F.read_fastq_index
def _traced(filename, byte_range=None):
    r = _orig_index(filename, byte_range=byte_range)
    print(f"SLICE {{byte_range}} hwm={{_hwm_mb():.0f}}", file=sys.stderr)
    return r
F.read_fastq_index = _traced

path = sys.argv[1]
table = C.read_and_count_fastq_table(path, engine=sys.argv[2])
n_unique = len(table)
total = table.total()
rss_mb = _hwm_mb()
# Diagnostics so a cap failure says WHICH path actually ran (whole-file
# vs streamed, native host vs device fallback - each explains a ~3x RSS
# difference on its own).
print(f"DIAG native={{get_lib() is not None}} streamed={{calls}} "
      f"stream_bytes={{C._stream_bytes()}} "
      f"env={{os.environ.get('SHORTSEQ_TPU_STREAM_BYTES')}} "
      f"size={{os.path.getsize(path)}}", file=sys.stderr)
print(f"RESULT {{n_unique}} {{total}} {{rss_mb:.0f}}")
"""


class TestRSSCap:
    """The reference profiling harness's RSS discipline
    (unit_tests_profiling.py:110-131), applied to the streaming contract:
    counting a ~1.2 GB FASTQ with 128 MB slices must stay far below the
    file size in peak RSS.  Runs in a subprocess and measures VmHWM from
    /proc/self/status - NOT getrusage: Linux carries ru_maxrss across
    fork+exec, so a child spawned from a long pytest session (parent RSS
    1-1.5 GB after hundreds of JAX compiles) inherits the parent's peak
    as its floor and fails the cap with the parent's number (observed:
    identical 1571 MB "peaks" across runs that were really the pytest
    process's own RSS at fork).  Scale with SHORTSEQ_TPU_RSS_TEST_BYTES."""

    def test_rss_bounded_by_slice_not_file(self, tmp_path):
        target = int(os.environ.get("SHORTSEQ_TPU_RSS_TEST_BYTES",
                                    1_200_000_000))
        if shutil.disk_usage(tmp_path).free < 3 * target:
            pytest.skip("not enough free disk for the RSS harness")
        rng = random.Random(2)
        pool = ["".join(rng.choices("ACGT", k=28)) for _ in range(4000)]
        chunk_reads = [pool[rng.randrange(4000)] for _ in range(20000)]
        chunk = "".join(f"@x\n{r}\n+\n{'I' * len(r)}\n"
                        for r in chunk_reads).encode()
        reps = -(-target // len(chunk))
        path = tmp_path / "big.fastq"
        with open(path, "wb") as f:
            for _ in range(reps):
                f.write(chunk)
        size = os.path.getsize(path)
        assert size >= target
        # Hermetic subprocess: what this harness measures is HOST memory
        # of the streaming ingest, so the backend must be the in-process
        # CPU one (scrubbed_cpu_env pins it).
        env = scrubbed_cpu_env(1)
        env["SHORTSEQ_TPU_STREAM_BYTES"] = str(128 << 20)
        # Cap glibc's per-thread arenas so allocator noise from the
        # threaded native indexer stays bounded.
        env["MALLOC_ARENA_MAX"] = "2"
        r = subprocess.run(
            [sys.executable, "-c", _RSS_SCRIPT.format(repo=REPO_ROOT),
             str(path), "auto"],
            capture_output=True, text=True, timeout=900, env=env,
            cwd=str(tmp_path))
        assert r.returncode == 0, r.stderr[-2000:]
        line = [ln for ln in r.stdout.splitlines()
                if ln.startswith("RESULT")][0]
        _, n_unique, total, rss_mb = line.split()
        assert int(n_unique) == len(set(chunk_reads))
        assert int(total) == len(chunk_reads) * reps
        # Slice 128 MB + compact unique table (~4k rows) + interpreter +
        # numpy/jax baseline, with headroom for allocator noise: still
        # well under the file size.  A whole-file read alone (index +
        # buffer) would exceed the file size in RSS.
        cap_mb = max(900, size / (1 << 20) * 0.75)
        assert float(rss_mb) < cap_mb, \
            f"peak RSS {rss_mb} MB >= cap {cap_mb:.0f} MB (file " \
            f"{size / (1 << 20):.0f} MB); diag: {r.stderr[-2000:]}"
