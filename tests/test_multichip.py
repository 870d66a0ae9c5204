"""8-device CPU-mesh validation of the sharded count path.

Runs in a subprocess with its own environment (conftest.scrubbed_cpu_env:
the CPU platform with exactly 8 virtual devices), whatever backend the
test process itself runs on, the way `__graft_entry__.dryrun_multichip`
is dry-run with xla_force_host_platform_device_count.
"""

import subprocess
import sys

from tests.conftest import scrubbed_cpu_env

_SCRIPT = """
import jax  # shortseq_tpu resolves via scrubbed_cpu_env's PYTHONPATH
assert len(jax.devices()) == 8, jax.devices()
import __graft_entry__
__graft_entry__.dryrun_multichip(8)

# Also check the merged table matches a single-device count bit-for-bit.
import collections
import numpy as np
import jax.numpy as jnp
from shortseq_tpu.count import count_batch
from shortseq_tpu.count.device import counts_to_host
from shortseq_tpu.dist import data_mesh, make_sharded_counter

rng = np.random.default_rng(7)
n, width = 128, 32
lengths = rng.integers(8, 33, size=n).astype(np.int32)
codes = rng.integers(0, 3, size=(n, width)).astype(np.uint8)  # small alphabet -> dups
ascii_mat = np.frombuffer(b"ACT", dtype=np.uint8)[codes]
mask = np.arange(width)[None, :] < lengths[:, None]
ascii_mat = np.where(mask, ascii_mat, 0).astype(np.uint8)

from shortseq_tpu.dist import table_to_host_rows

step = make_sharded_counter(data_mesh())
table, ok = step(jnp.asarray(ascii_mat), jnp.asarray(lengths))
assert bool(jnp.all(ok))
assert table.layout == "scattered"  # production bucketed path, no fallback
sharded = dict(table_to_host_rows(table))
assert sum(sharded.values()) == n

from shortseq_tpu.ops.bitpack import pack_words
words = pack_words(jnp.asarray(ascii_mat))
local = dict(counts_to_host(*count_batch(words, jnp.asarray(lengths))))
assert sharded == local, (len(sharded), len(local))
assert sum(sharded.values()) == n

# Bucketed-exchange (all_to_all) merge must agree with the all_gather merge.
from shortseq_tpu.count.device import counts_to_host_scattered
from shortseq_tpu.dist import count_sharded_bucketed

step_b = count_sharded_bucketed(data_mesh())
ones = jnp.ones(n, jnp.int32)
u_w, u_l, u_c, n_u, overflow = step_b(words, jnp.asarray(lengths), ones)
assert int(overflow) == 0
bucketed = dict(counts_to_host_scattered(u_w, u_l, u_c))
assert bucketed == local, (len(bucketed), len(local))
assert int(n_u) == len(local)

# Sharded-output (production, replicate=False) variant: device d keeps
# bucket d's uniques; host materialization must see the identical table.
step_s = count_sharded_bucketed(data_mesh(), replicate=False)
s_w, s_l, s_c, s_n, s_ov = step_s(words, jnp.asarray(lengths), ones)
assert int(s_ov) == 0
assert s_w.shape[0] == u_w.shape[0] // 1  # same global row count as replicated gather
sharded_tbl = dict(counts_to_host_scattered(s_w, s_l, s_c))
assert sharded_tbl == local, (len(sharded_tbl), len(local))
assert int(s_n) == len(local)
print("MULTICHIP-OK", len(sharded))
"""


def test_sharded_count_on_8_cpu_devices():
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT],
        env=scrubbed_cpu_env(8),
        capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "MULTICHIP-OK" in proc.stdout


_UMI_SCRIPT = """
import jax  # shortseq_tpu resolves via scrubbed_cpu_env's PYTHONPATH
assert len(jax.devices()) == 8, jax.devices()

import numpy as np
from shortseq_tpu.dist import data_mesh
from shortseq_tpu.umi.dedup import dedup_reads, dedup_umis, _neighbor_lists, \\
    _pack_validate_umis

rng = np.random.default_rng(21)
alpha = np.frombuffer(b"ACGT", np.uint8)
pool = alpha[rng.integers(0, 4, size=(400, 10))]
umis = [pool[i].tobytes() for i in rng.integers(0, 400, size=3000)]
mesh = data_mesh()

# Sharded adjacency == single-device adjacency, row for row.
uniq = sorted(set(umis))
words, lengths = _pack_validate_umis(uniq)
words = np.asarray(words)
single = _neighbor_lists(words, lengths, 1)
sharded = _neighbor_lists(words, lengths, 1, mesh=mesh)
assert len(single) == len(sharded)
for a, b in zip(single, sharded):
    assert sorted(a) == sorted(b)

# Whole dedup pipelines agree bit-for-bit with the single-device result,
# across methods/thresholds/seeds (pool sizes fixed so the padded shapes
# stay in the compile cache across trials).
for seed, method, thr in ((21, "directional", 1), (22, "cluster", 1),
                          (23, "adjacency", 1), (24, "directional", 2)):
    r = np.random.default_rng(seed)
    p = alpha[r.integers(0, 4, size=(400, 10))]
    us = [p[i].tobytes() for i in r.integers(0, 400, size=3000)]
    l1, r1 = dedup_umis(us, threshold=thr, method=method)
    l2, r2 = dedup_umis(us, threshold=thr, method=method, mesh=mesh)
    assert (l1 == l2).all() and r1 == r2, (seed, method, thr)

reads = [pool[i].tobytes() + b"ACGTACGTACGTACGT"
         for i in rng.integers(0, 400, size=2000)]
l3, m3 = dedup_reads(reads, len_5p=10)
l4, m4 = dedup_reads(reads, len_5p=10, mesh=mesh)
assert (l3 == l4).all() and m3 == m4
print("SHARDED_UMI_OK")
"""


_NONPOW2_SCRIPT = """
import sys

import jax  # shortseq_tpu resolves via scrubbed_cpu_env's PYTHONPATH
D = int(sys.argv[1])
assert len(jax.devices()) == D, jax.devices()

import numpy as np
import jax.numpy as jnp
from shortseq_tpu.count import count_batch
from shortseq_tpu.count.device import counts_to_host, counts_to_host_scattered
from shortseq_tpu.dist import data_mesh, count_sharded_bucketed
from shortseq_tpu.ops.bitpack import pack_words

rng = np.random.default_rng(11)
n = 60 * D  # divisible by the mesh for any D in {3, 6}
width = 32
lengths = rng.integers(8, 33, size=n).astype(np.int32)
codes = rng.integers(0, 3, size=(n, width)).astype(np.uint8)
ascii_mat = np.frombuffer(b"ACT", dtype=np.uint8)[codes]
mask = np.arange(width)[None, :] < lengths[:, None]
ascii_mat = np.where(mask, ascii_mat, 0).astype(np.uint8)
words = pack_words(jnp.asarray(ascii_mat))
local = dict(counts_to_host(*count_batch(words, jnp.asarray(lengths))))

mesh = data_mesh()
ones = jnp.ones(n, jnp.int32)
for replicate in (True, False):
    step = count_sharded_bucketed(mesh, replicate=replicate)
    u_w, u_l, u_c, n_u, overflow = step(words, jnp.asarray(lengths), ones)
    assert int(overflow) == 0, f"replicate={replicate} overflowed on D={D}"
    got = dict(counts_to_host_scattered(u_w, u_l, u_c))
    assert got == local, (replicate, len(got), len(local))
    assert int(n_u) == len(local)
print("NONPOW2-OK", D, len(local))
"""


def test_bucketed_count_on_nonpow2_meshes():
    """D = 3 and D = 6 CPU meshes: both bucketed layouts must stay exact
    with no overflow (the pre-fix _bucket_hash aliased buckets 0/1 at 2x
    load for D = 6, risking silent capacity pressure)."""
    for d in (3, 6):
        proc = subprocess.run(
            [sys.executable, "-c", _NONPOW2_SCRIPT, str(d)],
            env=scrubbed_cpu_env(d),
            capture_output=True, text=True, timeout=600,
        )
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert f"NONPOW2-OK {d}" in proc.stdout


_SKEW_SCRIPT = """
import jax  # shortseq_tpu resolves via scrubbed_cpu_env's PYTHONPATH
assert len(jax.devices()) == 8, jax.devices()

import numpy as np
import jax.numpy as jnp
from shortseq_tpu.count import count_batch
from shortseq_tpu.count.device import counts_to_host
from shortseq_tpu.dist import count_sharded_auto, data_mesh, table_to_host_rows
from shortseq_tpu.dist.count import _bucket_hash

D = 8
mesh = data_mesh()

# Hash-skewed keys: every row lands in bucket 0, so each device's
# 64-row shard sends 64 rows at a 2*64/8+16 = 32-slot capacity ->
# guaranteed overflow -> the auto counter must take the count_sharded
# fallback and still produce exact counts.
rng = np.random.default_rng(5)
skewed = []
lengths_val = 20
while len(skewed) < 512:
    cand = rng.integers(0, 2**32, size=(4096, 2), dtype=np.uint64).astype(np.uint32)
    b = np.asarray(_bucket_hash(jnp.asarray(cand), jnp.full(4096, lengths_val, jnp.int32), D))
    skewed.extend(map(tuple, cand[b == 0]))
skewed = np.asarray(sorted(set(skewed))[:512], np.uint32)
assert len(skewed) == 512
# duplicate some rows so counting is non-trivial
words = np.concatenate([skewed, skewed[:256]])[:512]
lengths = np.full(512, lengths_val, np.int32)
ones = jnp.ones(512, jnp.int32)

local = dict(counts_to_host(*count_batch(jnp.asarray(words), jnp.asarray(lengths))))
auto = count_sharded_auto(mesh)
table = auto(jnp.asarray(words), jnp.asarray(lengths), ones)
assert table.layout == "prefix", table.layout  # fallback taken
got = dict(table_to_host_rows(table))
assert got == local, (len(got), len(local))
assert int(table.n_unique) == len(local)

# Benign keys: the fast path sticks (scattered) and is equally exact.
benign = rng.integers(0, 2**32, size=(512, 2), dtype=np.uint64).astype(np.uint32)
local_b = dict(counts_to_host(*count_batch(jnp.asarray(benign), jnp.asarray(lengths))))
table_b = auto(jnp.asarray(benign), jnp.asarray(lengths), ones)
assert table_b.layout == "scattered", table_b.layout
got_b = dict(table_to_host_rows(table_b))
assert got_b == local_b
print("SKEW-FALLBACK-OK", len(got), len(got_b))
"""


def test_auto_counter_overflow_fallback_on_hash_skew():
    """count_sharded_auto must detect bucket-capacity overflow from
    adversarially skewed keys (all hashing to one bucket), fall back to
    the exact all_gather merge, and still return exact counts - the
    overflow contract count_sharded_bucketed documents, now implemented
    at the production call site."""
    proc = subprocess.run(
        [sys.executable, "-c", _SKEW_SCRIPT],
        env=scrubbed_cpu_env(8),
        capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SKEW-FALLBACK-OK" in proc.stdout


_DIST_TABLE_SCRIPT = """
import collections

import jax  # shortseq_tpu resolves via scrubbed_cpu_env's PYTHONPATH
assert len(jax.devices()) == 8, jax.devices()

import numpy as np
import jax.numpy as jnp
from shortseq_tpu.count import count_batch
from shortseq_tpu.count.device import counts_to_host
from shortseq_tpu.dist import (count_sharded_auto, data_mesh,
                               distributed_count_table)
from shortseq_tpu.dist.table import DistributedCountTable
from shortseq_tpu.oracle import decode_blocks
from shortseq_tpu.ops.bitpack import pack_words

rng = np.random.default_rng(13)
n, width = 512, 32
lengths = rng.integers(4, 17, size=n).astype(np.int32)
codes = rng.integers(0, 3, size=(n, width)).astype(np.uint8)
ascii_mat = np.frombuffer(b"ACT", dtype=np.uint8)[codes]
mask = np.arange(width)[None, :] < lengths[:, None]
ascii_mat = np.where(mask, ascii_mat, 0).astype(np.uint8)
words = pack_words(jnp.asarray(ascii_mat))

local = {}
for (length, blocks), count in counts_to_host(
        *count_batch(words, jnp.asarray(lengths))):
    local[decode_blocks(blocks, length)] = count

mesh = data_mesh()
table = count_sharded_auto(mesh)(words, jnp.asarray(lengths),
                                 jnp.ones(n, jnp.int32))
assert table.layout == "scattered"
t = distributed_count_table(table, mesh)
assert isinstance(t, DistributedCountTable)

assert len(t) == len(local)
assert t.total() == n
assert sorted(t.values().tolist()) == sorted(local.values())
top = t.most_common(5)
want_counts = sorted(local.values(), reverse=True)[:5]
assert sorted((c for _, c in top), reverse=True) == want_counts
for k, c in top:
    assert local[str(k)] == c
# deterministic order: count desc, key asc
pairs = [(-c, str(k)) for k, c in top]
assert pairs == sorted(pairs)
# full listing agrees exactly
assert {str(k): c for k, c in t.most_common()} == local
# lookups
some = list(local)[:20]
for s in some:
    assert s in t and t[s] == local[s]
assert t.get("G" * 30) == 0 and "G" * 30 not in t
# full materialization
assert {str(k): v for k, v in t.to_counter().items()} == local

# prefix-layout tables route to the plain CountTable view
from shortseq_tpu.count.table import CountTable
from shortseq_tpu.dist import count_sharded

prefix = count_sharded(mesh)(words, jnp.asarray(lengths),
                             jnp.ones(n, jnp.int32))
t2 = distributed_count_table(prefix, mesh)
assert isinstance(t2, CountTable)
assert len(t2) == len(local) and t2.total() == n
assert {str(k): c for k, c in t2.most_common()} == local
print("DIST-TABLE-OK", len(local))
"""


def test_distributed_count_table_on_8_cpu_devices():
    """DistributedCountTable: lazy Counter-style reads over the
    mesh-sharded production merge output - every read is a collective
    returning a replicated result, candidate rows (not the table) cross
    to the host."""
    proc = subprocess.run(
        [sys.executable, "-c", _DIST_TABLE_SCRIPT],
        env=scrubbed_cpu_env(8),
        capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "DIST-TABLE-OK" in proc.stdout


def test_bucket_hash_uniform_loads():
    """Bucket loads from _bucket_hash must be near-uniform for every mesh
    size, not just powers of two (the aliasing bug gave 2x load on
    buckets 0/1 at D = 6)."""
    import numpy as np
    import jax.numpy as jnp

    from shortseq_tpu.dist.count import _bucket_hash

    rng = np.random.default_rng(3)
    n = 100_000
    words = jnp.asarray(rng.integers(0, 2**32, size=(n, 2), dtype=np.uint64)
                        .astype(np.uint32))
    lengths = jnp.asarray(rng.integers(8, 33, size=n).astype(np.int32))
    for d in (2, 3, 5, 6, 8, 12):
        loads = np.bincount(np.asarray(_bucket_hash(words, lengths, d)),
                            minlength=d)
        mean = n / d
        assert loads.max() < 1.15 * mean, (d, loads.tolist())
        assert loads.min() > 0.85 * mean, (d, loads.tolist())


def test_bucket_hash_rejects_oversized_mesh():
    import numpy as np
    import jax.numpy as jnp
    import pytest

    from shortseq_tpu.dist.count import _bucket_hash

    words = jnp.zeros((4, 2), jnp.uint32)
    lengths = jnp.zeros(4, jnp.int32)
    with pytest.raises(ValueError, match="n_buckets"):
        _bucket_hash(words, lengths, (1 << 16) + 1)


def test_sharded_umi_adjacency_matches_single_device():
    out = subprocess.run(
        [sys.executable, "-c", _UMI_SCRIPT],
        env=scrubbed_cpu_env(), capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "SHARDED_UMI_OK" in out.stdout
