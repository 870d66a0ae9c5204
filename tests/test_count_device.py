"""Device sort-unique-count vs collections.Counter oracle
(the dedup-parity check of reference unit_tests_profiling.py:136)."""

import collections

import numpy as np


from tests.conftest import rand_sequence


def _pack_batch(seqs, width_lanes):
    """Host-side helper: strings -> padded ascii matrix + lengths + packed
    lane matrix via the jnp ops."""
    import jax.numpy as jnp

    from shortseq_tpu.ops.bitpack import pack_words

    n = len(seqs)
    L = width_lanes * 16
    mat = np.zeros((n, L), dtype=np.uint8)
    lengths = np.zeros(n, dtype=np.int32)
    for i, s in enumerate(seqs):
        b = s.encode()
        mat[i, :len(b)] = np.frombuffer(b, dtype=np.uint8)
        lengths[i] = len(b)
    words = np.asarray(pack_words(jnp.asarray(mat)))
    return words, lengths


def _table_to_dict(u_words, u_lengths, u_counts, n_unique):
    from shortseq_tpu.count.device import counts_to_host

    return dict(counts_to_host(u_words, u_lengths, u_counts, n_unique))


def _decode_key(key):
    from shortseq_tpu import oracle

    length, blocks = key
    return oracle.decode_blocks(blocks, length)


class TestUniqueCount:
    def test_exact_counts_small(self, rng):
        from shortseq_tpu.count import count_batch

        seqs = [rand_sequence(rng, rng.randint(1, 32)) for _ in range(64)]
        seqs += seqs[:17]  # guaranteed duplicates
        words, lengths = _pack_batch(seqs, 2)
        table = _table_to_dict(*count_batch(words, lengths))
        got = {_decode_key(k): v for k, v in table.items()}
        assert got == dict(collections.Counter(seqs))

    def test_same_prefix_different_length(self, rng):
        # "ACGT" vs "ACGTA..." share packed prefixes; length must
        # discriminate (the reference separates them via __eq__ length check).
        from shortseq_tpu.count import count_batch

        seqs = ["ACGT", "ACGTACGT", "ACGT", "A", "AA", "A"]
        words, lengths = _pack_batch(seqs, 2)
        table = _table_to_dict(*count_batch(words, lengths))
        got = {_decode_key(k): v for k, v in table.items()}
        assert got == {"ACGT": 2, "ACGTACGT": 1, "A": 2, "AA": 1}

    def test_weights_merge_associative(self, rng):
        import jax.numpy as jnp

        from shortseq_tpu.count import count_batch, unique_count

        a = [rand_sequence(rng, 20) for _ in range(32)]
        b = a[:10] + [rand_sequence(rng, 20) for _ in range(22)]
        wa, la = _pack_batch(a, 2)
        wb, lb = _pack_batch(b, 2)
        ta = count_batch(wa, la)
        tb = count_batch(wb, lb)
        merged = unique_count(
            jnp.concatenate([ta[0], tb[0]]),
            jnp.concatenate([ta[1], tb[1]]),
            jnp.concatenate([ta[2], tb[2]]))
        got = {_decode_key(k): v for k, v in _table_to_dict(*merged).items()}
        assert got == dict(collections.Counter(a) + collections.Counter(b))

    def test_pad_rows_excluded(self):
        import jax.numpy as jnp

        from shortseq_tpu.count import unique_count
        from shortseq_tpu.count.device import PAD_LENGTH

        words = jnp.zeros((8, 2), jnp.uint32)
        lengths = jnp.array([4, 4, PAD_LENGTH, PAD_LENGTH, 4, 8, 8, PAD_LENGTH],
                            dtype=jnp.int32)
        weights = jnp.ones(8, jnp.int32)
        u_w, u_l, u_c, n = unique_count(words, lengths, weights)
        assert int(n) == 2
        assert u_l[0] == 4 and u_c[0] == 3
        assert u_l[1] == 8 and u_c[1] == 2
        assert (np.asarray(u_c[2:]) == 0).all()

    def test_var_width_batch(self, rng):
        from shortseq_tpu.count import count_batch

        seqs = [rand_sequence(rng, rng.randint(97, 300)) for _ in range(24)]
        seqs += seqs[::3]
        words, lengths = _pack_batch(seqs, 64)
        table = _table_to_dict(*count_batch(words, lengths))
        got = {_decode_key(k): v for k, v in table.items()}
        assert got == dict(collections.Counter(seqs))

    def test_mid_width_batch(self, rng):
        # 6-lane (96-nt) bucket: the widest class still on the
        # lexicographic path (count/device._LEX_SORT_MAX_LANES).
        from shortseq_tpu.count import count_batch

        seqs = [rand_sequence(rng, rng.randint(33, 96)) for _ in range(40)]
        seqs += seqs[::2]
        words, lengths = _pack_batch(seqs, 6)
        table = _table_to_dict(*count_batch(words, lengths))
        got = {_decode_key(k): v for k, v in table.items()}
        assert got == dict(collections.Counter(seqs))

    def test_hash_collision_retries_to_exact(self, rng, monkeypatch):
        # A hash family that collides for the FIRST seed only: the retry
        # loop must re-draw and the count must come out exact.
        # disable_jit so the patched _row_hash is seen (the jitted
        # unique_count caches real traces).
        import jax
        import jax.numpy as jnp

        from shortseq_tpu.count import device as D

        real = D._row_hash

        def first_seed_collides(words, lengths, seed):
            h1, h2 = real(words, lengths, seed)
            dead = jnp.zeros_like(h1)
            bad = (seed == 0)
            return jnp.where(bad, dead, h1), jnp.where(bad, dead, h2)

        monkeypatch.setattr(D, "_row_hash", first_seed_collides)
        # 8 lanes: just past _LEX_SORT_MAX_LANES so unique_count takes
        # the hash path.
        seqs = [rand_sequence(rng, rng.randint(97, 128)) for _ in range(20)]
        seqs += seqs[::2]
        words, lengths = _pack_batch(seqs, 8)
        with jax.disable_jit():
            s_l, s_w, s_wt, collision = D._sort_rows_hash(
                jnp.asarray(words), jnp.asarray(lengths),
                jnp.ones(len(seqs), jnp.int32))
            assert not bool(collision)  # retry recovered
            table = _table_to_dict(*D.unique_count(
                jnp.asarray(words), jnp.asarray(lengths),
                jnp.ones(len(seqs), jnp.int32)))
        got = {_decode_key(k): v for k, v in table.items()}
        assert got == dict(collections.Counter(seqs))

    def test_poison_closed_under_merge(self):
        # Counts re-enter unique_count as WEIGHTS in every device-side
        # merge (chunked ingest, pre-dedup exchange, all_gather merge):
        # a -1-poisoned input count must poison the merged table too,
        # never sum away into a positive wrong count - including when
        # weights cancel to zero.
        import jax.numpy as jnp
        import numpy as np
        import pytest

        from shortseq_tpu.count import unique_count
        from shortseq_tpu.count.device import counts_to_host

        words = jnp.asarray(np.array([[1, 0], [1, 0], [2, 0], [3, 0]],
                                     np.uint32))
        lengths = jnp.full(4, 16, jnp.int32)
        for weights in ([5, -1, 2, 2],    # poison sums positive: 5-1=4
                        [1, -1, 2, 2]):   # poison cancels to exactly 0
            out = unique_count(words, lengths,
                               jnp.asarray(weights, jnp.int32))
            with pytest.raises(OverflowError):
                counts_to_host(*out)

    def test_hash_exhaustion_poisons_loudly(self, rng, monkeypatch):
        # A degenerate hash that collides for EVERY seed (the adversarial
        # worst case) must never yield a silently mis-grouped table: the
        # counts come back poisoned and materialization raises.
        import jax
        import jax.numpy as jnp
        import pytest

        from shortseq_tpu.count import device as D

        def degenerate(words, lengths, seed):
            n = lengths.shape[0]
            return (jnp.zeros(n, jnp.uint32), jnp.zeros(n, jnp.uint32))

        monkeypatch.setattr(D, "_row_hash", degenerate)
        seqs = [rand_sequence(rng, rng.randint(97, 128)) for _ in range(20)]
        seqs += seqs[::2]
        words, lengths = _pack_batch(seqs, 8)
        with jax.disable_jit():
            _, _, _, collision = D._sort_rows_hash(
                jnp.asarray(words), jnp.asarray(lengths),
                jnp.ones(len(seqs), jnp.int32))
            assert bool(collision)  # every family exhausted
            out = D.unique_count(jnp.asarray(words), jnp.asarray(lengths),
                                 jnp.ones(len(seqs), jnp.int32))
            with pytest.raises(OverflowError):
                _table_to_dict(*out)


class TestShardedCount:
    def test_matches_single_device(self, rng):
        import jax

        from shortseq_tpu.count import count_batch
        from shortseq_tpu.dist import count_sharded, data_mesh

        # Runs on however many devices the interpreter booted with; the
        # fixed 8-device CPU-mesh run is test_multichip.py's subprocess
        # check.
        seqs = [rand_sequence(rng, rng.randint(1, 32)) for _ in range(120)]
        seqs += seqs[:40]  # 160 rows, divisible by any 2^k mesh
        words, lengths = _pack_batch(seqs, 2)

        import jax.numpy as jnp
        ones = jnp.ones(len(seqs), jnp.int32)
        mesh = data_mesh()
        sharded = count_sharded(mesh)(jnp.asarray(words), jnp.asarray(lengths), ones)
        local = count_batch(words, lengths)
        got = {_decode_key(k): v for k, v in _table_to_dict(*sharded).items()}
        want = {_decode_key(k): v for k, v in _table_to_dict(*local).items()}
        assert got == want == dict(collections.Counter(seqs))

    def test_full_pipeline_sharded(self, rng):
        import jax.numpy as jnp
        import numpy as np

        from shortseq_tpu.dist import data_mesh, make_sharded_counter

        seqs = [rand_sequence(rng, rng.randint(1, 32)) for _ in range(80)]
        n = len(seqs)
        L = 32
        mat = np.zeros((n, L), dtype=np.uint8)
        lengths = np.zeros(n, dtype=np.int32)
        for i, s in enumerate(seqs):
            b = s.encode()
            mat[i, :len(b)] = np.frombuffer(b, dtype=np.uint8)
            lengths[i] = len(b)

        mesh = data_mesh()
        step = make_sharded_counter(mesh)
        table, ok = step(jnp.asarray(mat), jnp.asarray(lengths))
        assert bool(jnp.all(ok))
        assert table.layout == "scattered"  # bucketed fast path taken
        from shortseq_tpu.dist import table_to_host_rows

        got = {_decode_key(k): v for k, v in table_to_host_rows(table)}
        assert got == dict(collections.Counter(seqs))
        assert int(table.n_unique) == len(got)
