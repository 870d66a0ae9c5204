"""All-pairs Hamming: every formulation against the string oracle, the
measured choice among them, and that a failing formulation raises instead
of falling back."""

import numpy as np
import pytest

import jax.numpy as jnp

from shortseq_tpu import oracle


def _rand_words(n, w, seed):
    rng = np.random.default_rng(seed)
    return jnp.asarray(
        rng.integers(0, 2**32, size=(n, w), dtype=np.uint64).astype(np.uint32))


def _packed_strings(n, w, seed):
    """n random ACTG strings filling w lanes (16 * w nt) and their words,
    packed by the scalar oracle (independent of the device pack)."""
    rng = np.random.default_rng(seed)
    seqs = ["".join(rng.choice(list("ACTG"), size=16 * w)) for _ in range(n)]
    words = np.asarray([oracle.blocks_to_lanes(oracle.encode_bytes(s.encode()),
                                               w) for s in seqs], np.uint32)
    return seqs, words


class TestPairwiseOracle:
    @pytest.mark.parametrize("w", [2, 6, 64])
    @pytest.mark.parametrize("name", ["jnp", "mxu"])
    def test_formulation_matches_oracle(self, name, w):
        # Row counts that are no tile multiple of anything.
        from shortseq_tpu.ops.pallas_kernels import _FORMULATIONS

        sa, a = _packed_strings(37, w, 1)
        sb, b = _packed_strings(53, w, 2)
        dist = np.asarray(_FORMULATIONS[name](a, b))
        assert dist.shape == (37, 53)
        want = np.asarray([[oracle.str_hamming(x, y) for y in sb]
                           for x in sa])
        assert (dist == want).all()


class TestPairwiseTiled:
    """The measured choice among the formulations (pairwise_hamming_auto)."""

    def test_auto_records_path(self):
        import jax

        from shortseq_tpu.ops import pallas_kernels as pk

        a = _rand_words(16, 2, 9)
        np.asarray(pk.pairwise_hamming_auto(a, a))
        # The auto path follows the per-(platform, device, width)
        # calibration, so the recorded path must equal the cached winner.
        platform = jax.devices()[0].platform
        kind = getattr(jax.devices()[0], "device_kind", platform)
        winner = pk._CALIBRATION[f"{platform}/{kind}/w2"]
        assert pk.LAST_PAIRWISE_PATH == winner
        assert winner in pk._FORMULATIONS

    def test_calibration_measures_and_caches(self, tmp_path, monkeypatch):
        """calibrate_pairwise: winner == argmin of the measured times;
        the decision persists to disk and reloads without re-measuring."""
        import jax

        from shortseq_tpu.ops import pallas_kernels as pk

        calib_file = str(tmp_path / "calib.json")
        monkeypatch.setattr(pk, "_calib_file", lambda: calib_file)
        monkeypatch.setattr(pk, "_CALIBRATION", {})
        times = pk.calibrate_pairwise(6, force=True)
        platform = jax.devices()[0].platform
        assert times and set(times) <= set(pk._FORMULATIONS)
        kind = getattr(jax.devices()[0], "device_kind", platform)
        key = f"{platform}/{kind}/w6"
        assert pk._CALIBRATION[key] == min(times, key=times.get)
        # Fresh in-memory state: the disk cache must answer without
        # re-measuring (calibrate returns the persisted times).
        monkeypatch.setattr(pk, "_CALIBRATION", {})
        reloaded = pk.calibrate_pairwise(6)
        assert reloaded == times
        assert pk._CALIBRATION[key] == min(times, key=times.get)

    def test_auto_matches_oracle(self, rng):
        from tests.conftest import rand_sequence

        from shortseq_tpu.ops import pairwise_hamming_auto
        from shortseq_tpu.ops.bitpack import pack_words

        seqs = [rand_sequence(rng, 32) for _ in range(40)]
        mat = np.zeros((len(seqs), 32), np.uint8)
        for i, s in enumerate(seqs):
            mat[i] = np.frombuffer(s.encode(), np.uint8)
        words = pack_words(jnp.asarray(mat))
        dist = np.asarray(pairwise_hamming_auto(words, words))
        for i in range(0, len(seqs), 7):
            for j in range(0, len(seqs), 5):
                want = sum(a != b for a, b in zip(seqs[i], seqs[j]))
                assert dist[i, j] == want


def _broken(a, b):
    raise RuntimeError("formulation failed to compile")


def test_auto_raises_when_the_chosen_formulation_fails(monkeypatch):
    from shortseq_tpu.ops import pallas_kernels as pk

    monkeypatch.setitem(pk._FORMULATIONS, "mxu", _broken)
    monkeypatch.setenv("SHORTSEQ_TPU_PAIRWISE", "mxu")
    with pytest.raises(RuntimeError, match="failed to compile"):
        pk.pairwise_hamming_auto(_rand_words(8, 2, 1), _rand_words(8, 2, 2))
    assert pk.LAST_PAIRWISE_PATH == "mxu"  # no fallback ran


def test_calibration_raises_when_a_candidate_fails(monkeypatch, tmp_path):
    from shortseq_tpu.ops import pallas_kernels as pk

    monkeypatch.setattr(pk, "_calib_file", lambda: str(tmp_path / "c.json"))
    monkeypatch.setattr(pk, "_CALIBRATION", {})
    monkeypatch.setitem(pk._FORMULATIONS, "mxu", _broken)
    with pytest.raises(RuntimeError, match="failed to compile"):
        pk.calibrate_pairwise(2, force=True)
    assert not pk._CALIBRATION  # nothing was cached as a winner


def test_pairwise_env_override(monkeypatch):
    # SHORTSEQ_TPU_PAIRWISE selects the formulation; all are bit-exact.
    from shortseq_tpu.ops import pallas_kernels as pk

    rng = np.random.default_rng(2)
    a = rng.integers(0, 2**32, size=(64, 2), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, size=(48, 2), dtype=np.uint64).astype(np.uint32)
    base = np.asarray(pk.pairwise_hamming_auto(a, b))
    monkeypatch.setenv("SHORTSEQ_TPU_PAIRWISE", "mxu")
    got = np.asarray(pk.pairwise_hamming_auto(a, b))
    assert pk.LAST_PAIRWISE_PATH == "mxu"
    assert (got == base).all()
    monkeypatch.setenv("SHORTSEQ_TPU_PAIRWISE", "jnp")
    got = np.asarray(pk.pairwise_hamming_auto(a, b))
    assert pk.LAST_PAIRWISE_PATH == "jnp"
    assert (got == base).all()
