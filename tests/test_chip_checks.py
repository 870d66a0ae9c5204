"""The chip parity checks (tests/chip_checks.py) at small sizes on the
default backend, so the checks themselves - their references and their
comparisons - stay exercised where there is no card."""

import numpy as np
import pytest

from tests import chip_checks


def test_fastq_dedup_check(tmp_path):
    path = str(tmp_path / "reads.fastq")
    chip_checks.make_fastq(path, 5000)
    facts = chip_checks.check_fastq_dedup(path, 5000)
    assert facts["reads"] == 5000 and facts["unique"] <= 5000


def test_width_ladder_check(tmp_path):
    path = str(tmp_path / "ladder.fastq")
    chip_checks.make_fastq(path, 2000, seed=1, ladder=True)
    assert chip_checks.check_width_ladder(path, 2000)["lane_widths"] == \
        [2, 6, 64]


@pytest.mark.parametrize("n,width", [(2048, 160), (512, 1024)])
def test_pack_validate_check(n, width):
    facts = chip_checks.check_pack_validate(n, width)
    assert 0 < facts["rejected_rows"] < n


def test_pairwise_formulations_check():
    facts = chip_checks.check_pairwise_formulations(rows=70, cols=300,
                                                    ref_cols=300)
    assert set(facts) == {"w2", "w6", "w64"}


def test_umi_dedup_check():
    facts = chip_checks.check_umi_dedup(2000, slabs=2)
    assert facts["clusters"] == 2000


def test_umi_oracle_check():
    facts = chip_checks.check_umi_oracle(200)
    assert facts["clusters"] < facts["unique"]


def test_check_catches_a_wrong_pack():
    mat = np.frombuffer(b"ACGT" * 8, np.uint8).reshape(1, 32)
    words = chip_checks.numpy_pack(mat)
    words[0, 0] ^= 1
    with pytest.raises(AssertionError):
        chip_checks._check(np.array_equal(words, chip_checks.numpy_pack(mat)),
                           "pack mismatch")


def test_numpy_references_match_the_oracle():
    from shortseq_tpu import oracle

    rng = np.random.default_rng(3)
    seqs = [bytes(chip_checks._ACTG[rng.integers(0, 4, size=n)])
            for n in (1, 15, 16, 17, 33, 100)]
    mat = np.zeros((len(seqs), 112), np.uint8)
    for i, s in enumerate(seqs):
        mat[i, :len(s)] = np.frombuffer(s, np.uint8)
    words = chip_checks.numpy_pack(mat)
    for i, s in enumerate(seqs):
        assert words[i].tolist() == oracle.blocks_to_lanes(
            oracle.encode_bytes(s), 7)
    a, b = seqs[3], bytes(rng.permutation(np.frombuffer(seqs[3], np.uint8)))
    mb = np.zeros((1, 112), np.uint8)
    mb[0, :len(b)] = np.frombuffer(b, np.uint8)
    got = chip_checks.numpy_hamming(words[3], chip_checks.numpy_pack(mb)[0])
    assert got == oracle.str_hamming(a.decode(), b.decode())
