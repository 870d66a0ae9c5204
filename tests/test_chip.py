"""Exact parity of the device paths on the GPU, at real widths.

These run the checks of tests/chip_checks.py (the same functions
chip_smoke.py runs) on the card, and skip where JAX finds no GPU.  Run
them on a machine with one card:

    JAX_PLATFORMS=cuda python -m pytest -m chip tests/test_chip.py -q
"""

import pytest

from tests import chip_checks

pytestmark = pytest.mark.chip


def test_fastq_dedup_matches_host_engine(gpu, tmp_path):
    path = str(tmp_path / "reads.fastq")
    chip_checks.make_fastq(path, 1_000_000)
    chip_checks.check_fastq_dedup(path, 1_000_000)


def test_width_ladder_matches_host_engine(gpu, tmp_path):
    path = str(tmp_path / "ladder.fastq")
    chip_checks.make_fastq(path, 1_000_000, seed=1, ladder=True)
    chip_checks.check_width_ladder(path, 1_000_000)


@pytest.mark.parametrize("n,width", [(1 << 18, 160), (1 << 15, 1024)])
def test_pack_validate_hamming(gpu, n, width):
    chip_checks.check_pack_validate(n, width)


def test_pairwise_formulations(gpu):
    chip_checks.check_pairwise_formulations()


def test_umi_dedup_100k(gpu):
    chip_checks.check_umi_dedup(100_000)


def test_umi_dedup_matches_oracle(gpu):
    chip_checks.check_umi_oracle()
