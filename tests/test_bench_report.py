"""Driver-contract tests for bench.py's report emission.

A reader may capture only the TAIL of bench.py's stdout and parse the
LAST line as the headline JSON; spread stats on that line once outgrew
such a tail window and no number was recorded.  These tests pin the
contract: the last stdout line is one compact (<4000 B)
JSON object, spread stats live on a separate preceding line and in the
BENCH_STATS.json sidecar, and an oversized extras dict degrades to a
truncation marker instead of bloating the line.
"""

import json
import sys

import pytest

sys.path.insert(0, __file__.rsplit("/", 2)[0])  # repo root for bench.py
import bench  # noqa: E402


def _emit(capsys, tmp_path, nt_per_s, extra, stats):
    bench.emit_report(nt_per_s, extra, stats=stats,
                      stats_path=str(tmp_path / "BENCH_STATS.json"))
    return capsys.readouterr().out.splitlines()


FULL_STATS = {
    f"metric_{i}": {"median": 1e-4 * i, "min": 9e-5 * i, "max": 2e-4 * i,
                    "n_runs": 5, "cold_first_dispatch_s": 3.2}
    for i in range(14)
}


class TestHeadlineLine:
    def test_last_line_is_compact_parseable_headline(self, capsys, tmp_path):
        extra = {"pack_only_nt_per_s": 7.2e11, "backend": "gpu",
                 "pairwise_formulation_pairs_per_s":
                     {"pallas": 6.2e10, "mxu": 4.1e10, "jnp": 1.1e10}}
        lines = _emit(capsys, tmp_path, 2.35e11, extra, FULL_STATS)
        last = lines[-1]
        assert len(last) < 4000
        rep = json.loads(last)
        assert rep["metric"] == "pack_nt_per_s_chip"
        assert rep["value"] == pytest.approx(2.35e11)
        assert rep["unit"] == "nt/s"
        assert rep["vs_baseline"] == pytest.approx(235.0)
        assert "run_stats" not in rep["extra"]  # the r03 failure mode

    def test_stats_go_to_preceding_line_and_sidecar(self, capsys, tmp_path):
        lines = _emit(capsys, tmp_path, 1.0e9, {"backend": "gpu"}, FULL_STATS)
        assert len(lines) == 2
        assert json.loads(lines[0])["run_stats"] == FULL_STATS
        sidecar = json.loads((tmp_path / "BENCH_STATS.json").read_text())
        assert sidecar == FULL_STATS

    def test_failed_pack_reports_zero_with_error(self, capsys, tmp_path):
        lines = _emit(capsys, tmp_path, "error: RuntimeError: boom",
                      {"backend": "gpu"}, {})
        rep = json.loads(lines[-1])
        assert rep["value"] == 0.0 and rep["vs_baseline"] == 0.0
        assert "boom" in rep["extra"]["pack_error"]

    def test_bloat_guard_truncates_extras_not_headline(self, capsys,
                                                       tmp_path):
        bloated = {f"err_{i}": "x" * 300 for i in range(30)}
        bloated["backend"] = "gpu"
        lines = _emit(capsys, tmp_path, 5.0e11, bloated, {})
        last = lines[-1]
        assert len(last) < 4000
        rep = json.loads(last)
        assert rep["value"] == pytest.approx(5.0e11)  # headline survives
        assert "truncated" in rep["extra"]
        assert rep["extra"]["backend"] == "gpu"

    def test_realistic_r03_shaped_extras_fit_budget(self, capsys, tmp_path):
        """The exact extras shape that broke round 3 (12 scalar metrics +
        formulation dict + choice), now WITHOUT run_stats, fits easily."""
        extra = {k: 1.23456789e11 for k in (
            "pack_only_nt_per_s", "pack_unfolded_nt_per_s",
            "raw_stream_bytes_per_s", "hamming_pairs_per_s",
            "dedup_reads_per_s", "materialize_keys_per_s",
            "end_to_end_host_reads_per_s", "end_to_end_device_reads_per_s",
            "umi_dedup_100k_umis_per_s", "dispatch_latency_s",
            "pairwise_hamming_pairs_per_s")}
        extra["backend"] = "gpu"
        extra["pairwise_auto_choice"] = "pallas"
        extra["pairwise_formulation_pairs_per_s"] = {
            "pallas": 6.2e10, "mxu": 4.1e10, "jnp": 1.1e10}
        lines = _emit(capsys, tmp_path, 2.35e11, extra, FULL_STATS)
        assert len(lines[-1]) < 2000
        assert "truncated" not in json.loads(lines[-1])["extra"]
