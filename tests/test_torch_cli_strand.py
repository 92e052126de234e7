"""The port's CLI against the JAX CLI in the strand modes: --by-strand,
--hd-finder on a heteroduplex, and the report variants they write (the twins
of tests/test_modes.py:55,78 and tests/test_report_variants.py:24,45). The
JAX loop settles ties between equivalent mutations by rounding, and which
member rounding picks follows the shapes the JAX engine compiles for, so
the inputs were chosen by running both CLIs: 150 bp 8-pass ZMWs (holes 1,
3, 6 for --by-strand; 5, 9 and a heteroduplex whose reverse strand carries
a 30 bp insertion, hole 32, for --hd-finder and the default mode) on which
the two agree. Then the one divergence found between the two CLIs: the
heteroduplex of hole 11 with kinetics tags, where --by-strand differs in
the forward strand's record; with the JAX scorer's ties given the port's
rule (tests/test_torch_ties.py::jax_ties_resolved) the JAX CLI writes
exactly the port's output, so the difference is that tie and nothing else
(classified window by window in tests/test_torch_ties.py). Bars in
tests/_torch_cli_twin.py."""

import json
import os
import re

import pytest
import torch

from ccs_tpu.pipeline import orchestrator as jax_orchestrator
from ccs_tpu_torch.pipeline.orchestrator import shutdown_pool
from ccs_tpu_torch.sim.simulator import (simulate_heteroduplex_zmw,
                                         simulate_zmw, write_subreads_bam)
from tests._torch_cli_twin import (assert_bams_match, assert_close,
                                   assert_outputs_match, bam_rows, read,
                                   run_both, run_in)
from tests.test_torch_ties import (heteroduplex_with_kinetics,
                                   jax_ties_resolved)

torch.set_num_threads(1)

IN = "../../in.subreads.bam"
HD_HOLE = 32


@pytest.fixture(scope="module", autouse=True)
def _stop_prepare_pools():
    yield
    shutdown_pool()
    if jax_orchestrator._PROC_POOL is not None:
        jax_orchestrator._PROC_POOL.shutdown(wait=True)
        jax_orchestrator._PROC_POOL = None


def _bam(d, holes, hd_hole=None):
    zmws = [simulate_zmw(hole=h, insert_len=150, n_passes=8, snr=9.0)
            for h in holes]
    if hd_hole is not None:
        zmws.append(simulate_heteroduplex_zmw(hole=hd_hole, insert_len=200,
                                              n_passes=10, ins_len=30,
                                              snr=9.0))
    write_subreads_bam(str(d / "in.subreads.bam"), zmws)
    return d


@pytest.fixture(scope="module")
def strand_cell(tmp_path_factory):
    return _bam(tmp_path_factory.mktemp("strand"), (1, 3, 6))


@pytest.fixture(scope="module")
def hd_cell(tmp_path_factory):
    return _bam(tmp_path_factory.mktemp("hd"), (5, 9), HD_HOLE)


def _holes(rows):
    return sorted((int(r["name"].split("/")[1]), r["name"].split("/")[-1])
                  for r in rows)


def test_by_strand_matches_jax(strand_cell):
    """Two records per ZMW with passes on both strands, the single-column
    report ("Single-Strand Reads", inputs 2 x ZMWs) and the JSON report."""
    dj, dt = run_both(strand_cell / "bs", [IN, "bs.bam", "--by-strand",
                                    "--min-passes", "2", "--min-rq", "0.9",
                                    "--report-json", "bs.json"])
    rows = assert_outputs_match(dj, dt, "bs")
    assert {s for _h, s in _holes(rows)} == {"fwd", "rev"}
    rep = read(os.path.join(dt, "bs.ccs_report.txt")).splitlines()
    assert rep[0].strip() == "Single-Strand Reads"
    m = re.match(r"Inputs\s*:\s*(\d+) \(", rep[1])
    assert m and int(m.group(1)) == 6
    assert_close(json.loads(read(os.path.join(dj, "bs.json"))),
                 json.loads(read(os.path.join(dt, "bs.json"))), "bs.json")


def test_hd_finder_matches_jax(hd_cell):
    """The heteroduplex splits into its two strands, which differ in length
    by about the insertion; the other ZMWs stay whole; the two-column
    report; the HiFi summary (apart from its rates per hour of wall time)."""
    dj, dt = run_both(hd_cell / "hd", [IN, "hd.bam", "--hd-finder",
                                    "--min-passes", "2", "--min-rq", "0.9",
                                    "--hifi-summary-json", "hs.json"])
    rows = assert_outputs_match(dj, dt, "hd")
    strands = [r for r in rows if r["name"].split("/")[1] == str(HD_HOLE)]
    assert sorted(r["name"].split("/")[-1] for r in strands) == ["fwd", "rev"]
    la, lb = sorted(len(r["seq"]) for r in strands)
    assert 15 <= lb - la <= 45, (la, lb)
    assert all(r["name"].endswith("/ccs") for r in rows if r not in strands)
    rep = read(os.path.join(dt, "hd.ccs_report.txt")).splitlines()
    assert "Double-Strand Reads" in rep[0] and "Single-Strand Reads" in rep[0]
    summaries = [{k: v for k, v in json.loads(read(os.path.join(d, "hs.json")))
                  .items() if "per_hr" not in k} for d in (dj, dt)]
    assert_close(*summaries, "hs.json")


def test_default_mode_report_and_heteroduplex_status_match_jax(hd_cell):
    """Without a strand mode the heteroduplex fails (HETERODUPLEXES) and
    the report keeps its default layout."""
    dj, dt = run_both(hd_cell / "def", [IN, "def.bam", "--min-passes", "2",
                                     "--min-rq", "0.9"])
    rows = assert_outputs_match(dj, dt, "def")
    assert HD_HOLE not in [h for h, _s in _holes(rows)]
    rep = read(os.path.join(dt, "def.ccs_report.txt"))
    assert rep.startswith("ZMWs input") and "ZMWs pass filters" in rep


def test_by_strand_tie_on_a_heteroduplex_with_kinetics(tmp_path):
    """The divergence found between the two CLIs: on the heteroduplex with
    kinetics tags, --by-strand differs only in the forward strand's record,
    436 bp from the JAX CLI and 437 bp from the port (the true strand is
    440 bp); the report and the fail reads are equal. With the JAX
    scorer's ties resolved by the port's rule, every output is equal."""
    heteroduplex_with_kinetics(str(tmp_path / "in.subreads.bam"))
    argv = [IN, "out.bam", "--by-strand", "--min-rq", "0.9"]
    dj, dt = run_both(tmp_path / "run", argv)
    rows_j = bam_rows(os.path.join(dj, "out.bam"))
    rows_t = bam_rows(os.path.join(dt, "out.bam"))
    fwd = "m00001_260817_000000/11/ccs/fwd"
    assert [r["name"] for r in rows_j] == [r["name"] for r in rows_t]
    assert fwd in [r["name"] for r in rows_t]
    for a, b in zip(rows_j, rows_t):
        if a["name"] == fwd:
            assert (len(a["seq"]), len(b["seq"])) == (436, 437)
        else:
            assert_close(a, b, a["name"])
    assert_bams_match(os.path.join(dj, "out.fail_reads.bam"),
                      os.path.join(dt, "out.fail_reads.bam"))
    assert read(os.path.join(dj, "out.ccs_report.txt")) == read(
        os.path.join(dt, "out.ccs_report.txt"))
    with jax_ties_resolved():
        dr = run_in(tmp_path / "resolved", "jax", argv)
    assert_outputs_match(dr, dt, "out")
