"""The port's CLI against the JAX CLI in the output and selection modes:
--all with --hifi-kinetics, --all-kinetics, --chunk i/N, FASTQ and
consensusreadset.xml output (the twins of tests/test_cli.py:71,88,106 and
tests/test_modes.py:102), on one small BAM with kinetics tags: two ZMWs that
polish, one that lacks passes and one below the SNR threshold; and --all
with --subread-fallback on a one-pass ZMW. The inputs are
free of ties between equivalent mutations (tests/test_torch_ties.py). Bars
in tests/_torch_cli_twin.py."""

import gzip
import os

import numpy as np
import pytest
import torch

from ccs_tpu.pipeline import orchestrator as jax_orchestrator
from ccs_tpu_torch.io.pbi import read_pbi
from ccs_tpu_torch.ops import dna
from ccs_tpu_torch.pipeline.kinetics import codec_v1_decode
from ccs_tpu_torch.pipeline.orchestrator import shutdown_pool
from ccs_tpu_torch.sim.simulator import simulate_zmw, write_subreads_bam
from tests._torch_cli_twin import (assert_outputs_match, bam_rows,
                                   compare_reports, read, run_both, xml_text)

torch.set_num_threads(1)

IN = "../../in.subreads.bam"
# hole: (passes, snr); hole 1 lacks passes, hole 3 fails the SNR filter
CELL = {0: (8, 9.0), 1: (2, 9.0), 2: (8, 9.0), 3: (8, 1.5)}


@pytest.fixture(scope="module", autouse=True)
def _stop_prepare_pools():
    yield
    shutdown_pool()
    if jax_orchestrator._PROC_POOL is not None:
        jax_orchestrator._PROC_POOL.shutdown(wait=True)
        jax_orchestrator._PROC_POOL = None


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    d = tmp_path_factory.mktemp("modes")
    write_subreads_bam(str(d / "in.subreads.bam"),
                       [simulate_zmw(hole=h, insert_len=200, n_passes=p,
                                     snr=s) for h, (p, s) in CELL.items()],
                       with_kinetics=True)
    return d


@pytest.fixture(scope="module")
def whole_run(cell):
    """The default mode, written as a consensusreadset.xml (BAM + .pbi +
    XML + reports), by both CLIs: the run the chunks merge to."""
    return run_both(cell / "whole", [IN, "out.consensusreadset.xml"])


def test_all_with_hifi_kinetics_matches_jax(cell):
    """--all --hifi-kinetics: one record per ZMW that is not cut by the
    SNR filter (hole 1 through the low-pass path), the kinetics tags (fi fp ri rp fn
    rn) on the polished ones; records, .pbi, fail_reads.bam, report and
    metrics equal."""
    dj, dt = run_both(cell / "all", [IN, "out.bam", "--all",
                                     "--hifi-kinetics"])
    rows = assert_outputs_match(dj, dt, "out")
    holes = sorted(int(r["name"].split("/")[1]) for r in rows)
    assert holes == [0, 1, 2]
    by_hole = {int(r["name"].split("/")[1]): r for r in rows}
    if by_hole[1]["rq"] < 0:                   # an unpolished read: QV 10
        assert set(by_hole[1]["qual"]) == {10}
    for h in (0, 2):
        r = by_hole[h]
        assert r["rq"] > 0.99
        for tag in ("fi", "fp", "ri", "rp"):
            assert len(r[tag]) == len(r["seq"]), tag
        assert r["fn"] >= 3 and r["rn"] >= 3
        assert 0 < codec_v1_decode(r["fi"]).mean() < 80


def test_all_kinetics_matches_jax(cell):
    dj, dt = run_both(cell / "allkin", [IN, "out.bam", "--all-kinetics"])
    rows = assert_outputs_match(dj, dt, "out")
    assert sorted(int(r["name"].split("/")[1]) for r in rows) == [0, 2]
    assert all("fi" in r for r in rows)


def test_xml_output_matches_jax(whole_run):
    dj, dt = whole_run
    assert_outputs_match(dj, dt, "out")
    xml = "out.consensusreadset.xml"
    assert xml_text(os.path.join(dj, xml)) == xml_text(os.path.join(dt, xml))
    assert "<pbds:NumRecords>2</pbds:NumRecords>" in read(
        os.path.join(dt, xml))


def test_chunks_match_jax_and_merge_to_the_whole_run(cell, whole_run):
    """--chunk 1/2 and 2/2: each equal to the JAX CLI's chunk, and the two
    together hold exactly the whole run's records."""
    merged = []
    for i in (1, 2):
        dj, dt = run_both(cell / f"chunk{i}", [IN, f"c{i}.bam", "--chunk",
                                               f"{i}/2"])
        merged += assert_outputs_match(dj, dt, f"c{i}")
    whole = bam_rows(os.path.join(whole_run[1], "out.bam"))
    assert sorted(merged, key=lambda r: r["name"]) == whole


def test_fastq_output_matches_jax(cell, whole_run):
    """FASTQ as the main output: the same text as the JAX CLI's, and the
    sequences of the whole run's BAM records."""
    dj, dt = run_both(cell / "fastq", [IN, "out.fastq.gz"])
    with gzip.open(os.path.join(dj, "out.fastq.gz"), "rt") as fj, \
            gzip.open(os.path.join(dt, "out.fastq.gz"), "rt") as ft:
        text_j, text_t = fj.read(), ft.read()
    assert text_t == text_j
    lines = text_t.strip().split("\n")
    assert len(lines) == 8 and set(lines[1]) <= set("ACGT")
    compare_reports(dj, dt, "out")
    whole = bam_rows(os.path.join(whole_run[1], "out.bam"))
    assert [ln.encode() for ln in lines[1::4]] == [
        dna.decode(np.frombuffer(r["seq"], np.int8)) for r in whole]


def test_port_pbi_indexes_its_bam(whole_run):
    """The port's .pbi against its own BAM: one entry per record, holes in
    order (the JAX one is compared field by field above)."""
    dt = whole_run[1]
    rows = bam_rows(os.path.join(dt, "out.bam"))
    idx = read_pbi(os.path.join(dt, "out.bam.pbi"))
    assert idx.n_reads == len(rows)
    assert idx.hole_number.tolist() == [int(r["name"].split("/")[1])
                                        for r in rows]


def test_all_with_subread_fallback_matches_jax(tmp_path):
    """--all --subread-fallback --hifi-kinetics: a ZMW with one full pass
    is written as its median-length subread (rq -1, QV 10) with that
    subread's own kinetics, beside a polished ZMW (hole 0 of the cell,
    with the same kinetics draws)."""
    d = tmp_path / "fb"
    d.mkdir()
    write_subreads_bam(str(d / "in.subreads.bam"),
                       [simulate_zmw(hole=0, insert_len=200, n_passes=8,
                                     snr=9.0),
                        simulate_zmw(hole=4, insert_len=200, n_passes=1,
                                     snr=9.0)], with_kinetics=True)
    dj, dt = run_both(d / "run", [IN, "out.bam", "--all", "--subread-fallback",
                                  "--hifi-kinetics"])
    rows = assert_outputs_match(dj, dt, "out")
    by_hole = {int(r["name"].split("/")[1]): r for r in rows}
    assert sorted(by_hole) == [0, 4]
    fb = by_hole[4]
    assert fb["rq"] < 0 and set(fb["qual"]) == {10}
    assert len(fb["pw"]) == len(fb["seq"])
