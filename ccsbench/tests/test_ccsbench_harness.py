"""The harness end to end at a tiny size on the CPU: a sound run is
correct, the control and every planted fault are not, and what a run
prints is complete. The card-only parts (the run's look for a card, the
device trace, the scorer's roofline) skip here."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from ccsbench import bamio, control, generator, harness, reference
from ccsbench.tests import tiny


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("ccsbench")))


@pytest.fixture(scope="module")
def sound(bench, tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("sound"))
    return harness.run_cell(bench, "tiny", 2 ** 33 + 5, 3.0, False, wd,
                            devices=["cpu"], log=lambda m: None)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def test_sound_run_is_correct(sound):
    assert sound["correct"], sound["numbers"]
    assert sound["numbers"]["breaches"] == 0
    assert sound["facts"]["hifi_records"] == sound["attempted"]
    assert sound["failed"] == 0
    w = sound["obs"]["window"]
    assert w["z1"] > w["z0"] and w["t1"] - w["t0"] >= 3.0
    assert w["cpu1"] > w["cpu0"]
    assert sound["obs"]["setup_s"] > 0
    assert sound["obs"]["wall_split"] is not None


def test_end_to_end_metrics(bench, sound):
    m = harness.metrics_of(bench, "tiny", False, sound["obs"])
    assert set(m) == {"zmw_per_s", "host_cpu_s_per_kzmw", "setup_s"}
    assert all(v["value"] > 0 for v in m.values())
    assert m["zmw_per_s"]["unit"] == "ZMW/s"


def test_per_layer_metrics_without_a_card(bench, sound):
    """The counters' readers read; the device's readers find nothing to
    read on the CPU and leave their metric out."""
    m = harness.metrics_of(bench, "tiny", True, sound["obs"])
    assert {"prepare_thread_s_per_kzmw", "device_step_s_per_kzmw",
            "finalize_s_per_kzmw"} <= set(m)
    assert "hmm_score_sparse_roofline" not in m
    assert "device_idle_share" not in m


@pytest.mark.parametrize("plant,fails", [
    ("unchanged", "hifi_err_per_kb"),
    ("half_batch", "breaches"),
    ("altered", "hifi_worst_err_per_kb"),
    ("stop_early", "hifi_shortfall"),
])
def test_control_and_faults_are_not_correct(plant, fails, bench,
                                            tmp_path_factory):
    res = control.run_planted(bench, "tiny", 99, 2.0, plant,
                              str(tmp_path_factory.mktemp(plant)),
                              devices=["cpu"])
    assert not res["correct"], res["numbers"]
    assert res["numbers"][fails] > res["limits"][fails], res["numbers"]


def test_input_that_runs_out_fails_the_run(bench, tmp_path, monkeypatch):
    monkeypatch.setattr(harness, "INPUT_MARGIN", 0.0)
    with pytest.raises(harness.RunFailed, match="ran out"):
        harness.run_cell(bench, "tiny", 3, 60.0, False, str(tmp_path),
                         devices=["cpu"], log=lambda m: None)


def test_run_without_a_card_prints_no_result():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run([sys.executable, os.path.join(tiny.REPO, "ccsbench",
                                                     "run.py"),
                        "--workload", "default.15kb_p8", "--seed", "1",
                        "--seconds", "10", "--trace", "0"],
                       capture_output=True, text=True, cwd=tiny.REPO)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_run_with_only_the_benchmark_prints_no_result(tmp_path):
    """A directory with BENCHMARK.json and ccsbench/ but not the program."""
    root = tiny.make_root(str(tmp_path))["_root"]
    env = dict(os.environ, PYTHONPATH="")
    r = subprocess.run([sys.executable, "ccsbench/run.py", "--workload",
                        "default.15kb_p8", "--seed", "1", "--seconds", "10",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=root, env=env)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_card_run_end_to_end(card, tmp_path):
    r = subprocess.run([sys.executable, "ccsbench/run.py", "--workload",
                        "default.15kb_p8", "--seed", "5", "--seconds", "5",
                        "--trace", "1"], capture_output=True, text=True,
                       cwd=tiny.REPO, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert 0 < out["metrics"]["hmm_score_sparse_roofline"]["value"] <= 100
    assert out["device"]["busy_s"] > 0


def test_bam_round_trip_through_the_program_reader(tmp_path):
    """The benchmark's subreads BAM reads back, through the program's own
    reader, as the pool it was written from."""
    from ccs_tpu_torch.io.bam import BamReader
    from ccs_tpu_torch.io.pbi import read_pbi
    traffic = dict(tiny.TRAFFIC, pool_zmws=3)
    pool = generator.make_pool(traffic, 7)
    parts = generator.pool_parts(pool)
    path = str(tmp_path / "in.subreads.bam")
    holes, ends = generator.write_bam(path, parts, 5, first=1)
    assert len(ends) == 5 and ends == sorted(ends)
    recs = list(BamReader(path))
    assert len(recs) == sum(len(pool[m].subreads) for m in holes.values())
    i = 0
    for hole, m in holes.items():
        for read in pool[m].subreads:
            rec = recs[i]
            i += 1
            assert rec.tag("zm") == hole
            assert np.array_equal(rec.seq, read)
            assert rec.name.startswith(f"{bamio.MOVIE}/{hole}/")
    idx = read_pbi(path + ".pbi")
    assert list(idx.unique_zmws()) == list(holes)
    back = bamio.read_records(path)
    assert [r["tags"]["zm"] for r in back] == [r.tag("zm") for r in recs]


def test_edit_distance_against_plain_dp():
    rng = np.random.default_rng(0)
    for _ in range(200):
        a = rng.integers(0, 4, rng.integers(1, 70)).astype(np.int8)
        b = a.copy() if rng.random() < 0.5 else \
            rng.integers(0, 4, rng.integers(0, 70)).astype(np.int8)
        if len(b) and rng.random() < 0.7:
            b = np.delete(b, rng.integers(0, len(b)))
        assert reference.edit_distance(a, b) == _plain_dp(a, b)


def _plain_dp(a, b):
    d = np.arange(len(b) + 1)
    for i in range(1, len(a) + 1):
        prev, d = d, d.copy()
        d[0] = i
        for j in range(1, len(b) + 1):
            d[j] = min(prev[j] + 1, d[j - 1] + 1,
                       prev[j - 1] + (a[i - 1] != b[j - 1]))
    return int(d[-1])


@pytest.mark.parametrize("band", [reference.BAND, 1])
def test_banded_alignment_against_plain_dp(band, monkeypatch):
    """The band's distance is the exact one, also where pairs leave a
    narrow band (then Myers' distance stands in), and its traceback holds
    one event per edit."""
    monkeypatch.setattr(reference, "BAND", band)
    rng = np.random.default_rng(band)
    seqs, truths = [], []
    for _ in range(120):
        t = rng.integers(0, 4, rng.integers(0, 80)).astype(np.int8)
        s = t.copy()
        for _e in range(rng.integers(0, 30)):
            k = int(rng.integers(0, len(s) + 1))
            op = rng.integers(0, 3)
            if op == 0 and k < len(s):
                s[k] = (s[k] + 1) % 4
            elif op == 1:
                s = np.insert(s, k, rng.integers(0, 4)).astype(np.int8)
            elif k < len(s):
                s = np.delete(s, k)
        seqs.append(s)
        truths.append(t)
    for s, t, (e, ev) in zip(seqs, truths,
                             reference.aligned_errors(seqs, truths)):
        assert e == _plain_dp(s, t)
        assert len(ev) >= e


def test_indel_charged_to_the_lowest_qv_of_its_runs():
    seq = np.array([0, 1, 2, 2, 2, 3, 0], np.int8)     # A C G G G T A
    qual = np.array([40, 40, 40, 40, 40, 10, 40], np.uint8)
    ev = [(reference.INS, 2), (reference.DEL, 3), (reference.SUB, 0)]
    assert reference.charged_bases(seq, qual, ev) == [5, 5, 0]


def test_shortfall_and_qv_numbers_find_their_faults(monkeypatch):
    """Records a base off in a homopolymer with a low QV there read
    calibrated; the same records under raised QVs, or under an rq below
    0.99, fail the QV number or the yield."""
    monkeypatch.setattr(reference, "QV_MIN_CLAIM", 0.5)
    pool = generator.make_pool(tiny.TRAFFIC, 5)
    holes = {bamio.HOLE_BASE + i: i for i in range(len(pool))}
    recs = []
    for i, z in enumerate(pool):
        seq = z.insert.copy()
        qual = np.full(len(seq), 40, np.uint8)
        seq[100] = (seq[100] + 1) % 4
        qual[100] = 3
        recs.append({"name": f"m/{bamio.HOLE_BASE + i}/ccs", "seq": seq,
                     "qual": qual, "tags": {"zm": bamio.HOLE_BASE + i,
                                            "rq": 0.995, "np": 8}})
    n = len(pool)
    report = {"ZMWs input": n, "ZMWs pass filters": n,
              "ZMWs fail filters": 0, "ZMWs shortcut filters": 0}
    g = {"min_rq": 0.99, "min_passes": 3, "top_passes": 60}
    sound, _f = reference.judge(recs, report, n, holes, pool, g)
    assert sound["hifi_shortfall"] == 0 and sound["breaches"] == 0
    assert sound["qv_worst_bin_err_over_claim"] < 2.5
    for r in recs:
        r["qual"] = np.full(len(r["seq"]), 40, np.uint8)
    raised, _f = reference.judge(recs, report, n, holes, pool, g)
    assert raised["qv_worst_bin_err_over_claim"] > 10 * \
        sound["qv_worst_bin_err_over_claim"]
    recs[0]["tags"]["rq"] = 0.98
    g_all = dict(g, min_rq=0.9)
    low, _f = reference.judge(recs, report, n, holes, pool, g_all)
    assert low["hifi_shortfall"] == pytest.approx(1 / n)


@pytest.mark.parametrize("counts,want", [
    ((90, 10, 0, 0), 0),        # ten ZMWs filtered: each answered
    ((90, 10, 0, 3), 3),        # three of them were exceptions
    ((80, 10, 0, 0), 10),       # ten never counted
    ((0, 0, 0, 0), 100),
])
def test_failed_counts_unanswered_zmws(counts, want):
    """``failed`` on the result line: ZMWs the report leaves out or counts
    as an exception in the program, not those a filter turned away."""
    keys = ("ZMWs pass filters", "ZMWs fail filters",
            "ZMWs shortcut filters", "Unknown error")
    report = dict(zip(keys, counts), **{"ZMWs input": sum(counts[:3])})
    assert harness.unanswered(report, 100) == want


def test_report_labels_read_back(tmp_path):
    """The counts that ``failed`` reads are the labels the port's report
    writes."""
    from ccs_tpu_torch.report.stats import RunStats, format_ccs_report
    from ccs_tpu_torch.statuses import ZmwStatus
    st = RunStats()
    st.n_input = 10
    st.status_counts[ZmwStatus.SUCCESS] = 7
    st.status_counts[ZmwStatus.POOR_QUALITY] = 2
    st.status_counts[ZmwStatus.EXCEPTION_THROWN] = 1
    st.read_lengths, st.read_rqs = [100] * 7, [0.995] * 7
    path = tmp_path / "r.txt"
    path.write_text(format_ccs_report(st))
    report = bamio.read_report(str(path))
    assert report["ZMWs fail filters"] == 3
    assert report["Unknown error"] == 1
    assert harness.unanswered(report, 10) == 1


def test_input_cut_leaves_whole_zmws(tmp_path):
    """Cut while a reader sits inside ZMW 3: the file keeps ZMWs 0-5
    whole, and the program's reader reads them and stops."""
    from ccs_tpu_torch.io.bam import BamReader
    pool = generator.make_pool(tiny.TRAFFIC, 3)
    parts = generator.pool_parts(pool)
    path = str(tmp_path / "in.subreads.bam")
    holes, ends = generator.write_bam(path, parts, 12)
    with open(path, "rb") as fh:
        fh.seek(ends[2] + 1)
        cut = harness.InputCut(path, ends, 2)
        cut()
    assert cut.kept == 6
    got = [r.tag("zm") for r in BamReader(path)]
    want = [h for h, m in list(holes.items())[:6]
            for _ in pool[m].subreads]
    assert got == want
