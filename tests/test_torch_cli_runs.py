"""The port's CLI against the JAX CLI in the run-level modes: --tpu-resume-dir
after a crash (tests/test_checkpoint.py:30), fail_reads.bam, the CLR
subsample and --stderr-json-log with -j 2 (tests/test_failreads.py:117),
--tpu-control-fasta on a control ZMW (the engine-level
tests/test_failreads.py:89, here through both CLIs), and the orchestrator's
worker threads and error propagation (tests/test_orchestrator.py:42,120).
Inputs were chosen by running both CLIs: free of ties between equivalent
mutations that the JAX loop settles by rounding (tests/test_torch_ties.py).
Bars in tests/_torch_cli_twin.py."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from ccs_tpu.config import CcsConfig as JaxConfig
from ccs_tpu.pipeline import orchestrator as jax_orchestrator
from ccs_tpu.pipeline import zmw as jax_zmw
from ccs_tpu.pipeline.engine import CcsEngine as JaxEngine
from ccs_tpu_torch.config import CcsConfig
from ccs_tpu_torch.models.chemistry import default_params
from ccs_tpu_torch.ops import dna
from ccs_tpu_torch.pipeline import checkpoint, orchestrator
from ccs_tpu_torch.pipeline import zmw as port_zmw
from ccs_tpu_torch.pipeline.adapters import FF_CONTROL, FF_MEDIAN_SUBREAD
from ccs_tpu_torch.pipeline.engine import CcsEngine
from ccs_tpu_torch.pipeline.orchestrator import run_pipeline, shutdown_pool
from ccs_tpu_torch.sim.simulator import (CX_FULL, SimZmw, simulate_read,
                                         simulate_zmw, write_subreads_bam)
from tests._torch_cli_twin import (assert_bams_match, assert_close,
                                   assert_outputs_match, assert_pbis_match,
                                   read, run_both, run_in, xml_text)

torch.set_num_threads(1)

IN = "../../in.subreads.bam"


@pytest.fixture(scope="module", autouse=True)
def _stop_prepare_pools():
    yield
    shutdown_pool()
    if jax_orchestrator._PROC_POOL is not None:
        jax_orchestrator._PROC_POOL.shutdown(wait=True)
        jax_orchestrator._PROC_POOL = None


def test_resume_after_a_crash_matches_jax(tmp_path, monkeypatch):
    """A port run that crashes after its second flushed batch, resumed with
    the same --tpu-resume-dir, processes only the ZMWs after the watermark
    and writes exactly the JAX CLI's uninterrupted output."""
    write_subreads_bam(str(tmp_path / "in.subreads.bam"),
                       [simulate_zmw(hole=h, insert_len=140, n_passes=8,
                                     snr=9.0) for h in range(6)])
    argv = [IN, "out.bam", "--min-rq", "0.9", "--batch-size", "2"]
    dj = run_in(tmp_path / "run", "jax", argv)

    orig = checkpoint.Checkpointer.write_batch
    calls = []

    def bomb(self, *a, **k):
        orig(self, *a, **k)
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("simulated crash")

    ck = ["--tpu-resume-dir", "../ck"]
    monkeypatch.setattr(checkpoint.Checkpointer, "write_batch", bomb)
    with pytest.raises(RuntimeError, match="simulated crash"):
        run_in(tmp_path / "run", "port", argv + ck)
    monkeypatch.setattr(checkpoint.Checkpointer, "write_batch", orig)
    with open(str(tmp_path / "run" / "ck" / "watermark.json")) as fh:
        wm = json.load(fh)
    assert wm["n_batches"] == 2 and wm["last_hole"] == 3

    seen = []
    orig_rp = orchestrator.run_pipeline

    def spy(engine, zmws, emit, **kw):
        def watched():
            for z in zmws:
                seen.append(z.hole)
                yield z
        return orig_rp(engine, watched(), emit, **kw)

    monkeypatch.setattr(orchestrator, "run_pipeline", spy)
    dt = run_in(tmp_path / "run", "port", argv + ck)
    assert seen == [4, 5]
    assert not os.path.exists(str(tmp_path / "run" / "ck" / "watermark.json"))
    assert_outputs_match(dj, dt, "out")


def test_fail_reads_clr_and_json_log_match_jax(tmp_path, capfd):
    """fail_reads.bam (the 2-pass ZMW's median subread, ff 0x4), the CLR
    subsample's SubreadSet XML and .pbi, and the report; every stderr line
    of the port's run is a JSON object with the JAX CLI's keys. Run with
    -j 2 prepare workers."""
    write_subreads_bam(str(tmp_path / "in.subreads.bam"),
                       [simulate_zmw(hole=h, insert_len=150, n_passes=p,
                                     snr=snr)
                        for h, p, snr in ((10, 9, 8.5), (1, 2, 8.5),
                                          (2, 8, 1.0))])
    argv = [IN, "out.bam", "--subsample-clr-perc", "100", "-j", "2",
            "--stderr-json-log", "--log-level", "INFO"]
    dj = run_in(tmp_path / "run", "jax", argv)
    err_j = capfd.readouterr().err
    dt = run_in(tmp_path / "run", "port", argv)
    err_t = capfd.readouterr().err
    assert_outputs_match(dj, dt, "out")
    fails = assert_bams_match(os.path.join(dj, "out.fail_reads.bam"),
                              os.path.join(dt, "out.fail_reads.bam"))
    by_hole = {r["zm"]: r for r in fails}
    assert by_hole[1]["ff"] & FF_MEDIAN_SUBREAD
    xml = "out.subsampled.subreadset.xml"
    assert xml_text(os.path.join(dj, xml)) == xml_text(os.path.join(dt, xml))
    assert 'Value="[10]"' in read(os.path.join(dt, xml))
    assert_pbis_match(os.path.join(dj, xml + ".pbi"),
                      os.path.join(dt, xml + ".pbi"))
    logs = []
    for err in (err_j, err_t):
        lines = [json.loads(ln) for ln in err.splitlines()
                 if ln.startswith("{")]
        assert lines, err
        logs.append(lines)
    keys = {"timestamp", "level", "message", "component"}
    assert all(set(x) == keys for lines in logs for x in lines)
    msgs = [{x["message"] for x in lines} for lines in logs]
    assert "Using chemistry model SP3-C3/5.0-8M" in msgs[0] & msgs[1]


def _control_zmw(control, hole, rng):
    """A ZMW whose insert is bases 100-400 of the control, 8 passes."""
    params = default_params()
    ins = control[100:400]
    reads, strands = [], []
    for p in range(8):
        tpl = ins if p % 2 == 0 else dna.revcomp(ins)
        reads.append(simulate_read(tpl, params, 5, rng))
        strands.append(p % 2)
    return SimZmw(hole=hole, insert=ins, subreads=reads, strands=strands,
                  cx=[CX_FULL] * 8, snr=np.full(4, 9.0, np.float32))


def test_control_fasta_matches_jax(tmp_path):
    """--tpu-control-fasta: the control ZMW is classified a control (ff
    0x2) and written to fail_reads.bam, the other ZMW polishes; records,
    fail reads and report equal."""
    rng = np.random.default_rng(3)
    control = rng.integers(0, 4, 800).astype(np.int8)
    (tmp_path / "controls.fasta").write_text(
        ">ctrl\n" + dna.decode(control).decode() + "\n")
    write_subreads_bam(str(tmp_path / "in.subreads.bam"),
                       [_control_zmw(control, 1, rng),
                        simulate_zmw(hole=21, insert_len=300, n_passes=8,
                                     snr=9.0)])
    dj, dt = run_both(tmp_path / "run", [IN, "out.bam", "--tpu-control-fasta",
                                         "../../controls.fasta"])
    rows = assert_outputs_match(dj, dt, "out")
    assert [r["zm"] for r in rows] == [21]
    fails = assert_bams_match(os.path.join(dj, "out.fail_reads.bam"),
                              os.path.join(dt, "out.fail_reads.bam"))
    ctrl = [r for r in fails if r["zm"] == 1]
    assert len(ctrl) == 1 and ctrl[0]["ff"] & FF_CONTROL


def _zin(z, zmw):
    subs, qpos = [], 0
    for read_, cx in zip(z.subreads, z.cx):
        subs.append(zmw.Subread(seq=read_, cx=cx, qs=qpos,
                                qe=qpos + len(read_)))
        qpos += len(read_) + 40
    return zmw.ZmwInput(hole=z.hole, movie="m_orch", subreads=subs,
                        snr=z.snr)


def test_orchestrator_threads_and_errors_match_jax():
    """Twin of tests/test_orchestrator.py:42,120: the pipelined run (2
    prepare workers, 4-ZMW batches, input buffer 2) gives the serial
    engine's results and the JAX pipeline's; an error raised by the input
    iterator reaches the caller of both."""
    sims = [simulate_zmw(hole=h, insert_len=120, n_passes=6, snr=9.0)
            for h in range(8)]
    kw = dict(min_rq=0.0, tpu_window_buckets=(64,))
    eng = CcsEngine(CcsConfig(**kw), None, "cpu")
    jeng = JaxEngine(JaxConfig(**kw), devices=jax.devices()[:1])
    serial = eng.process_batch([_zin(z, port_zmw) for z in sims])
    piped, ref = [], []
    run_pipeline(eng, iter([_zin(z, port_zmw) for z in sims]),
                 lambda r, n: piped.extend(r), batch_size=4, num_threads=2,
                 input_buffer=2)
    jax_orchestrator.run_pipeline(
        jeng, iter([_zin(z, jax_zmw) for z in sims]),
        lambda r, n: ref.extend(r), batch_size=4, num_threads=2,
        input_buffer=2)
    assert len(piped) == len(serial) == len(ref) == len(sims)
    for a, b, c in zip(serial, piped, ref):
        assert a.hole == b.hole == c.hole
        assert a.status.name == b.status.name == c.status.name
        if c.seq is not None:
            np.testing.assert_array_equal(a.seq, b.seq)
            np.testing.assert_array_equal(b.seq, c.seq)
            np.testing.assert_array_equal(a.qv, b.qv)
            np.testing.assert_allclose(b.qv, c.qv, atol=1e-3)
            assert_close(float(b.rq), float(c.rq), f"hole {c.hole} rq")

    for pipe, e, zmw in ((run_pipeline, eng, port_zmw),
                         (jax_orchestrator.run_pipeline, jeng, jax_zmw)):
        def bad_iter():
            yield _zin(simulate_zmw(hole=0, insert_len=80, n_passes=5,
                                    snr=9.0), zmw)
            raise RuntimeError("boom")

        with pytest.raises(RuntimeError, match="boom"):
            pipe(e, bad_iter(), lambda r, n: None, batch_size=2,
                 num_threads=1, input_buffer=1)
