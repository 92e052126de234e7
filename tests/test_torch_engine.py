"""The port's engine and CLI slice against the JAX package on simulated
ZMWs, and the port's import hygiene and no-fallback rules.

Bars: identical statuses and sequences, QVs within 1e-3 (the JAX
package's own sharded-vs-single-device bar, __graft_entry__.py); CLI BAM
records equal in name, sequence and np, rq within 1e-3, and identical
ccs_report.txt."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from ccs_tpu.cli import run as run_jax
from ccs_tpu.config import CcsConfig as JaxConfig
from ccs_tpu.pipeline import orchestrator as jax_orchestrator
from ccs_tpu.pipeline import zmw as jax_zmw
from ccs_tpu.pipeline.engine import CcsEngine as JaxEngine
from ccs_tpu_torch import cli
from ccs_tpu_torch.config import CcsConfig
from ccs_tpu_torch.io.bam import BamReader
from ccs_tpu_torch.pipeline import zmw as port_zmw
from ccs_tpu_torch.pipeline.engine import CcsEngine
from ccs_tpu_torch.pipeline.orchestrator import shutdown_pool
from ccs_tpu_torch.sim.simulator import simulate_zmw, write_subreads_bam
from ccs_tpu_torch.statuses import ZmwStatus

# The suite runs several pytest workers on a few cores; torch's intra-op
# threads on these small tensors only contend with them.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _stop_prepare_pools():
    """Both CLIs cache a spawned prepare pool; stop them with the module."""
    yield
    shutdown_pool()
    if jax_orchestrator._PROC_POOL is not None:
        jax_orchestrator._PROC_POOL.shutdown(wait=True)
        jax_orchestrator._PROC_POOL = None


def _zin(z, zmw=port_zmw):
    """A simulated ZMW as the engine's input, in the classes of the package
    whose engine takes it: arrays cross between the packages, objects do
    not."""
    subs, qpos = [], 0
    for read, cx in zip(z.subreads, z.cx):
        subs.append(zmw.Subread(seq=read, cx=cx, qs=qpos,
                                qe=qpos + len(read)))
        qpos += len(read) + 40
    return zmw.ZmwInput(hole=z.hole, movie="m_test", subreads=subs,
                        snr=z.snr)


def test_engine_matches_jax_engine():
    """Equivalent mutations (deleting any base of a homopolymer run,
    inserting x anywhere along a run of x) score the same in exact
    arithmetic. The JAX loop resolves such ties by rounding; the port
    always takes the leftmost member (polish_fused.equalize_equivalent),
    so that its CUDA and CPU paths agree. Where the JAX rounding picks
    another member, the candidate flags that follow the pick differ and
    QVs at those positions differ. These holes have no such tie."""
    kw = dict(tpu_window_buckets=(64,), tpu_coverage_buckets=(16,),
              tpu_window_coverage_cap=16)
    sims = [simulate_zmw(hole=h, insert_len=250, n_passes=n, snr=9.0)
            for h, n in ((6, 8), (8, 10), (7, 2), (9, 8), (11, 10), (12, 8))]
    ref = JaxEngine(JaxConfig(**kw), devices=jax.devices()[:1]).process_batch(
        [_zin(z, jax_zmw) for z in sims])
    got = CcsEngine(CcsConfig(**kw), None, "cpu").process_batch(
        [_zin(z) for z in sims])
    assert got[2].status == ZmwStatus.TOO_FEW_PASSES
    assert sum(r.status == ZmwStatus.SUCCESS for r in got) == 5
    for r, g in zip(ref, got):
        assert r.status.name == g.status.name, (r.hole, r.status, g.status)
        if r.seq is None:
            assert g.seq is None
            continue
        np.testing.assert_array_equal(g.seq, r.seq)
        np.testing.assert_allclose(g.qv, r.qv, atol=1e-3)
        assert abs(g.rq - r.rq) < 1e-3


# The open tie divergence (ROADMAP Queue 3): holes 0..33 at 250 bp with
# 8 + hole % 3 passes, SNR 9. Holes whose stitched sequence differs from
# the JAX engine's, and holes with equal sequences whose QVs differ by more
# than 1e-3, on the CPU.
TIE_HOLES = [(h, 8 + h % 3) for h in range(34)]
TIE_SEQ_DIFFS = [25]
TIE_QV_DIFFS = [0, 1, 2, 5, 7, 10, 13, 16, 20, 23, 24, 27, 29, 31]


@pytest.mark.slow
def test_tie_divergence_from_jax_engine_is_unchanged():
    """Records where the port's leftmost-member tie rule and the JAX loop's
    rounding part ways, so that a change that moves the counts is seen.
    Fixing the divergence means emptying the two lists above."""
    kw = dict(tpu_window_buckets=(64,), tpu_coverage_buckets=(16,),
              tpu_window_coverage_cap=16)
    sims = [simulate_zmw(hole=h, insert_len=250, n_passes=n, snr=9.0)
            for h, n in TIE_HOLES]
    ref = JaxEngine(JaxConfig(**kw), devices=jax.devices()[:1]).process_batch(
        [_zin(z, jax_zmw) for z in sims])
    got = CcsEngine(CcsConfig(**kw), None, "cpu").process_batch(
        [_zin(z) for z in sims])
    seq_diffs, qv_diffs = [], []
    for r, g in zip(ref, got):
        assert r.status.name == g.status.name == "SUCCESS"
        if not np.array_equal(r.seq, g.seq):
            seq_diffs.append(r.hole)
        elif np.abs(r.qv - g.qv).max() > 1e-3:
            qv_diffs.append(r.hole)
    assert seq_diffs == TIE_SEQ_DIFFS
    assert qv_diffs == TIE_QV_DIFFS


@pytest.fixture(scope="module")
def skill_fixture(tmp_path_factory):
    """The repo's verify-recipe fixture: hole 0 passes, hole 1 lacks
    passes, hole 2 fails SNR."""
    d = tmp_path_factory.mktemp("skill")
    path = str(d / "in.subreads.bam")
    zmws = [simulate_zmw(hole=h, insert_len=200, n_passes=[9, 2, 8][h],
                         snr=[8.5, 8.5, 1.0][h]) for h in range(3)]
    write_subreads_bam(path, zmws)
    return path


def _records(path):
    with BamReader(path) as r:
        return [(rec.name, rec.seq.tolist(), rec.tag("np"), rec.tag("rq"))
                for rec in r]


def test_cli_matches_jax_cli(skill_fixture, tmp_path):
    out_j = str(tmp_path / "jax.bam")
    out_t = str(tmp_path / "torch.bam")
    assert run_jax([skill_fixture, out_j]) == 0
    assert cli.run([skill_fixture, out_t], device="cpu") == 0
    rj, rt = _records(out_j), _records(out_t)
    assert len(rj) == len(rt) == 1
    for a, b in zip(rj, rt):
        assert a[:3] == b[:3]
        assert abs(a[3] - b[3]) < 1e-3
    with open(str(tmp_path / "jax.ccs_report.txt")) as fj, \
            open(str(tmp_path / "torch.ccs_report.txt")) as ft:
        assert fj.read() == ft.read()


def test_cli_without_cuda_raises(skill_fixture, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.run([skill_fixture, str(tmp_path / "o.bam")])


def _python(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_port_imports_no_jax():
    out = _python(
        "import sys, numpy as np, torch\n"
        "import ccs_tpu_torch, ccs_tpu_torch.cli\n"
        "import ccs_tpu_torch.parallel.mesh\n"
        "import ccs_tpu_torch.parallel.multihost\n"
        "import ccs_tpu_torch.models.dc_polisher, "
        "ccs_tpu_torch.models.train_dc, ccs_tpu_torch.models.fit, "
        "ccs_tpu_torch.models.fit_bundle\n"
        "import ccs_tpu_torch.pipeline.polish, ccs_tpu_torch.ops.hmm_forward, "
        "ccs_tpu_torch.ops.hmm_oracle, ccs_tpu_torch.tools.fit_clean_qv\n"
        "from ccs_tpu_torch.models.chemistry import default_params\n"
        "from ccs_tpu_torch.ops.tables import params_to_torch\n"
        "from ccs_tpu_torch.ops.hmm_score import score_dense\n"
        "t = lambda a: torch.from_numpy(np.asarray(a))\n"
        "lls, ll0 = score_dense(t(np.zeros((1, 6), np.int8)),"
        " t(np.array([6], np.int32)), t(np.array([3], np.int32)),"
        " t(np.zeros((1, 2, 8), np.int8)), t(np.array([[8, 7]], np.int32)),"
        " params_to_torch(default_params(), 'cpu'))\n"
        "assert bool(torch.isfinite(ll0).all())\n"
        "print(sorted(m for m in sys.modules if m in ('jax', 'ccs_tpu')"
        " or m.startswith(('jax.', 'ccs_tpu.'))))\n")
    assert out.strip() == "[]"


def test_prepare_module_imports_neither_torch_nor_jax():
    out = _python("import sys\n"
                  "import ccs_tpu_torch.pipeline.prepare\n"
                  "print('torch' in sys.modules, 'jax' in sys.modules)\n")
    assert out.strip() == "False False"
