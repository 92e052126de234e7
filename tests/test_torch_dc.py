"""The port's DC window-refinement stage, its training, the chemistry
fitter and the --tpu-profile-dir hook, held against the JAX package on the
same numpy-seeded inputs (CPU: plain scorer versions on both sides).

Bars: window features 1e-6 and model outputs 1e-5 (float32 matrix products
summed in another order); corrections identical; refine_chunk on one
polished batch fed to both packages: templates, cores and ``processed``
identical, QVs within 1e-3 (the engine's bar). The engine with
--tpu-dc-polish against the JAX engine on the tie-free holes of
test_torch_engine.py, under that file's bars. Loss and gradients of one
training step within 1e-5 of the largest magnitude; five Adam steps within
1e-5 of optax.adam. The fitter is a framework-free copy: bit-identical.
"""

import dataclasses
import functools
import glob
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ccs_tpu.config import CcsConfig as JaxConfig
from ccs_tpu.models import dc_polisher as jdc
from ccs_tpu.models import fit as jfit
from ccs_tpu.models.chemistry import default_params as jax_default_params
from ccs_tpu.ops import hmm_jax
from ccs_tpu.pipeline import polish_fused as jpf
from ccs_tpu.pipeline import zmw as jax_zmw
from ccs_tpu.pipeline.engine import CcsEngine as JaxEngine
from ccs_tpu_torch import cli
from ccs_tpu_torch.config import CcsConfig
from ccs_tpu_torch.io.bam import BamReader
from ccs_tpu_torch.models import chemistry as tchem
from ccs_tpu_torch.models import dc_polisher as tdc
from ccs_tpu_torch.models import fit as tfit
from ccs_tpu_torch.models.train_dc import mismatch_chemistry
from ccs_tpu_torch.ops.tables import params_to_torch
from ccs_tpu_torch.pipeline import engine as engine_mod
from ccs_tpu_torch.pipeline import polish_fused as tpf
from ccs_tpu_torch.pipeline import zmw as port_zmw
from ccs_tpu_torch.pipeline.engine import CcsEngine
from ccs_tpu_torch.pipeline.orchestrator import shutdown_pool
from ccs_tpu_torch.sim.simulator import (simulate_read, simulate_zmw,
                                         write_subreads_bam)
from ccs_tpu_torch.statuses import ZmwStatus

torch.set_num_threads(1)

T_CAP, R_CAP = 44, 39


@pytest.fixture(scope="module", autouse=True)
def _stop_prepare_pool():
    yield
    shutdown_pool()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _feature_inputs(seed=0, B=6, T=24):
    """Templates with a run longer than 8, tlen < T, a padding row (tlen 1,
    all -1, coverage 0), a NEG slot."""
    rng = np.random.default_rng(seed)
    tpl = rng.integers(0, 4, (B, T)).astype(np.int8)
    tpl[0, 2:14] = 1
    tlen = np.array([T, 20, 15, 1, T, 10], np.int32)[:B]
    for b in range(B):
        tpl[b, tlen[b]:] = -1
    tpl[3] = -1
    lls = rng.normal(-50, 8, (B, 9 * T + 4)).astype(np.float32)
    lls[1, 5] = tpf.NEG
    ll = rng.normal(-45, 3, B).astype(np.float32)
    qv = rng.uniform(0, 60, (B, T)).astype(np.float32)
    cov = np.array([8, 4, 16, 0, 12, 3], np.int32)[:B]
    return tpl, tlen, lls, ll, qv, cov


@pytest.mark.parametrize("with_extra", [False, True])
def test_window_features_match_jax(with_extra):
    arrs = _feature_inputs()
    extra = (np.random.default_rng(1).random(arrs[0].shape + (3,))
             .astype(np.float32) if with_extra else None)
    ref = np.asarray(jdc.window_features(*map(jnp.asarray, arrs),
                                         extra=extra))
    got = tdc.window_features(*map(_t, arrs), extra=extra).numpy()
    assert got.shape == ref.shape == arrs[0].shape + (
        tdc.N_BASE_FEATS + (3 if with_extra else 0),)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    # the run of 12 equal bases reads as capped at 8 (9/8 at its end)
    assert got[0, 13, 11] == pytest.approx(9 / 8)


def _models():
    """(name, JAX DcModel, port DcModel) pairs: the shipped dc_v0 and a
    fresh init with random heads (init_model's heads are zero)."""
    rng = np.random.default_rng(2)
    init = jdc.init_model(rng, hidden=8, ctx=1)
    init.w_cls = rng.normal(0, 0.3, init.w_cls.shape).astype(np.float32)
    init.w_err = rng.normal(0, 0.3, init.w_err.shape).astype(np.float32)
    init.b_err = rng.normal(0, 0.3, 1).astype(np.float32)
    port_init = tdc.DcModel(**dataclasses.asdict(init))
    return {"dc_v0": (jdc.builtin_model(), tdc.builtin_model()),
            "init": (init, port_init)}


@pytest.mark.parametrize("name", ["dc_v0", "init"])
def test_dc_forward_matches_jax(name):
    jm, tm = _models()[name]
    feats = np.random.default_rng(3).normal(
        0, 1, (5, T_CAP, tdc.N_BASE_FEATS)).astype(np.float32)
    cj, ej = jdc.dc_forward(jm.tree(), jnp.asarray(feats), jm.ctx)
    with torch.no_grad():
        ct, et = tdc.dc_forward(tm.module("cpu"), _t(feats), tm.ctx)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=0, atol=1e-5)


@pytest.mark.parametrize("allow_sub", [True, False])
def test_apply_corrections_match_jax(allow_sub):
    """Integer logits make tied margins (between kinds and between
    neighbours); the first index must win in both."""
    rng = np.random.default_rng(4)
    B, T = 12, 30
    tpl = rng.integers(0, 4, (B, T)).astype(np.int8)
    tlen = rng.integers(8, T + 1, B).astype(np.int32)
    for b in range(B):
        tpl[b, tlen[b]:] = -1
    cs = np.minimum(3, tlen).astype(np.int32)
    ce = np.maximum(tlen - 3, cs).astype(np.int32)
    cls = rng.integers(-2, 4, (B, T, tdc.N_CLASSES)).astype(np.float32)
    allow = rng.random(B) < 0.8
    ref = jax.jit(jdc.apply_corrections, static_argnums=(6, 7))(
        *map(jnp.asarray, (tpl, tlen, cs, ce, cls, allow)), 1.0, allow_sub)
    got = tdc.apply_corrections(*map(_t, (tpl, tlen, cs, ce, cls, allow)),
                                conf_thresh=1.0, allow_sub=allow_sub)
    assert bool(got[4].any()) and not bool(got[4].all())
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _windows(seed=1, W=16, C=6):
    """Windows simulated under the mismatched chemistry (so many are
    low-QV), 0-1 template errors, the last two rows padding."""
    rng = np.random.default_rng(seed)
    gen = mismatch_chemistry()
    tpl = np.full((W, T_CAP), -1, np.int8)
    tlen = np.ones(W, np.int32)
    reads = np.full((W, C, R_CAP), -1, np.int8)
    rlens = np.full((W, C), -1, np.int32)
    for b in range(W - 2):
        tl = int(rng.integers(26, 33))
        t = rng.integers(0, 4, tl).astype(np.int8)
        tpl[b, :tl] = t
        tlen[b] = tl
        if b % 3 == 0:
            p = int(rng.integers(0, tl))
            tpl[b, p] = (tpl[b, p] + 1) % 4
        for c in range(int(rng.integers(2, C + 1))):
            r = simulate_read(t, gen, 3, rng)[:R_CAP]
            reads[b, c, :len(r)] = r
            rlens[b, c] = len(r)
    cs = np.where(tlen > 1, 3, 0).astype(np.int32)
    ce = np.maximum(tlen - 3, cs).astype(np.int32)
    return tpl, tlen, cs, ce, np.full(W, 3, np.int32), reads, rlens


@pytest.fixture(scope="module")
def polished():
    """One batch polished by the port on the CPU: (numpy state dict, qv,
    snr_bin, reads, rlens)."""
    tpl, tlen, cs, ce, snr, reads, rlens = _windows()
    tables = params_to_torch(tchem.default_params(), "cpu")
    st, qv, _p = tpf.polish_windows_fused(
        *map(_t, (tpl, tlen, cs, ce, snr, reads, rlens)), tables,
        max_iters=40)
    return ({k: getattr(st, k).numpy() for k in st._fields}, qv.numpy(),
            snr, reads, rlens)


@pytest.mark.parametrize("conf", [2.0, float("inf")])
def test_refine_chunk_matches_jax(polished, conf):
    """The same polished batch through both packages' refine_chunk: with
    dc_v0 at conf 2.0 the re-score runs; with the shipped conf = inf
    nothing is edited and qv_out is qv, bit for bit."""
    st, qv, snr, reads, rlens = polished
    jm = dataclasses.replace(jdc.builtin_model(), conf=conf)
    tm = dataclasses.replace(tdc.builtin_model(), conf=conf)
    jstate = jpf.FusedPolishState(**{k: jnp.asarray(v) for k, v in st.items()})
    tstate = tpf.FusedPolishState(**{k: _t(v) for k, v in st.items()})
    ref = jax.jit(functools.partial(
        jdc.refine_chunk, jm.tree(), jm.ctx,
        hmm_jax.params_to_device(jax_default_params()),
        conf_thresh=jm.conf))(jstate, jnp.asarray(qv),
                              *map(jnp.asarray, (reads, rlens, snr)))
    got = tdc.refine_chunk(
        tm.module("cpu"), tm.ctx,
        params_to_torch(tchem.default_params(), "cpu"), tstate, _t(qv),
        *map(_t, (reads, rlens, snr)), conf_thresh=tm.conf)
    ref = [np.asarray(r) for r in ref]
    got = [g.detach().numpy() for g in got]
    for i in (0, 1, 2, 3, 6):           # templates, cores, processed
        np.testing.assert_array_equal(got[i], ref[i])
    np.testing.assert_allclose(got[4], ref[4], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[5], ref[5], rtol=0, atol=1e-3)
    proc, edited = got[6], (got[0] != st["tpl"]).any(-1)
    assert proc.any() and not proc[-2:].any()      # padding stays out
    if np.isfinite(conf):
        assert edited.any() and not (edited & ~proc).any()
        assert not np.array_equal(got[4], qv)      # re-scored
    else:
        assert not edited.any()
        np.testing.assert_array_equal(got[4], qv)


def test_pileup_extra_features_match_jax(polished):
    """Host numpy on both sides, each on its own native aligner: equal."""
    st, _qv, _snr, reads, rlens = polished
    ref = jdc.pileup_extra_features(st["tpl"], st["tlen"], reads, rlens)
    got = tdc.pileup_extra_features(_t(st["tpl"]), _t(st["tlen"]),
                                    reads, rlens)
    assert np.abs(got).max() > 0
    np.testing.assert_array_equal(got, ref)


def test_err_head_quality_and_residual_errors_match_jax(polished):
    """The held-out measures of train() on one batch: the error head's
    discrimination and mass ratio (float32 forward, 1e-5 relative) and
    the residual edit errors against a truth (identical)."""
    st, qv, _snr, _reads, rlens = polished
    rng = np.random.default_rng(10)
    labels = np.where(rng.random(st["tpl"].shape) < 0.1,
                      rng.integers(1, tdc.N_CLASSES, st["tpl"].shape), 0)
    cov = (rlens >= 0).sum(-1).astype(np.int32)
    args = (st["tpl"], st["tlen"], st["lls"], st["ll"], qv, cov)
    jm, tm = jdc.builtin_model(), tdc.builtin_model()
    jstate = jpf.FusedPolishState(**{k: jnp.asarray(v) for k, v in st.items()})
    tstate = tpf.FusedPolishState(**{k: _t(v) for k, v in st.items()})
    ref = jdc.err_head_quality(
        jm, jstate, jdc.window_features(*map(jnp.asarray, args)), labels)
    got = tdc.err_head_quality(
        tm, tstate, tdc.window_features(*map(_t, args)), labels)
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    truths = [np.roll(st["tpl"][b, :st["tlen"][b]], b % 3)
              for b in range(len(st["tlen"]))]
    assert tdc.residual_errors(st["tpl"], st["tlen"], truths) == \
        jdc.residual_errors(st["tpl"], st["tlen"], truths) > 0


def _zin(z, zmw=port_zmw):
    subs, qpos = [], 0
    for read, cx in zip(z.subreads, z.cx):
        subs.append(zmw.Subread(seq=read, cx=cx, qs=qpos,
                                qe=qpos + len(read)))
        qpos += len(read) + 40
    return zmw.ZmwInput(hole=z.hole, movie="m_test", subreads=subs,
                        snr=z.snr)


ENGINE_KW = dict(tpu_window_buckets=(64,), tpu_coverage_buckets=(16,),
                 tpu_window_coverage_cap=16)
# the tie-free holes of test_torch_engine.test_engine_matches_jax_engine;
# their lowest mean core QVs of a window are 31.4, 32.5, 33.9, 38.0 and
# 38.1, so this threshold has holes 6 and 8 processed, the others not
ENGINE_HOLES = ((6, 8), (8, 10), (7, 2), (9, 8), (11, 10), (12, 8))
DC_KW = dict(ENGINE_KW, tpu_dc_polish=True, tpu_dc_qv_thresh=33.5)


@pytest.fixture(scope="module")
def engine_runs():
    """The port's engine with and without --tpu-dc-polish and the JAX
    engine with it, on the same ZMWs; the plain run's per-window QVs and
    cores are kept to find the windows the DC stage processes."""
    sims = [simulate_zmw(hole=h, insert_len=250, n_passes=n, snr=9.0)
            for h, n in ENGINE_HOLES]
    windows = {}
    orig = engine_mod.finalize_zmw

    def spy(item, tpl, tlen, cs, ce, qv, conv, cfg, qv_rq=None):
        cov = (item.batch.rlens >= 0).sum(-1)
        windows[item.zmw.hole] = (cs, ce, qv, cov)
        return orig(item, tpl, tlen, cs, ce, qv, conv, cfg, qv_rq=qv_rq)

    engine_mod.finalize_zmw = spy
    try:
        plain = CcsEngine(CcsConfig(**ENGINE_KW), None, "cpu").process_batch(
            [_zin(z) for z in sims])
    finally:
        engine_mod.finalize_zmw = orig
    eng = CcsEngine(CcsConfig(**DC_KW), None, "cpu")
    dc = eng.process_batch([_zin(z) for z in sims])
    ref = JaxEngine(JaxConfig(**DC_KW),
                    devices=jax.devices()[:1]).process_batch(
        [_zin(z, jax_zmw) for z in sims])
    return plain, dc, ref, windows, eng.dc_stats


def test_dc_engine_matches_jax_engine(engine_runs):
    _plain, got, ref, _w, _s = engine_runs
    assert sum(r.status == ZmwStatus.SUCCESS for r in got) == 5
    for r, g in zip(ref, got):
        assert r.status.name == g.status.name, (r.hole, r.status, g.status)
        if r.seq is None:
            assert g.seq is None
            continue
        np.testing.assert_array_equal(g.seq, r.seq)
        np.testing.assert_allclose(g.qv, r.qv, atol=1e-3)
        assert abs(g.rq - r.rq) < 1e-3


def test_dc_engine_changes_only_rq_of_processed_zmws(engine_runs):
    """With the shipped model (conf = inf) the stage never edits: the
    sequences and per-base QVs are the plain run's, and rq differs exactly
    on the ZMWs that hold a processed window (mean core QV under the
    threshold, with reads)."""
    plain, dc, _ref, windows, stats = engine_runs
    thresh = DC_KW["tpu_dc_qv_thresh"]
    n_proc_zmws = 0
    for p, d in zip(plain, dc):
        assert p.status == d.status
        if p.seq is None:
            continue
        np.testing.assert_array_equal(d.seq, p.seq)
        np.testing.assert_array_equal(d.qv, p.qv)
        cs, ce, qv, cov = windows[p.hole]
        j = np.arange(qv.shape[1])[None, :]
        core = (j >= cs[:, None]) & (j < ce[:, None])
        win_qv = np.where(core, qv, 0).sum(-1) / np.maximum(core.sum(-1), 1)
        processed = ((win_qv < thresh) & (cov > 0)).any()
        n_proc_zmws += processed
        assert (d.rq != p.rq) == processed, (p.hole, p.rq, d.rq)
    assert n_proc_zmws == 2
    assert stats[3] == n_proc_zmws and stats[2] == 0
    assert 0 < stats[1] < stats[0]


class _LogArgs(logging.Handler):
    """Keeps the arguments of the last "DC refinement" log record."""

    def __init__(self):
        super().__init__(level=logging.INFO)
        self.args = None

    def emit(self, record):
        if record.msg.startswith("DC refinement"):
            self.args = record.args


def test_dc_log_counts_zmws_under_by_strand(tmp_path):
    """Under --by-strand a ZMW is two work items; the "in N ZMWs" of the DC
    log counts distinct holes: those whose records' rq moved against the
    plain by-strand run."""
    path = str(tmp_path / "in.subreads.bam")
    write_subreads_bam(path, [simulate_zmw(hole=h, insert_len=250,
                                           n_passes=n, snr=9.0)
                              for h, n in ENGINE_HOLES])
    base = [path, "-j", "1", "--by-strand", "--min-rq", "0", "--log-level",
            "INFO"]
    plain, dc = str(tmp_path / "plain.bam"), str(tmp_path / "dc.bam")
    assert cli.run(base[:1] + [plain] + base[1:], device="cpu") == 0
    cap = _LogArgs()
    logging.getLogger("ccs_tpu").addHandler(cap)
    try:
        assert cli.run(base[:1] + [dc] + base[1:] + [
            "--tpu-dc-polish", "--tpu-dc-qv-thresh",
            str(DC_KW["tpu_dc_qv_thresh"])], device="cpu") == 0
    finally:
        logging.getLogger("ccs_tpu").removeHandler(cap)

    def records(p):
        with BamReader(p) as r:
            return {rec.name: (rec.seq.tobytes(), rec.tag("rq"),
                               rec.tag("zm")) for rec in r}
    a, b = records(plain), records(dc)
    assert a.keys() == b.keys() and all(n.endswith(("/fwd", "/rev"))
                                        for n in a)
    moved = {a[n][2] for n in a if a[n][1] != b[n][1]}
    both = [h for h in moved if sum(a[n][2] == h and a[n][1] != b[n][1]
                                    for n in a) == 2]
    assert all(a[n][0] == b[n][0] for n in a)
    assert both, "no hole with both strands processed: the test needs one"
    assert int(cap.args[3]) == len(moved)


def _bundle(tmp_path, conf):
    d = tmp_path / "bundle"
    d.mkdir()
    dataclasses.replace(tdc.builtin_model(), conf=conf).save(
        str(d / "dc_model.npz"))
    return str(d)


def test_dc_model_resolution(tmp_path, monkeypatch):
    """A dc_model.npz in $SMRT_CHEMISTRY_BUNDLE_DIR wins over the built-in
    model; the Arrow parameters still resolve to the built-in chemistry
    when the bundle holds only that file; no model at all raises."""
    chem = {"BINDINGKIT": "101-894-200"}
    monkeypatch.delenv("SMRT_CHEMISTRY_BUNDLE_DIR", raising=False)
    eng = CcsEngine(CcsConfig(tpu_dc_polish=True), None, "cpu")
    assert eng._dc_refine.keywords["conf_thresh"] == float("inf")
    monkeypatch.setenv("SMRT_CHEMISTRY_BUNDLE_DIR", _bundle(tmp_path, 2.0))
    eng = CcsEngine(CcsConfig(tpu_dc_polish=True), None, "cpu")
    assert eng._dc_refine.keywords["conf_thresh"] == 2.0
    assert tchem.load_model(chem) is tchem._builtin("101-894-200")
    monkeypatch.delenv("SMRT_CHEMISTRY_BUNDLE_DIR")
    monkeypatch.setattr(tdc, "builtin_model", lambda: None)
    with pytest.raises(RuntimeError, match="no model is available"):
        CcsEngine(CcsConfig(tpu_dc_polish=True), None, "cpu")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_dc_model_npz_cross_loads(tmp_path, writer):
    rng = np.random.default_rng(5)
    src, dst = (jdc, tdc) if writer == "jax" else (tdc, jdc)
    m = dataclasses.replace(src.init_model(rng, hidden=8, ctx=1), conf=1.5,
                            sub_ok=0)
    path = str(tmp_path / "m.npz")
    m.save(path)
    back = dst.DcModel.load(path)
    for f in dataclasses.fields(m):
        a, b = getattr(m, f.name), getattr(back, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert type(a) is type(b) and a == b
    # the weights cross to torch and back unchanged
    port = tdc.DcModel.load(path)
    again = port.with_weights(port.module("cpu"))
    for k in tdc.WEIGHTS:
        np.testing.assert_array_equal(getattr(again, k), getattr(m, k))


def _jax_loss(tr, feats, labels, weights, ctx):
    """The loss of ccs_tpu.models.dc_polisher.train (nested there), as
    written there."""
    logits, err = jdc.dc_forward(tr, feats, ctx)
    ce = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
    is_err = (labels > 0).astype(jnp.float32)
    bce = optax.sigmoid_binary_cross_entropy(err, is_err)
    w = weights * (1.0 + jdc.ERR_UPWEIGHT * is_err)
    return ((ce + bce) * w).sum() / jnp.maximum(w.sum(), 1.0)


def _train_inputs():
    """16 windows of features, labels (~8% errors) and in-template
    weights; the 'init' model at hidden 8, ctx 1."""
    rng = np.random.default_rng(6)
    feats = rng.normal(0, 1, (16, T_CAP, tdc.N_BASE_FEATS)).astype(
        np.float32)
    labels = np.where(rng.random((16, T_CAP)) < 0.08,
                      rng.integers(1, tdc.N_CLASSES, (16, T_CAP)), 0)
    tlen = rng.integers(26, 33, 16)
    weights = (np.arange(T_CAP)[None, :] < tlen[:, None]).astype(np.float32)
    jm, tm = _models()["init"]
    return feats, labels.astype(np.int64), weights, jm, tm


def test_train_step_loss_and_grads_match_jax():
    feats, labels, weights, jm, tm = _train_inputs()
    loss_j, g_j = jax.jit(jax.value_and_grad(_jax_loss), static_argnums=4)(
        jm.tree(), jnp.asarray(feats), jnp.asarray(labels),
        jnp.asarray(weights), jm.ctx)
    net = tm.module("cpu")
    loss_t = tdc.dc_loss(net, _t(feats), _t(labels), _t(weights), tm.ctx)
    loss_t.backward()
    assert float(loss_t.detach()) == pytest.approx(float(loss_j), rel=1e-5)
    for k in tdc.WEIGHTS:
        gj, gt = np.asarray(g_j[k]), getattr(net, k).grad.numpy()
        assert np.abs(gj).max() > 0, k
        assert np.abs(gt - gj).max() <= 1e-5 * np.abs(gj).max(), k


def test_adam_steps_match_optax():
    feats, labels, weights, jm, tm = _train_inputs()
    lr = 3e-3
    opt = optax.adam(lr)
    tree = jm.tree()
    state = opt.init(tree)
    args = tuple(map(jnp.asarray, (feats, labels, weights)))

    @jax.jit
    def jax_step(tree, state):
        g = jax.grad(_jax_loss)(tree, *args, jm.ctx)
        upd, state = opt.update(g, state)
        return optax.apply_updates(tree, upd), state

    for _ in range(5):
        tree, state = jax_step(tree, state)
    net = tm.module("cpu")
    step = tdc.make_train_step(net, tm.ctx, lr)
    for _ in range(5):
        step(_t(feats), _t(labels), _t(weights))
    out = tm.with_weights(net)
    for k in tdc.WEIGHTS:
        np.testing.assert_allclose(getattr(out, k), np.asarray(tree[k]),
                                   rtol=0, atol=1e-5, err_msg=k)
        assert not np.array_equal(getattr(out, k), getattr(tm, k)), k


def test_make_training_batch_matches_jax(monkeypatch):
    """The same seed draws the same windows and reads in both packages;
    where the two polishes end on the same template, labels agree and
    features within 5e-5: the two scorers sum in other orders and the
    port equalizes the scores of equivalent mutations, so the deltas
    differ by up to ~1e-5 (1e-4 in log-likelihood) and the QV feature by
    as much (4e-4 QV) on these windows."""
    seen = {}

    def spy(pkg, fn):
        def wrapped(tpl, tlen, cs, ce, snr, reads, rlens, tables, **kw):
            seen[pkg] = [np.asarray(a) for a in (tpl, tlen, reads, rlens)]
            return fn(tpl, tlen, cs, ce, snr, reads, rlens, tables, **kw)
        return wrapped

    monkeypatch.setattr(jpf, "polish_windows_fused",
                        spy("jax", jpf.polish_windows_fused))
    monkeypatch.setattr(tdc, "polish_windows_fused",
                        spy("port", tdc.polish_windows_fused))
    gen = mismatch_chemistry()
    ref = jdc.make_training_batch(10, gen, jax_default_params(),
                                  np.random.default_rng(7))
    got = tdc.make_training_batch(10, gen, tchem.default_params(),
                                  np.random.default_rng(7), device="cpu")
    for a, b in zip(seen["jax"], seen["port"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[2], ref[2])             # coverage
    for a, b in zip(got[6], ref[6]):                          # truths
        np.testing.assert_array_equal(a, b)
    same = ((got[0].tpl.numpy() == np.asarray(ref[0].tpl)).all(-1)
            & (got[0].tlen.numpy() == np.asarray(ref[0].tlen)))
    assert same.sum() >= 8
    np.testing.assert_allclose(got[3].numpy()[same],
                               np.asarray(ref[3])[same], rtol=0, atol=5e-5)
    np.testing.assert_array_equal(got[4][same], ref[4][same])  # labels
    np.testing.assert_array_equal(got[5][same], ref[5][same])  # weights


def test_train_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdc.train(mismatch_chemistry(), tchem.default_params(), steps=1)


def _fit_pairs(pkg_sim, params):
    rng = np.random.default_rng(8)
    pairs = []
    for i in range(24):
        t = rng.integers(0, 4, 120).astype(np.int8)
        r = pkg_sim.simulate_read(t, params, i % 8, rng)
        pairs.append((t, r, i % 8, rng.integers(1, 4, len(r))))
    return pairs


def _fit_zmws(pkg_sim, zmw):
    rng = np.random.default_rng(9)
    out = []
    for h in range(4):
        z = pkg_sim.simulate_zmw(hole=h, insert_len=300, n_passes=5, rng=rng,
                                 snr=6.0 + h, with_pw=True)
        subs, qpos = [], 0
        for read, cx, pw in zip(z.subreads, z.cx, z.pws):
            subs.append(zmw.Subread(seq=read, cx=cx, qs=qpos,
                                    qe=qpos + len(read), pw=pw))
            qpos += len(read) + 40
        out.append(zmw.ZmwInput(hole=h, movie="m_fit", subreads=subs,
                                snr=z.snr))
    return out


@pytest.mark.parametrize("how", ["pairs", "zmws"])
def test_fit_matches_original(how):
    from ccs_tpu.sim import simulator as jsim
    from ccs_tpu_torch.sim import simulator as tsim
    if how == "pairs":
        ref = jfit.fit_from_pairs(_fit_pairs(jsim, jax_default_params()))
        got = tfit.fit_from_pairs(_fit_pairs(tsim, tchem.default_params()))
    else:
        ref = jfit.fit_from_zmws(_fit_zmws(jsim, jax_zmw))
        got = tfit.fit_from_zmws(_fit_zmws(tsim, port_zmw))
    assert got.to_json() == ref.to_json()
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(got, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_profile_dir_writes_trace(tmp_path):
    zmws = [simulate_zmw(hole=0, insert_len=120, n_passes=6, snr=8.5)]
    path = str(tmp_path / "in.subreads.bam")
    write_subreads_bam(path, zmws)
    trace_dir = tmp_path / "trace"
    assert cli.run([path, str(tmp_path / "o.bam"), "-j", "1",
                    "--tpu-profile-dir", str(trace_dir)], device="cpu") == 0
    traces = glob.glob(os.path.join(str(trace_dir), "*.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as fh:
        trace = json.load(fh)
    # the program's spans, on host-thread tracks (on the CPU the trace
    # holds no device events and no host ops)
    spans = {e["name"] for e in trace["traceEvents"]
             if e.get("cat") == "span"}
    assert {"device_step", "prepare_wait", "pipeline", "read",
            "write"} <= spans
