"""The port's polish loop (ccs_tpu_torch.pipeline.polish_fused) against the
JAX package's: the loop's building blocks on the same inputs, the dense and
candidate-sparse loops end to end, and the port's compaction against its
own uncompacted loop.

Bars: integer outputs exact, QVs within 1e-4 for _qv_from_lls on shared
scores; the loops may differ by at most one tie-order template per batch
(the JAX package's own bar for two scorers, test_polish_fused.py), with
QVs within 1e-3 where templates agree; compaction must be bit-identical."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ccs_tpu.models.chemistry import default_params
from ccs_tpu.ops.hmm_jax import params_to_device
from ccs_tpu.pipeline import polish_fused as pj
from ccs_tpu_torch.models.chemistry import default_params as port_params
from ccs_tpu_torch.ops.tables import params_to_torch
from ccs_tpu_torch.parallel.step import make_polish_step
from ccs_tpu_torch.pipeline import polish_fused as pt
from test_torch_scorer import simulate_batch

# The suite runs several pytest workers on a few cores; torch's intra-op
# threads on these small tensors only contend with them.
torch.set_num_threads(1)

PARAMS = default_params()
TJ = params_to_device(PARAMS)
TT = params_to_torch(port_params(), "cpu")


def _rand_lls(rng, B, T):
    lls = rng.normal(0.0, 3.0, (B, 9 * T + 4)).astype(np.float32)
    lls[rng.random(lls.shape) < 0.3] = pj.NEG
    # exact ties within and across positions exercise first-max rules
    lls[:, 9:18] = lls[:, 0:9]
    lls[:, 5] = lls[:, 7]
    return lls


def test_select_mutations_equal():
    rng = np.random.default_rng(0)
    B, T = 16, 24
    lls = _rand_lls(rng, B, T)
    ll = rng.normal(0.0, 1.0, B).astype(np.float32)
    pri = (rng.random((B, T)) < 0.6).astype(np.float32)
    for prio in (None, pri):
        ref = pj.select_mutations(jnp.asarray(lls), jnp.asarray(ll),
                                  None if prio is None else jnp.asarray(prio),
                                  T, thresh=0.02)
        got = pt.select_mutations(torch.from_numpy(lls), torch.from_numpy(ll),
                                  None if prio is None else
                                  torch.from_numpy(prio), T, thresh=0.02)
        for r, g in zip(ref[:4], got[:4]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        np.testing.assert_allclose(got[4].numpy(), np.asarray(ref[4]),
                                   atol=1e-5)


@pytest.mark.parametrize("single", [False, True])
def test_apply_mutations_equal(single):
    rng = np.random.default_rng(1)
    B, T = 24, 26
    tpl = rng.integers(0, 4, (B, T)).astype(np.int8)
    tlen = rng.integers(3, T + 1, B).astype(np.int32)
    for b in range(B):
        tpl[b, tlen[b]:] = -1
    cs = rng.integers(0, 4, B).astype(np.int32)
    ce = np.maximum(cs, tlen - rng.integers(0, 4, B)).astype(np.int32)
    pri = (rng.random((B, T)) < 0.5).astype(np.float32)
    is_first = rng.random(B) < 0.3
    lls = _rand_lls(rng, B, T)
    ll = np.zeros(B, np.float32)
    sel, pkind, pre_sel, pre_base, _ = pj.select_mutations(
        jnp.asarray(lls), jnp.asarray(ll), None, T, thresh=0.02)
    sel = np.asarray(sel) & (np.arange(T)[None] < tlen[:, None])
    pkind, pre_sel, pre_base = (np.array(x) for x in
                                (pkind, pre_sel, pre_base))
    pre_sel = pre_sel & (tlen < T)
    single_a = np.full(B, single)
    ref = pj.apply_mutations(*(jnp.asarray(a) for a in (
        tpl, tlen, cs, ce, pri, sel, pkind, pre_sel, pre_base, is_first,
        single_a)))
    got = pt.apply_mutations(*(torch.from_numpy(a) for a in (
        tpl, tlen, cs, ce, pri, sel, pkind, pre_sel, pre_base, is_first,
        single_a)))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_qv_and_clean_perr_equal():
    rng = np.random.default_rng(2)
    B, T = 12, 20
    tpl = rng.integers(0, 3, (B, T)).astype(np.int8)    # runs of bases
    tlen = rng.integers(4, T + 1, B).astype(np.int32)
    for b in range(B):
        tpl[b, tlen[b]:] = -1
    ll = rng.normal(-50, 5, B).astype(np.float32)
    lls = (ll[:, None] + rng.normal(-8, 4, (B, 9 * T + 4))).astype(np.float32)
    qv_r, pe_r = pj._qv_from_lls(jnp.asarray(lls), jnp.asarray(ll),
                                 jnp.asarray(tpl), jnp.asarray(tlen))
    qv_g, pe_g = pt._qv_from_lls(torch.from_numpy(lls), torch.from_numpy(ll),
                                 torch.from_numpy(tpl),
                                 torch.from_numpy(tlen))
    np.testing.assert_allclose(qv_g.numpy(), np.asarray(qv_r), atol=1e-4)
    np.testing.assert_allclose(pe_g.numpy(), np.asarray(pe_r), rtol=1e-5,
                               atol=1e-12)
    cov = rng.integers(0, 50, B).astype(np.int32)
    snr = rng.integers(-1, 9, B).astype(np.int32)
    np.testing.assert_array_equal(
        pt.clean_perr(TT, torch.from_numpy(cov), torch.from_numpy(snr)),
        np.asarray(pj.clean_perr(TJ, jnp.asarray(cov), jnp.asarray(snr))))


def test_valid_mask_and_cand_expansion_equal():
    rng = np.random.default_rng(3)
    B, T = 10, 16
    tpl = rng.integers(0, 4, (B, T)).astype(np.int8)
    tlen = rng.integers(1, T + 1, B).astype(np.int32)
    tlen[0] = T
    cand = rng.random((B, T)) < 0.5
    np.testing.assert_array_equal(
        pt.mutation_valid_new(torch.from_numpy(tpl), torch.from_numpy(tlen)),
        np.asarray(pj.mutation_valid_new(jnp.asarray(tpl),
                                         jnp.asarray(tlen))))
    np.testing.assert_array_equal(
        pt.expand_cand(torch.from_numpy(cand)),
        np.asarray(pj.expand_cand(jnp.asarray(cand))))


def test_equivalent_mutations_get_equal_scores():
    """Deletions within a run and insertions of x along a run of x form
    classes; every valid member takes the class maximum."""
    T = 8
    tpl = torch.tensor([[1, 1, 1, 2, 0, 0, 3, -1]], dtype=torch.int8)
    lls = torch.arange(9 * T + 4, dtype=torch.float32)[None] * 0.01
    lls[0, 9 * 7:9 * 8] = pt.NEG                 # position 7 is padding
    out = pt.equalize_equivalent(lls, tpl)[0].reshape(-1)
    reg, pre = out[:9 * T].reshape(T, 9), out[9 * T:]
    src = lls[0, :9 * T].reshape(T, 9)
    assert torch.all(reg[0:3, 4] == src[2, 4])   # del in run 1,1,1
    assert torch.all(reg[4:6, 4] == src[5, 4])   # del in run 0,0
    assert reg[3, 4] == src[3, 4] and reg[6, 4] == src[6, 4]
    ins1 = 5 + 1                                 # insert base 1
    m = max(float(lls[0, 9 * T + 1]), float(src[:3, ins1].max()))
    assert pre[1] == reg[0, ins1] == reg[1, ins1] == reg[2, ins1] == m
    assert reg[3, ins1] == src[3, ins1]
    ins0 = 5 + 0                                 # insert base 0
    assert reg[3, ins0] == reg[4, ins0] == reg[5, ins0] == src[5, ins0]
    assert torch.equal(reg[:, :4], src[:, :4])   # substitutions untouched
    assert torch.all(reg[7] == pt.NEG)


def _jax_loop(arrs, cs, ce, **kw):
    tpl, tlen, snr, reads, rlens = arrs
    return pj.polish_windows_fused(
        *(jnp.asarray(a) for a in (tpl, tlen, cs, ce, snr, reads, rlens)),
        TJ, **kw)


def _torch_loop(arrs, cs, ce, **kw):
    tpl, tlen, snr, reads, rlens = arrs
    return pt.polish_windows_fused(
        *(torch.from_numpy(a) for a in (tpl, tlen, cs, ce, snr, reads,
                                        rlens)), TT, **kw)


@pytest.mark.parametrize("sparse", [False, True])
def test_loop_matches_jax(sparse):
    rng = np.random.default_rng(3)
    arrs, _ = simulate_batch(rng, PARAMS, 10, 8, 28, 36, tl_range=(16, 23))
    B, T = arrs[0].shape
    cs = np.full(B, 2, np.int32)
    ce = (arrs[1] - 2).astype(np.int32)
    kw = {"max_iters": 20}
    if sparse:
        pri = (rng.random((B, T)) < 0.6).astype(np.float32)
        st_j, qv_j, _ = _jax_loop(arrs, cs, ce, priority=jnp.asarray(pri),
                                  sparse=True, **kw)
        st_t, qv_t, _ = _torch_loop(arrs, cs, ce,
                                    priority=torch.from_numpy(pri),
                                    sparse=True, **kw)
    else:
        st_j, qv_j, _ = _jax_loop(arrs, cs, ce, **kw)
        st_t, qv_t, _ = _torch_loop(arrs, cs, ce, **kw)
    assert not bool(st_t.active.any())
    same = 0
    for b in range(B):
        a = np.asarray(st_j.tpl[b][:int(st_j.tlen[b])])
        c = st_t.tpl[b][:int(st_t.tlen[b])].numpy()
        if len(a) == len(c) and np.all(a == c):
            same += 1
            np.testing.assert_allclose(qv_t[b].numpy(), np.asarray(qv_j[b]),
                                       atol=1e-3)
    assert same >= B - 1   # at most one tie-order difference per batch


@pytest.mark.parametrize("sparse", [False, True])
def test_compaction_is_bit_identical(sparse):
    rng = np.random.default_rng(11)
    arrs, _ = simulate_batch(rng, PARAMS, 12, 6, 28, 36, tl_range=(14, 23))
    arrs[4][3] = -1            # dead row: no coverage
    B, T = arrs[0].shape
    cs = np.full(B, 2, np.int32)
    ce = (arrs[1] - 2).astype(np.int32)
    pri = torch.from_numpy((rng.random((B, T)) < 0.7).astype(np.float32))
    kw = {"max_iters": 12, "priority": pri, "sparse": sparse}
    st_w, qv_w, pe_w = _torch_loop(arrs, cs, ce, **kw)
    st_c, qv_c, pe_c = _torch_loop(arrs, cs, ce, compact=True, **kw)
    for a, b in zip(st_w, st_c):
        assert torch.equal(a, b)
    assert torch.equal(qv_w, qv_c) and torch.equal(pe_w, pe_c)


def test_step_stats():
    rng = np.random.default_rng(5)
    arrs, _ = simulate_batch(rng, PARAMS, 8, 5, 28, 36, tl_range=(14, 23))
    tpl, tlen, snr, reads, rlens = arrs
    rlens[2] = -1
    B, T = tpl.shape
    cs = np.full(B, 2, np.int32)
    ce = (tlen - 2).astype(np.int32)
    is_first = np.zeros(B, bool)
    pri = np.ones((B, T), np.float32)
    step = make_polish_step(TT, "cpu", max_iters=20, compact=True)
    state, qv, stats = step(tpl, tlen, cs, ce, snr, reads, rlens, is_first,
                            pri)
    live = (rlens >= 0).any(-1)
    assert stats.dtype == torch.int64
    assert stats.tolist() == [
        int((~state.active.numpy() & live).sum()),
        int(state.n_iter.sum()),
        int(np.where(live, np.maximum(
            state.core_end.numpy() - state.core_start.numpy(), 0), 0).sum())]
    assert qv.shape == (B, T)
