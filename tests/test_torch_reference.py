"""The port's reference layer against the JAX package on the same seeded
inputs: the brute-force forward (ops.hmm_forward, counterpart of
hmm_jax.forward_batch), round-1 mutation scoring by column bridging
(hmm_cols.mutation_ops / score_mutants_cols) and the round-1 polish loop
(pipeline.polish); then the fused loop's scorers and the fused loop itself
held against brute-force forwards, as tests/test_polish_fused.py holds the
JAX ones. The numpy oracle's copy is held bit-equal to its original in
tests/test_torch_host.py.

Bars (the JAX package's own): forward against the oracle rel 1e-4, abs
1e-3 (test_hmm.py); against the column form 2e-5 (test_hmm_cols.py); bridged
against brute-force mutant scores rtol/atol 2e-4; the fused scorers against
brute force ll0 2e-3 and valid LLs 5e-3; the fused loop's templates equal
to the dense loop's except at most one per batch (test_polish_fused.py).
Against the JAX functions on the same arrays: the forward within rtol 1e-5,
atol 1e-4 (the JAX scan truncates deletion runs at depth 8, this forward
does not: measured 1.9e-6); mutant enumeration, application and validity
bit-equal; polish templates and iteration counts equal, QVs within 1e-3."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ccs_tpu.models.chemistry import default_params as jax_default_params
from ccs_tpu.ops import hmm_jax
from ccs_tpu.ops import hmm_cols as jax_cols
from ccs_tpu.pipeline import polish as jax_polish
from ccs_tpu_torch.models.chemistry import default_params, pack_read_pw
from ccs_tpu_torch.ops import hmm_cols, hmm_forward, hmm_oracle, hmm_score
from ccs_tpu_torch.ops.tables import params_to_torch
from ccs_tpu_torch.pipeline import polish
from ccs_tpu_torch.pipeline.polish_fused import (mutation_valid_new,
                                                 polish_windows_fused)
from ccs_tpu_torch.sim.simulator import simulate_read

torch.set_num_threads(1)

PARAMS = default_params()
TABLES = params_to_torch(PARAMS, "cpu")
JTABLES = hmm_jax.params_to_device(jax_default_params())


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _batch(rng, B, C, t_cap, r_cap, tl_range=(5, 25), n_err=(0, 1),
           snr=None, dead_last=False, pw=False):
    """Simulated windows: templates with 0..n_err-1 substituted bases, C
    reads of the true template each (the last lane absent if dead_last),
    read codes packed with random pulse-width bins if pw. Returns the
    numpy arrays (tpl, tlen, snr_bin, reads, rlens) and the truths."""
    tpl = np.full((B, t_cap), -1, np.int8)
    tlen = np.zeros(B, np.int32)
    reads = np.full((B, C, r_cap), -1, np.int8)
    rlens = np.full((B, C), -1, np.int32)
    snr_bin = (rng.integers(0, 8, B) if snr is None
               else np.full(B, snr)).astype(np.int32)
    truths = []
    for b in range(B):
        tl = int(rng.integers(*tl_range))
        t = rng.integers(0, 4, tl).astype(np.int8)
        truths.append(t)
        corrupt = t.copy()
        for _ in range(int(rng.integers(*n_err))):
            p = int(rng.integers(0, tl))
            corrupt[p] = (corrupt[p] + 1) % 4
        tpl[b, :tl] = corrupt
        tlen[b] = tl
        for c in range(C - 1 if dead_last else C):
            r = simulate_read(t, PARAMS, int(snr_bin[b]), rng)[:r_cap]
            if pw:
                r = pack_read_pw(r, rng.integers(0, 4, len(r)))
            reads[b, c, :len(r)] = r
            rlens[b, c] = len(r)
    return (tpl, tlen, snr_bin, reads, rlens), truths


# --- the forward ----------------------------------------------------------

def test_forward_matches_oracle_and_jax():
    """Twin of test_hmm.py::test_matches_oracle, with pulse-width codes:
    every live lane against the port's numpy oracle; absent lanes exactly
    0; the same arrays through JAX forward_batch."""
    rng = np.random.default_rng(4)
    arrs, _ = _batch(rng, 5, 4, 24, 40, tl_range=(5, 25), dead_last=True,
                     pw=True)
    tpl, tlen, snr_bin, reads, rlens = arrs
    ll = hmm_forward.forward_batch(*_t(*arrs), TABLES).numpy()
    for b in range(5):
        for c in range(3):
            want = hmm_oracle.forward_ll(tpl[b, :tlen[b]],
                                         reads[b, c, :rlens[b, c]], PARAMS,
                                         int(snr_bin[b]))
            assert ll[b, c] == pytest.approx(want, rel=1e-4, abs=1e-3), (b, c)
    np.testing.assert_array_equal(ll[:, -1], 0.0)
    ref = np.asarray(hmm_jax.forward_batch(*_j(*arrs), JTABLES))
    np.testing.assert_allclose(ll, ref, rtol=1e-5, atol=1e-4)


def test_forward_matches_columns():
    """Twin of test_hmm_cols.py::test_total_ll_matches_forward."""
    rng = np.random.default_rng(11)
    arrs, _ = _batch(rng, 4, 5, 24, 36, tl_range=(8, 19))
    got = hmm_forward.forward_batch(*_t(*arrs), TABLES)
    cols = hmm_cols.build_columns(*_t(*arrs), TABLES)
    np.testing.assert_allclose(got.numpy(), cols.ll.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_forward_empty_read_and_padding_invariance():
    """An empty read is the deletion chain alone; a lane scores the same
    in a batch of one and inside larger caps (test_hmm.py twins)."""
    tpl = np.array([[0, 1, 2, -1]], np.int8)
    ll = hmm_forward.forward_batch(*_t(tpl, np.array([3], np.int32),
                                       np.array([0], np.int32),
                                       np.full((1, 1, 4), -1, np.int8),
                                       np.array([[0]], np.int32)), TABLES)
    want = hmm_oracle.forward_ll(np.array([0, 1, 2], np.int8),
                                 np.array([], np.int8), PARAMS, 0)
    assert float(ll[0, 0]) == pytest.approx(want, rel=1e-5)
    rng = np.random.default_rng(5)
    t = rng.integers(0, 4, 16).astype(np.int8)
    r = simulate_read(t, PARAMS, 2, rng)[:40]

    def run(T, R, C):
        tp = np.full((1, T), -1, np.int8)
        tp[0, :16] = t
        rd = np.full((1, C, R), -1, np.int8)
        rd[0, 0, :len(r)] = r
        rl = np.full((1, C), -1, np.int32)
        rl[0, 0] = len(r)
        return float(hmm_forward.forward_batch(
            *_t(tp, np.array([16], np.int32), np.array([2], np.int32), rd,
                rl), TABLES)[0, 0])

    assert run(16, len(r), 1) == pytest.approx(run(32, len(r) + 13, 7),
                                               rel=1e-5)


def test_snr_bin_for_matches_jax():
    snr = np.array([0.5, 3.0, 4.99, 5.0, 6.2, 8.0, 9.5, 12.0, 40.0],
                   np.float32)
    got = hmm_forward.snr_bin_for(torch.from_numpy(snr), TABLES).numpy()
    want = np.asarray(hmm_jax.snr_bin_for(jnp.asarray(snr), JTABLES))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


# --- the round-1 enumeration ---------------------------------------------

def test_mutants_apply_and_validity_match_jax():
    """make_mutants, mutation_valid and apply_mutation (every mutation id,
    core offsets and the first-window prepend rule) bit-equal to JAX."""
    rng = np.random.default_rng(0)
    T = 12
    tpl = rng.integers(0, 4, (4, T)).astype(np.int8)
    tlen = np.array([12, 9, 1, 5], np.int32)
    for b, tl in enumerate(tlen):
        tpl[b, tl:] = -1
    cs = np.array([0, 2, 0, 1], np.int32)
    ce = np.array([12, 7, 1, 4], np.int32)
    first = np.array([True, False, True, False])
    got = polish.make_mutants(*_t(tpl, tlen))
    want = jax_polish.make_mutants(*_j(tpl, tlen))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        polish.mutation_valid(torch.from_numpy(tlen), T).numpy(),
        np.asarray(jax_polish.mutation_valid(jnp.asarray(tlen), T)))
    for mut_id in range(8 * T + 4):
        ids = np.full(4, mut_id, np.int32)
        got = polish.apply_mutation(*_t(tpl, tlen, cs, ce, ids, first))
        want = jax_polish.apply_mutation(*_j(tpl, tlen, cs, ce, ids, first))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=str(mut_id))
    # the same edge cases as test_polish.py::TestMutants
    mt, ml, valid = polish.make_mutants(*_t(np.array([[0, 1, 2, 3, -1, -1]],
                                                     np.int8),
                                            np.array([4], np.int32)))
    assert mt.shape == (1, 8 * 6 + 4, 6)
    assert mt[0, 8 * 6 + 2, :5].tolist() == [2, 0, 1, 2, 3]
    assert not bool(valid[0, 4 * 8]) and bool(valid[0, 8 * 6 + 2])


def test_bridged_scores_match_brute_force():
    """Twin of test_hmm_cols.py::test_bridged_scores_match_dense: every
    round-1 mutant by column bridging against a full forward of its
    template; both against JAX score_mutants_cols on the same arrays."""
    rng = np.random.default_rng(3)
    arrs, _ = _batch(rng, 5, 5, 24, 36, tl_range=(8, 19), snr=4)
    tpl, tlen, snr_bin, reads, rlens = _t(*arrs)
    T = tpl.shape[1]
    cols = hmm_cols.build_columns(tpl, tlen, snr_bin, reads, rlens, TABLES)
    valid = polish.mutation_valid(tlen, T)
    got = hmm_cols.score_mutants_cols(tpl, tlen, snr_bin, reads, rlens,
                                      TABLES, cols, valid, m_chunk=16)
    mt, ml, valid_d = polish.make_mutants(tpl, tlen)
    want = polish.score_mutants(mt, ml, valid_d, snr_bin, reads, rlens,
                                TABLES, m_chunk=16)
    v = valid_d.numpy()
    np.testing.assert_array_equal(valid.numpy(), v)
    np.testing.assert_allclose(got.numpy()[v], want.numpy()[v], rtol=2e-4,
                               atol=2e-4)
    assert (got.numpy()[~v] == polish.NEG).all()
    ja = _j(*arrs)
    jref = np.asarray(jax_cols.score_mutants_cols(
        *ja, JTABLES, jax_cols.build_columns(*ja, JTABLES),
        jax_polish.mutation_valid(ja[1], T), m_chunk=16))
    np.testing.assert_allclose(got.numpy()[v], jref[v], rtol=2e-4, atol=2e-4)


# --- the round-1 loop -----------------------------------------------------

def _window_args(rng, B=4, T_CAP=28, R_CAP=44, C=8):
    """test_hmm_cols.py::test_polish_trajectories_identical's windows."""
    tpl = np.full((B, T_CAP), -1, np.int8)
    tlen = np.zeros(B, np.int32)
    reads = np.full((B, C, R_CAP), -1, np.int8)
    rlens = np.full((B, C), -1, np.int32)
    for b in range(B):
        truth = rng.integers(0, 4, 20).astype(np.int8)
        corrupt = truth.copy()
        p = int(rng.integers(0, 20))
        corrupt[p] = (corrupt[p] + 1) % 4
        tpl[b, :20] = corrupt
        tlen[b] = 20
        for c in range(C):
            r = simulate_read(truth, PARAMS, 4, rng)[:R_CAP]
            reads[b, c, :len(r)] = r
            rlens[b, c] = len(r)
    return (tpl, tlen, np.zeros(B, np.int32), tlen.copy(),
            np.full(B, 4, np.int32), reads, rlens)


@pytest.mark.parametrize("scoring", ["cols", "dense"])
def test_polish_windows_matches_jax(scoring):
    """The round-1 loop, bridged and brute force, against JAX
    polish_windows on the same windows: templates, lengths, cores and
    iteration counts equal, QVs within 1e-3; the two scorings take the
    same trajectory (test_hmm_cols.py's twin)."""
    args = _window_args(np.random.default_rng(21))
    st, qv, _ = polish.polish_windows(*_t(*args), TABLES, max_iters=8,
                                      scoring=scoring)
    js, jqv, _ = jax_polish.polish_windows(*_j(*args), JTABLES, max_iters=8,
                                           scoring=scoring)
    for k in ("tpl", "tlen", "core_start", "core_end", "n_iter", "active"):
        np.testing.assert_array_equal(getattr(st, k).numpy(),
                                      np.asarray(getattr(js, k)), err_msg=k)
    np.testing.assert_allclose(qv.numpy(), np.asarray(jqv), atol=1e-3)
    other, qv_o, _ = polish.polish_windows(
        *_t(*args), TABLES, max_iters=8,
        scoring="dense" if scoring == "cols" else "cols")
    np.testing.assert_array_equal(st.tpl.numpy(), other.tpl.numpy())
    np.testing.assert_array_equal(st.n_iter.numpy(), other.n_iter.numpy())
    np.testing.assert_allclose(qv.numpy(), qv_o.numpy(), rtol=1e-3, atol=0.2)


def test_candidate_loop_matches_jax():
    """heuristics=True (top-K candidate positions, bridged) against JAX:
    templates, priorities and iteration counts equal, QVs within 1e-3."""
    rng = np.random.default_rng(22)
    args = _window_args(rng)
    pri = (rng.random((4, 28)) < 0.5).astype(np.float32)
    first = np.array([True, False, False, True])
    st, qv, _ = polish.polish_windows(*_t(*args), TABLES, max_iters=20,
                                      heuristics=True, k_cand=6,
                                      priority=torch.from_numpy(pri),
                                      is_first=torch.from_numpy(first))
    js, jqv, _ = jax_polish.polish_windows(
        *_j(*args), JTABLES, max_iters=20, heuristics=True, k_cand=6,
        priority=jnp.asarray(pri), is_first=jnp.asarray(first))
    for k in ("tpl", "tlen", "core_start", "core_end", "n_iter", "priority"):
        np.testing.assert_array_equal(getattr(st, k).numpy(),
                                      np.asarray(getattr(js, k)), err_msg=k)
    np.testing.assert_allclose(qv.numpy(), np.asarray(jqv), atol=1e-3)


def test_polish_recovers_template_with_sane_qv():
    """Twins of test_polish.py::TestPolish: windows whose draft has 1-3
    errors converge to the true template; high coverage gives QV > 25; a
    window without coverage never iterates."""
    rng = np.random.default_rng(42)
    T_CAP, R_CAP, C, B = 32, 48, 12, 6
    tpl = np.full((B, T_CAP), -1, np.int8)
    tlen = np.zeros(B, np.int32)
    reads = np.full((B, C, R_CAP), -1, np.int8)
    rlens = np.full((B, C), -1, np.int32)
    truths = []
    for b in range(B):
        truth = rng.integers(0, 4, 24).astype(np.int8)
        truths.append(truth)
        corrupt = truth.copy().tolist()
        for _ in range(rng.integers(1, 4)):
            op = rng.integers(0, 3)
            p = int(rng.integers(0, len(corrupt)))
            if op == 0:
                corrupt[p] = (corrupt[p] + 1) % 4
            elif op == 1 and len(corrupt) > 2:
                del corrupt[p]
            else:
                corrupt.insert(p, int(rng.integers(0, 4)))
        tpl[b, :len(corrupt)] = corrupt
        tlen[b] = len(corrupt)
        for c in range(C):
            r = simulate_read(truth, PARAMS, 4, rng)[:R_CAP]
            reads[b, c, :len(r)] = r
            rlens[b, c] = len(r)
    rlens[B - 1] = -1                     # the last window has no coverage
    st, qv, _ = polish.polish_windows(
        *_t(tpl, tlen, np.zeros(B, np.int32), tlen.copy(),
            np.full(B, 4, np.int32), reads, rlens), TABLES, max_iters=12)
    exact = sum(np.array_equal(st.tpl[b, :int(st.tlen[b])].numpy(),
                               truths[b]) for b in range(B - 1))
    assert exact >= B - 2, f"only {exact}/{B - 1} windows recovered exactly"
    assert not bool(st.active.any())
    assert int(st.n_iter[B - 1]) == 0
    np.testing.assert_array_equal(st.tpl[B - 1].numpy(), tpl[B - 1])
    good = [b for b in range(B - 1)
            if np.array_equal(st.tpl[b, :int(st.tlen[b])].numpy(), truths[b])]
    assert float(np.mean([qv[b, :int(st.tlen[b])].mean() for b in good])) > 25


# --- the fused loop's scorers and loop against brute force ----------------

def test_fused_scorers_match_brute_force():
    """Twin of test_polish_fused.py::test_score_all_xla_matches_bruteforce
    and ::test_prepend_scores_match_bruteforce, over every slot: the dense
    and candidate-sparse scorers' plain versions (what the CUDA kernels are
    held to) against forward_batch on every mutant template of the 9-kind
    enumeration; ll0 against the forward of the template; unbridged sparse
    slots exactly 0."""
    rng = np.random.default_rng(0)
    arrs, _ = _batch(rng, 6, 4, 24, 32, tl_range=(5, 22), n_err=(0, 3),
                     pw=True)
    tpl, tlen, snr_bin, reads, rlens = _t(*arrs)
    mt, ml, valid8 = polish.make_mutants(tpl, tlen)
    brute = polish.absolute_layout(
        polish.score_mutants(mt, ml, valid8, snr_bin, reads, rlens, TABLES,
                             m_chunk=64), tpl)
    ll0 = hmm_forward.forward_batch(tpl, tlen, snr_bin, reads, rlens,
                                    TABLES).sum(-1)
    valid = mutation_valid_new(tpl, tlen)
    np.testing.assert_array_equal(valid.numpy(), (brute > polish.NEG / 2)
                                  .numpy())
    cand = torch.from_numpy(rng.random(tpl.shape) < 0.5)
    dense = hmm_score.score_dense(tpl, tlen, snr_bin, reads, rlens, TABLES)
    sparse = hmm_score.score_sparse(tpl, tlen, snr_bin, reads, rlens, cand,
                                    TABLES)
    for (lls, got0), scored in ((dense, valid),
                                (sparse, valid & hmm_score.scored_slots(
                                    tpl, tlen, cand))):
        assert float((got0 - ll0).abs().max()) <= 2e-3
        d = torch.where(scored, (lls - brute).abs(), 0.0)
        assert float(d.max()) <= 5e-3
    unbridged = ~hmm_score.scored_slots(tpl, tlen, cand)
    assert (sparse[0][unbridged] == 0).all()


def test_prepend_on_an_empty_template_matches_the_oracle():
    """A prepend on a template of 0 bases is the template of its base
    alone. The scorer (plain version and kernel) scores it so, as the
    oracle does; the JAX scorer steps over a first base that is not there
    and scores a two-base template (a defect of the reference, ROADMAP
    Queue 3), pinned here."""
    from ccs_tpu.pipeline.polish_fused import score_all_xla
    tpl = np.full((2, 8), -1, np.int8)
    tlen = np.zeros(2, np.int32)
    snr_bin = np.array([3, 5], np.int32)
    reads = np.full((2, 1, 4), -1, np.int8)
    reads[1, 0, 0] = 2
    rlens = np.array([[0], [1]], np.int32)
    lls, _ = hmm_score.score_dense(*_t(tpl, tlen, snr_bin, reads, rlens),
                                   TABLES)
    jlls, _ = score_all_xla(*_j(tpl, tlen, snr_bin, reads, rlens), JTABLES)
    for b in range(2):
        for x in range(4):
            want = hmm_oracle.forward_ll(np.array([x], np.int8),
                                         reads[b, 0, :rlens[b, 0]], PARAMS,
                                         int(snr_bin[b]))
            assert float(lls[b, 9 * 8 + x]) == pytest.approx(want, abs=1e-4)
            assert abs(float(jlls[b, 9 * 8 + x]) - want) > 0.1


@pytest.mark.parametrize("scoring", ["dense", "cols"])
def test_fused_loop_matches_round1_loop(scoring):
    """Twin of test_polish_fused.py::test_fused_loop_matches_dense_loop
    against the brute-force and the bridged round-1 loop. The JAX bar
    allows one differing template per batch (a tie settled by rounding);
    the brute force has no ties that rounding settles (equivalent mutants
    build one template, so their forwards are bit-identical) and the fused
    loop gives each class its maximum, and on these windows the two agree
    on every template."""
    rng = np.random.default_rng(3)
    arrs, _ = _batch(rng, 10, 8, 28, 36, tl_range=(16, 23), n_err=(0, 3))
    tpl, tlen, snr_bin, reads, rlens = _t(*arrs)
    cs = torch.full((10,), 2, dtype=torch.int32)
    ce = tlen - 2
    st_old, _, _ = polish.polish_windows(tpl, tlen, cs, ce, snr_bin, reads,
                                         rlens, TABLES, max_iters=20,
                                         scoring=scoring)
    st_new, _, _ = polish_windows_fused(tpl, tlen, cs, ce, snr_bin, reads,
                                        rlens, TABLES, max_iters=20)
    assert not bool(st_new.active.any())
    differ = [b for b in range(10)
              if not np.array_equal(st_old.tpl[b].numpy(),
                                    st_new.tpl[b].numpy())]
    assert differ == []
