"""The benchmark's frozen copies agree with the program and chip_smoke.py
as they stand: the simulator (same pool at fixed seeds) and the scorer's
operation count and bound."""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import pytest

from ccsbench import generator
from ccsbench.frozen import scorer_batch, sim
from ccsbench.tests import tiny


def test_default_params_equal_the_programs():
    from ccs_tpu_torch.models.chemistry import default_params
    prog, frozen = default_params(), sim.default_params()
    for k in ("snr_edges", "trans", "emit_match", "emit_stick"):
        assert np.array_equal(getattr(prog, k), getattr(frozen, k)), k


@pytest.mark.parametrize("with_pw", [False, True])
@pytest.mark.parametrize("passes", [8, 3, 5])
def test_simulate_zmw_equals_the_programs(passes, with_pw):
    from ccs_tpu_torch.sim import simulator
    for hole in range(3):
        a = simulator.simulate_zmw(
            hole, 400, passes, rng=np.random.default_rng([5, hole]),
            snr=9.0, with_pw=with_pw)
        b = sim.simulate_zmw(
            hole, 400, passes, rng=np.random.default_rng([5, hole]),
            snr=9.0, with_pw=with_pw)
        assert np.array_equal(a.insert, b.insert)
        assert np.array_equal(a.snr, b.snr)
        assert a.strands == b.strands and a.cx == b.cx
        assert all(np.array_equal(x, y) for x, y in
                   zip(a.subreads, b.subreads))
        assert (a.pws is None) == (b.pws is None) == (not with_pw)
        assert all(np.array_equal(x, y) for x, y in
                   zip(a.pws or [], b.pws or []))


def test_pool_is_the_programs_simulation():
    """Each pool member is what the program's simulator draws from the
    member's stream of the seed."""
    from ccs_tpu_torch.sim import simulator
    seed = 3 * 2 ** 31 + 11
    pool = generator.make_pool(tiny.TRAFFIC, seed)
    for i, z in enumerate(pool):
        ref = simulator.simulate_zmw(
            i, 300, len(z.subreads), rng=generator._rng(seed, 1, i), snr=9.0)
        assert np.array_equal(ref.insert, z.insert)
        assert all(np.array_equal(x, y) for x, y in
                   zip(ref.subreads, z.subreads))


def test_mixed_passes_same_multiset_every_seed():
    t = dict(tiny.TRAFFIC, passes=list(range(1, 11)), pool_zmws=20)
    counts = [sorted(len(z.subreads) for z in generator.make_pool(t, s))
              for s in (1, 2, 2 ** 32 + 7)]
    assert counts[0] == counts[1] == counts[2] == sorted(list(range(1, 11))
                                                         * 2)
    orders = [[len(z.subreads) for z in generator.make_pool(t, s)]
              for s in (1, 2)]
    assert orders[0] != orders[1]


def _chip_smoke():
    path = os.path.join(tiny.REPO, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_copy", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_operation_count_and_bound_equal_chip_smokes():
    cs = _chip_smoke()
    rng = np.random.default_rng(1)
    tlen = rng.integers(0, 45, 64).astype(np.int32)
    rlens = rng.integers(-1, 40, (64, 16)).astype(np.int32)
    cand = rng.random((64, 44)) < 0.3
    for c in (cand, None):
        assert scorer_batch.scorer_flops(tlen, rlens, c) == \
            cs._scorer_flops(tlen, rlens, c)
    for ops, nbytes in ((1e9, 10 ** 6), (1e6, 10 ** 9)):
        assert scorer_batch.bound_ms(ops, nbytes) == \
            cs._bound(ops, cs.FP32_FLOP_S, nbytes)
    assert (scorer_batch.T_CAP, scorer_batch.R_CAP, scorer_batch.W,
            scorer_batch.C) == (cs.T_CAP, cs.R_CAP, cs.W, cs.C)


def test_window_batch_shapes_and_candidate_share():
    tpl, tlen, snr_bin, reads, rlens, cand = scorer_batch.window_batch(
        np.random.default_rng(4))
    assert tpl.shape == (2048, 44) and reads.shape == (2048, 16, 39)
    assert (tlen >= 26).all() and (tlen <= 32).all()
    share = cand.sum() / tlen.sum()
    assert abs(share - scorer_batch.CAND_SHARE) < 0.01
