"""The port's pair-HMM scorer (ccs_tpu_torch.ops.hmm_score) against the JAX
package: the plain versions against score_all_xla and the Pallas kernels
in interpret mode, both against the log-space numpy oracle, and (on a
machine with a CUDA device) the CUDA kernels against their plain versions.

Bars: ll0 within 2e-3 and valid mutation LLs within 5e-3 — the JAX
package's own bars for its kernels (test_polish_fused.py); the port sums
in another order than XLA, so bits differ. Unbridged sparse slots must be
exactly 0 in both packages."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ccs_tpu.models import chemistry as jax_chemistry
from ccs_tpu.models.chemistry import pack_read_pw
from ccs_tpu.ops import hmm_oracle
from ccs_tpu.ops.hmm_jax import params_to_device
from ccs_tpu.ops.hmm_score_pallas import score_all_pallas, score_sparse_pallas
from ccs_tpu.pipeline.polish_fused import mutation_valid_new, score_all_xla
from ccs_tpu.sim.simulator import simulate_read
from ccs_tpu_torch.models import chemistry as port_chemistry
from ccs_tpu_torch.ops import _build, hmm_score
from ccs_tpu_torch.ops.tables import params_to_torch
from ccs_tpu_torch.sim.edges import edge_batch

# The suite runs several pytest workers on a few cores; torch's intra-op
# threads on these small tensors only contend with them.
torch.set_num_threads(1)

LL0_TOL, LLS_TOL = 2e-3, 5e-3


def _params(pw: bool, chemistry=jax_chemistry):
    """The test's ArrowParams, as the JAX package's class (inputs and the
    JAX side) or, with ``port_chemistry``, as the port's own class."""
    p = chemistry.default_params()
    if pw:   # non-trivial pulse-width factors (bin 0 stays 1)
        rng = np.random.default_rng(42)
        p.pw_match = rng.uniform(0.6, 1.4, (8, 4)).astype(np.float32)
        p.pw_ins = rng.uniform(0.5, 2.0, (8, 4)).astype(np.float32)
        p.pw_match[:, 0] = p.pw_ins[:, 0] = 1.0
    return p


def _port_tables(pw: bool, device="cpu"):
    return params_to_torch(_params(pw, port_chemistry), device)


def simulate_batch(rng, params, B, C, t_cap, r_cap, tl_range=(12, 22),
                   n_err=(0, 3), pw=False):
    """numpy window batch: corrupted templates, simulator reads (packed
    base + 4*pw when ``pw``), -1 padding; one absent read in row 1."""
    tpl = np.full((B, t_cap), -1, np.int8)
    tlen = np.zeros(B, np.int32)
    reads = np.full((B, C, r_cap), -1, np.int8)
    rlens = np.full((B, C), -1, np.int32)
    snr = rng.integers(0, 8, B).astype(np.int32)
    true = []
    for b in range(B):
        tl = int(rng.integers(*tl_range))
        t = rng.integers(0, 4, tl).astype(np.int8)
        true.append(t)
        corrupt = t.copy()
        for _ in range(int(rng.integers(*n_err))):
            p = int(rng.integers(0, tl))
            corrupt[p] = (corrupt[p] + 1) % 4
        tpl[b, :tl] = corrupt
        tlen[b] = tl
        for c in range(C):
            r = simulate_read(t, params, int(snr[b]), rng)[:r_cap]
            if pw:
                r = pack_read_pw(r, rng.integers(0, 4, len(r)))
            reads[b, c, :len(r)] = r
            rlens[b, c] = len(r)
    if B > 1 and C > 1:
        reads[1, C - 1] = -1
        rlens[1, C - 1] = -1
    return (tpl, tlen, snr, reads, rlens), true


def _torch(arrs, device="cpu"):
    return tuple(torch.from_numpy(a).to(device) for a in arrs)


def _jax(arrs):
    return tuple(jnp.asarray(a) for a in arrs)


def _bridged(tpl, tlen, cand):
    T = tpl.shape[1]
    c = cand & (np.arange(T)[None, :] < tlen[:, None])
    out = np.zeros((tpl.shape[0], 9 * T + 4), bool)
    out[:, :9 * T] = np.repeat(c, 9, axis=1)
    out[:, 9 * T:] = True
    return out


@pytest.mark.parametrize("seed,pw", [(0, False), (1, True)])
def test_plain_dense_matches_xla(seed, pw):
    params = _params(pw)
    arrs, _ = simulate_batch(np.random.default_rng(seed), params, 6, 4, 24,
                             32, pw=pw)
    lls_x, ll0_x = score_all_xla(*_jax(arrs), params_to_device(params))
    lls_t, ll0_t = hmm_score.score_dense_plain(*_torch(arrs),
                                               _port_tables(pw))
    valid = np.asarray(mutation_valid_new(*_jax(arrs[:2])))
    np.testing.assert_allclose(ll0_t.numpy(), np.asarray(ll0_x),
                               atol=LL0_TOL)
    d = np.abs(np.where(valid, lls_t.numpy() - np.asarray(lls_x), 0.0))
    assert d.max() < LLS_TOL
    # slots the kernels leave at 0: self-substitutions and p >= tlen
    scored = hmm_score.scored_slots(*_torch(arrs[:2])).numpy()
    assert np.all(lls_t.numpy()[~scored] == 0.0)
    assert np.all(lls_t.numpy()[valid] != 0.0)


def test_plain_dense_matches_pallas_interpret():
    params = _params(False)
    arrs, _ = simulate_batch(np.random.default_rng(2), params, 5, 3, 18, 24,
                             tl_range=(3, 15))
    lls_p, ll0_p = score_all_pallas(*_jax(arrs), params_to_device(params),
                                    interpret=True)
    lls_t, ll0_t = hmm_score.score_dense(*_torch(arrs),
                                         _port_tables(False))
    valid = np.asarray(mutation_valid_new(*_jax(arrs[:2])))
    np.testing.assert_allclose(ll0_t.numpy(), np.asarray(ll0_p),
                               atol=LL0_TOL)
    d = np.abs(np.where(valid, lls_t.numpy() - np.asarray(lls_p), 0.0))
    assert d.max() < LLS_TOL


def test_plain_sparse_matches_pallas_interpret():
    params = _params(False)
    rng = np.random.default_rng(7)
    arrs, _ = simulate_batch(rng, params, 5, 3, 18, 24, tl_range=(3, 15))
    cand = rng.random(arrs[0].shape) < 0.5
    lls_p, ll0_p = score_sparse_pallas(*_jax(arrs), jnp.asarray(cand),
                                       params_to_device(params),
                                       interpret=True)
    lls_t, ll0_t = hmm_score.score_sparse(
        *_torch(arrs), torch.from_numpy(cand),
        _port_tables(False))
    np.testing.assert_allclose(ll0_t.numpy(), np.asarray(ll0_p),
                               atol=LL0_TOL)
    valid = np.asarray(mutation_valid_new(*_jax(arrs[:2])))
    bridged = _bridged(arrs[0], arrs[1], cand)
    lls_t, lls_p = lls_t.numpy(), np.asarray(lls_p)
    d = np.abs(np.where(valid & bridged, lls_t - lls_p, 0.0))
    assert d.max() < LLS_TOL
    T = arrs[0].shape[1]
    unbridged = ~bridged[:, :9 * T]
    assert np.all(lls_t[:, :9 * T][unbridged] == 0.0)
    assert np.all(lls_p[:, :9 * T][unbridged] == 0.0)


def _apply(t0, p, k):
    if k <= 3:
        mt = t0.copy()
        mt[p] = k
        return mt
    if k == 4:
        return np.delete(t0, p)
    return np.insert(t0, p + 1, k - 5)


@pytest.mark.parametrize("pw", [False, True])
def test_plain_matches_numpy_oracle(pw):
    """Mutation LLs against the log-space forward oracle run on each
    mutated template (summed over live reads)."""
    params = _params(pw)
    rng = np.random.default_rng(3)
    arrs, _ = simulate_batch(rng, params, 3, 3, 12, 16, tl_range=(5, 9),
                             pw=pw)
    tpl, tlen, snr, reads, rlens = arrs
    lls, ll0 = hmm_score.score_dense(*_torch(arrs),
                                     _port_tables(pw))
    T = tpl.shape[1]

    def oracle(b, t):
        return sum(hmm_oracle.forward_ll(t, reads[b, c, :rlens[b, c]],
                                         params, int(snr[b]))
                   for c in range(reads.shape[1]) if rlens[b, c] >= 0)

    checked = 0
    for b in range(tpl.shape[0]):
        t0 = tpl[b, :tlen[b]]
        assert abs(oracle(b, t0) - float(ll0[b])) < LL0_TOL
        for p, k in ((0, 4), (int(tlen[b]) - 1, 6), (2, (t0[2] + 1) % 4)):
            got = float(lls[b, 9 * p + k])
            assert abs(oracle(b, _apply(t0, p, k)) - got) < LLS_TOL, (b, p, k)
            checked += 1
        x = int(rng.integers(0, 4))
        got = float(lls[b, 9 * T + x])
        assert abs(oracle(b, np.insert(t0, 0, x)) - got) < LLS_TOL
    assert checked == 9


def test_wrapper_never_falls_back_off_cpu():
    """Only CPU tensors take the plain version: any other device goes to
    the kernel launcher, which raises where it cannot launch."""
    params = _params(False)
    arrs, _ = simulate_batch(np.random.default_rng(4), params, 2, 2, 10, 12,
                             tl_range=(4, 8))
    meta = tuple(torch.empty(a.shape, dtype=torch.from_numpy(a).dtype,
                             device="meta") for a in arrs)
    with pytest.raises(RuntimeError, match="cannot run on meta"):
        hmm_score.score_dense(*meta, _port_tables(False))
    with pytest.raises(RuntimeError, match="cannot run on cpu"):
        hmm_score._launch(hmm_score.score_dense, "ccs_hmm_score_dense",
                          *_torch(arrs), None, _port_tables(False))


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "library_path",
                        lambda: str(tmp_path / "lib.so"))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build()
    monkeypatch.undo()
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    if not _build.os.path.exists("/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build._nvcc()


@pytest.mark.cuda
@pytest.mark.parametrize("sparse", [False, True])
def test_kernel_matches_plain(sparse):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    params = _params(True)
    rng = np.random.default_rng(5)
    arrs, _ = simulate_batch(rng, params, 64, 8, 44, 39, tl_range=(1, 45),
                             pw=True)
    cand = torch.from_numpy(rng.random(arrs[0].shape) < 0.4).cuda()
    tables = _port_tables(True, "cuda")
    args = _torch(arrs, "cuda")
    if sparse:
        got = hmm_score.score_sparse(*args, cand, tables)
        ref = hmm_score.score_sparse_plain(*args, cand, tables)
    else:
        got = hmm_score.score_dense(*args, tables)
        ref = hmm_score.score_dense_plain(*args, tables)
    torch.cuda.synchronize()
    assert (got[1] - ref[1]).abs().max().item() < LL0_TOL
    assert (got[0] - ref[0]).abs().max().item() < LLS_TOL
    # exact zeros agree: unscored slots are 0 in both
    assert torch.equal(got[0] == 0, ref[0] == 0)


# ---------------------------------------------------------------------------
# the CUDA kernel's column sweep, emulated lane by lane
# ---------------------------------------------------------------------------

F32 = np.float32
TINY32 = F32(1e-30)


def _shfl_up(x, d):
    """__shfl_up_sync over 32 lanes: lanes below d keep their own value."""
    out = x.copy()
    out[d:] = x[:-d]
    return out


def _dot4(rows, vec):
    """dot4 of hmm_score.cu: four float32 products summed left to right."""
    return ((rows[..., 0] * vec[0] + rows[..., 1] * vec[1])
            + rows[..., 2] * vec[2]) + rows[..., 3] * vec[3]


def emulate_sweep(ohm, ohi, me, ie, dp, tl, rl, bwd):
    """sweep_chain of csrc/hmm_score.cu in numpy float32: one warp, lane l
    holding the K consecutive cells K*l .. K*l+K-1 (K = 1, 2 or 4 by the
    read's length), the neighbour by a shuffle, the insertion chain as the
    in-lane composition plus a 5-step shuffle scan of the affine maps, the
    lagged rescaling with the logarithms taken after the last step, the
    backward chain as the forward chain of the reversed read. ``ohm``/``ohi`` [S, 4] are the staged emission rows (row
    i for read base i, row 0 zero); ``me``/``ie`` [T+3, 4] and ``dp`` [T+3]
    the identity-padded operator table at index j+1. Returns (stored
    columns [ncol, rl+1], their log-scales and normalising factors, ll)."""
    K = 1 if rl < 32 else 2 if rl < 64 else 4
    lane = np.arange(32)
    r = K * lane[:, None] + np.arange(K)[None, :]
    emits = (r >= 1) & (r <= rl)
    src = np.where(emits, rl - r + 1 if bwd else r, 0)
    m = np.where(emits[..., None], ohm[src], F32(0))
    n = np.where(emits[..., None], ohi[src], F32(0))
    v = (r == 0).astype(F32)
    stored = r <= rl
    off = np.where(stored, rl - r if bwd else r, 0)
    ncol = tl + 1 if bwd else tl + 2
    out = np.zeros((ncol, rl + 1), F32)
    ls_out = np.zeros(ncol, F32)
    im_out = np.ones(ncol, F32)
    out[tl if bwd else 0, off[stored]] = v[stored]
    g = F32(1)
    nsteps = tl if bwd else tl + 1
    for t in range(nsteps):
        jm = tl - 1 - t if bwd else t - 1
        ji = jm if bwd else t
        jout = jm if bwd else t + 1
        mx = v.max()
        vl = _shfl_up(v[:, K - 1], 1)
        vl[0] = 0
        y, a = np.empty_like(v), np.empty_like(v)
        for k in range(K):
            vp = v[:, k - 1] if k else vl
            y[:, k] = g * (dp[jm + 1] * v[:, k]
                           + _dot4(m[:, k], me[jm + 1]) * vp)
            a[:, k] = _dot4(n[:, k], ie[ji + 1])
        A, Y = a[:, 0].copy(), y[:, 0].copy()
        for k in range(1, K):
            Y = y[:, k] + a[:, k] * Y
            A = A * a[:, k]
        d = 1
        while d < 32:
            Au, Yu = _shfl_up(A, d), _shfl_up(Y, d)
            Y = np.where(lane >= d, Y + A * Yu, Y)
            A = np.where(lane >= d, A * Au, A)
            d *= 2
        w = _shfl_up(Y, 1)
        w[0] = 0
        for k in range(K):
            w = y[:, k] + a[:, k] * w
            v[:, k] = w
        out[jout, off[stored]] = (y if bwd else v)[stored]
        gn = F32(1) / max(g * mx, TINY32)
        if bwd:                      # raw factors; the logs come after
            ls_out[jout] = g
            im_out[jout] = max(y.max(), TINY32)
        else:
            ls_out[t] = gn
            im_out[t] = gn * g
        g = gn
    # log-scales from the raw factors: 32 columns at a time, one per lane,
    # by a shuffle scan, the running sum carried across tiles
    run = F32(0)
    for base in range(0, nsteps, 32):
        t = base + lane
        k = np.where(t < nsteps, tl - 1 - t if bwd else t, 0)
        x = -np.log(np.where(t < nsteps, ls_out[k], F32(1))).astype(F32)
        d = 1
        while d < 32:
            x = np.where(lane >= d, x + _shfl_up(x, d), x)
            d *= 2
        x = x + run
        ok = t < nsteps
        if bwd:
            c = im_out[k[ok]]
            ls_out[k[ok]] = x[ok] + np.log(c)
            im_out[k[ok]] = F32(1) / c
        else:
            ls_out[k[ok]] = x[ok]
        last = 31 if bwd else min(31, tl - 1 - base)
        if last >= 0:
            run = x[last]
    if bwd:
        return out, ls_out, im_out, None
    mf = max(v.max(), TINY32)
    lsf = run + np.log(mf)
    ls_out[tl + 1] = lsf
    im_out[tl + 1] = F32(1) / mf
    x = v[rl // K, rl % K]
    return out, ls_out, im_out, np.log(max(x / mf, TINY32)) + lsf


@pytest.mark.parametrize("tl", [1, 2, 44])
@pytest.mark.parametrize("rl", [0, 1, 31, 32, 33, 39])
def test_lane_sweep_emulation_matches_build_columns(rl, tl):
    """The kernel's sweep (warp scan, lagged rescaling), emulated, against
    the plain columns through the invariant log(x . cols[k]) + ls[k], for
    x = each unit vector and x = ones, and against ll0.

    Bars: ll0 within 2e-3 (the scorer's bar; the scan sums the insertion
    chain in another order than the doubling solve, and the log-scales
    accumulate in another order); normalised columns within 1e-5 of the
    column maximum and their log-scales within 1e-4, far inside it."""
    from ccs_tpu_torch.ops import hmm_cols
    T, R = 44, 39
    rng = np.random.default_rng(1000 * tl + rl)
    tables = _port_tables(True)
    snr = int(rng.integers(0, 8))
    tpl = np.full((1, T), -1, np.int8)
    tpl[0, :tl] = rng.integers(0, 4, tl)
    reads = np.full((1, 1, R), -1, np.int8)
    reads[0, 0, :rl] = rng.integers(0, 16, rl)
    args = _torch((tpl, np.array([tl], np.int32), np.array([snr], np.int32),
                   reads, np.array([[rl]], np.int32)))
    ref = hmm_cols.build_columns(*args, tables)

    ohm_t, ohi_t = hmm_cols._oh_pw(args[3], args[2], tables)
    ohm = np.concatenate([np.zeros((1, 4), F32), ohm_t[0, 0].numpy()])
    ohi = np.concatenate([np.zeros((1, 4), F32), ohi_t[0, 0].numpy()])
    me_t, ie_t, dp_t = hmm_cols._padded_tables(*args[:3], tables)
    me = np.zeros((T + 3, 4), F32)
    ie = np.zeros((T + 3, 4), F32)
    dp = np.ones(T + 3, F32)
    me[1:T + 1], ie[1:T + 1], dp[1:T + 1] = (me_t[0].numpy(), ie_t[0].numpy(),
                                             dp_t[0].numpy())

    cols, lsc, imc, ll = emulate_sweep(ohm, ohi, me, ie, dp, tl, rl, False)
    betas, lsb, imb, _ = emulate_sweep(ohm, ohi, me, ie, dp, tl, rl, True)
    assert abs(ll - float(ref.ll[0, 0])) < LL0_TOL
    for got, im, ls, want, want_ls in (
            (cols, imc, lsc, ref.cols[0, 0], ref.ls_col[0, 0]),
            (betas, imb, lsb, ref.betas[0, 0], ref.ls_beta[0, 0])):
        n = got.shape[0]
        want = want.numpy()[:n, :rl + 1]
        want_ls = want_ls.numpy()[:n]
        # stored maxima stay far inside float32 (two per-column ratios)
        assert got.max(axis=1).min() > 1e-12 and got.max() < 1e2
        norm = got * im[:, None]
        np.testing.assert_allclose(norm, want, atol=1e-5)
        np.testing.assert_allclose(ls, want_ls, atol=1e-4)
        # the invariant, for x = ones
        np.testing.assert_allclose(np.log(norm.sum(axis=1)) + ls,
                                   np.log(want.sum(axis=1)) + want_ls,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# the CUDA kernels at the shapes where a lane-tiled sweep can go wrong
# (sim.edges.edge_batch: template lengths 0, 1, T/2, T with read lengths
# 0, 1, 31, 32, 33, R, dead reads mixed in, one window with no live read)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("cand_mode", ["dense", "none", "all", "some"])
@pytest.mark.parametrize("C,T,R", [(1, 44, 39), (8, 44, 39), (32, 44, 39),
                                   (16, 30, 24), (4, 20, 70)])
def test_kernel_edge_shapes(C, T, R, cand_mode):
    """Kernel against plain version within the scorer's bars, exact zeros
    in unscored slots, and a bit-identical rerun (fixed-order sums, no
    atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(11)
    arrs = edge_batch(rng, C, T, R)
    args = _torch(arrs, "cuda")
    tables = _port_tables(True, "cuda")
    some = torch.from_numpy(rng.random(arrs[0].shape) < 0.4).cuda()
    cand = {"dense": None, "none": some & False, "all": some | True,
            "some": some}[cand_mode]
    if cand is None:
        got = hmm_score.score_dense(*args, tables)
        again = hmm_score.score_dense(*args, tables)
        ref = hmm_score.score_dense_plain(*args, tables)
    else:
        got = hmm_score.score_sparse(*args, cand, tables)
        again = hmm_score.score_sparse(*args, cand, tables)
        ref = hmm_score.score_sparse_plain(*args, cand, tables)
    torch.cuda.synchronize()
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    scored = hmm_score.scored_slots(args[0], args[1], cand)
    assert not bool((got[0][~scored] != 0).any())
    assert (got[1] - ref[1]).abs().max().item() < LL0_TOL
    assert (got[0] - ref[0]).abs().max().item() < LLS_TOL


@pytest.mark.cuda
def test_kernel_refuses_reads_beyond_its_cap():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    arrs = edge_batch(np.random.default_rng(0), 2, 10,
                      hmm_score.MAX_READ_CAP + 1)
    with pytest.raises(ValueError, match="read cap"):
        hmm_score.score_dense(*_torch(arrs, "cuda"),
                              _port_tables(False, "cuda"))


def test_kernel_tables_are_built_once_with_the_tables():
    """The scorer's ctx/pw tables come with the tables (not per launch) and
    hold, per (snr bin, context), what position_tables gives a position in
    that context: match emissions | insertion emissions | deletion."""
    from ccs_tpu_torch.ops.tables import position_tables
    tables = _port_tables(True)
    ctx, pw = tables["ctx"], tables["pw"]
    assert ctx.shape == (8, 16, 9) and pw.shape == (8, 8)
    assert ctx.is_contiguous() and pw.is_contiguous()
    prev, cur = np.divmod(np.arange(16), 4)
    tpl = torch.from_numpy(np.stack([prev, cur], axis=1).astype(np.int8))
    for snr in range(8):
        me, ie, dp = position_tables(tpl, torch.full((16,), snr), tables)
        want = torch.cat([me[:, 1], ie[:, 1], dp[:, 1:2]], dim=-1)
        assert torch.equal(ctx[snr], want)
    assert torch.equal(pw[:, :4], tables["pw_match"])
    assert torch.equal(pw[:, 4:], tables["pw_ins"])
    arrs, _ = simulate_batch(np.random.default_rng(4), _params(False), 2, 2,
                             10, 12, tl_range=(4, 8))
    # the plain version does not need them
    bare = {k: v for k, v in tables.items() if k not in ("ctx", "pw")}
    got = hmm_score.score_dense_plain(*_torch(arrs), bare)
    want = hmm_score.score_dense_plain(*_torch(arrs), tables)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
