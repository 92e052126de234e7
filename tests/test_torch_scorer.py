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
