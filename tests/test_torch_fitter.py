"""The port's clean-position p_err fitter (ccs_tpu_torch/tools/fit_clean_qv.py)
against the JAX package's tools/fit_clean_qv.py.

Bars: fit_table bit-equal on the same rows; measure on one grid cell (SNR
9, 6 passes, 16 windows) against a reference polished on the same windows
by the JAX fused loop with dense XLA scoring (the JAX tool's
``use_pallas=False``): final templates and cores identical, p_err within
1e-4 (measured 3.5e-6), sample counts within 1% and cell means within 1%
relative (measured: 248 against 249 samples, means 2.5773e-3 against
2.5661e-3, 0.44%). The samples differ because one position's candidate flag
follows which member of a class of equivalent deletions each loop applied,
the tie of tests/test_torch_ties.py: the JAX loop settles it by rounding,
the port takes the leftmost member."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccs_tpu.models.chemistry import default_params as jax_default_params
from ccs_tpu.ops.hmm_jax import params_to_device
from ccs_tpu.pipeline.polish_fused import polish_windows_fused_impl
from ccs_tpu_torch.models.chemistry import default_params
from ccs_tpu_torch.ops.tables import CLEAN_PERR_PATH, params_to_torch
from ccs_tpu_torch.pipeline.polish_fused import polish_windows_fused
from ccs_tpu_torch.tools import fit_clean_qv as port_fit

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    """The JAX package's tool, loaded from its file (tools/ is no package)."""
    spec = importlib.util.spec_from_file_location(
        "jax_fit_clean_qv", os.path.join(ROOT, "tools", "fit_clean_qv.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fit_table_matches_jax():
    """Cells with and without 80 samples, snr bins with one measured cell
    (they borrow the nearest bin's fit) and bins with none."""
    rng = np.random.default_rng(0)
    rows = {}
    for sb, covs in ((2, (4, 6, 10, 15)), (4, (3, 6, 10, 16, 22)),
                     (5, (8,)), (7, (10, 20))):
        for c in covs:
            n = int(rng.integers(40, 400))
            rows[(sb, c)] = (10.0 ** rng.uniform(-4.5, -1.5)
                             * rng.uniform(0.5, 1.5, n)).astype(np.float32)
    got = port_fit.fit_table(rows)
    want = _jax_tool().fit_table(rows)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_measure_one_cell_matches_jax_fused_dense():
    rows = port_fit.measure(device="cpu", snrs=(9.0,), passes=(6,), bp=16,
                            log=lambda m: None)
    a, n = port_fit.cell_windows(9.0, 6, 16)
    assert n == 16 and list(rows) == [(4, 6)]
    args = tuple(a[k] for k in ("tpl", "tlen", "cs", "ce", "snr_bin",
                                "reads", "rlens"))
    js, _q, jpe = polish_windows_fused_impl(
        *(jnp.asarray(x) for x in args),
        params_to_device(jax_default_params()),
        max_iters=port_fit.MAX_ITERS, priority=jnp.asarray(a["pri"]),
        use_pallas=False)
    ref = {}
    port_fit.cell_rows(a, n, np.asarray(jpe), np.asarray(js.priority),
                       np.asarray(js.core_start), np.asarray(js.core_end),
                       ref)
    ref = {k: np.concatenate(v) for k, v in ref.items()}
    assert ref.keys() == rows.keys()
    got, want = rows[(4, 6)], ref[(4, 6)]
    assert abs(len(got) - len(want)) <= 0.01 * len(want)
    assert got.mean() == pytest.approx(want.mean(), rel=1e-2)
    # the same windows through the port's loop directly: the same
    # templates and cores as the JAX loop, p_err within 1e-4
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    st, _q, pe = polish_windows_fused(
        t["tpl"], t["tlen"], t["cs"], t["ce"], t["snr_bin"], t["reads"],
        t["rlens"], params_to_torch(default_params(), "cpu"),
        max_iters=port_fit.MAX_ITERS, priority=t["pri"], compact=True)
    for k in ("tpl", "tlen", "core_start", "core_end"):
        np.testing.assert_array_equal(getattr(st, k).numpy()[:n],
                                      np.asarray(getattr(js, k))[:n])
    np.testing.assert_allclose(pe.numpy()[:n], np.asarray(jpe)[:n],
                               atol=1e-4)


def test_fitter_needs_cuda_unless_a_device_is_named(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_fit.measure(snrs=(9.0,), passes=(6,), bp=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_fit.main(["--fast", "--out", str(tmp_path / "t.npy")])
    assert not (tmp_path / "t.npy").exists()


def test_fitter_never_writes_the_shipped_table():
    with open(CLEAN_PERR_PATH, "rb") as fh:
        before = fh.read()
    with pytest.raises(SystemExit):
        port_fit.main(["--fast", "--device", "cpu", "--out",
                       CLEAN_PERR_PATH])
    with open(CLEAN_PERR_PATH, "rb") as fh:
        assert fh.read() == before


@pytest.mark.slow
def test_fast_refit_matches_jax_tool(tmp_path):
    """The whole --fast grid (4 cells x 64 windows) through both tools on
    the CPU: the same cells, counts within 1%, cell means and the fitted
    tables within 0.5 QV wherever a cell was measured (the full grid's
    refits read at most 0.366 QV apart: a tie moves one position's
    candidate flag, and a cell mean of ~1e-4 follows its few high-p_err
    samples). Minutes of CPU for the JAX side, hence slow."""
    port_fit.main(["--fast", "--device", "cpu", "--out",
                   str(tmp_path / "port.npy")])
    rows_t = port_fit.measure(fast=True, device="cpu", log=lambda m: None)
    rows_j = _jax_tool().measure(fast=True)
    assert rows_t.keys() == rows_j.keys()

    def dqv(a, b):
        return 10 * abs(np.log10(a) - np.log10(b))

    for k in rows_j:
        assert abs(len(rows_t[k]) - len(rows_j[k])) <= 0.01 * len(rows_j[k])
        assert dqv(rows_t[k].mean(), rows_j[k].mean()) <= 0.5, k
    tab_t = np.load(str(tmp_path / "port.npy"))
    np.testing.assert_array_equal(tab_t, port_fit.fit_table(rows_t))
    tab_j = _jax_tool().fit_table(rows_j)
    for k, v in rows_j.items():
        if len(v) >= 80:
            assert dqv(tab_t[k], tab_j[k]) <= 0.5, k
