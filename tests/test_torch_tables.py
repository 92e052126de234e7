"""ccs_tpu_torch.ops.tables against ccs_tpu.ops.hmm_jax: the parameter
tables carried across and the per-position tables must be equal exactly."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ccs_tpu.models.chemistry import default_params, load_model
from ccs_tpu.ops import hmm_jax
from ccs_tpu.pipeline.polish_fused import CLEAN_PERR_V0
from ccs_tpu.sim.simulator import make_subreads_header
from ccs_tpu_torch.models import chemistry as port_chemistry
from ccs_tpu_torch.ops import tables as tt
from ccs_tpu_torch.sim import simulator as port_simulator

# The suite runs several pytest workers on a few cores; torch's intra-op
# threads on these small tensors only contend with them.
torch.set_num_threads(1)

PARAMS = {
    "default": default_params(),
    "builtin": load_model(make_subreads_header().chemistry()),
}
# the same two models as the port's own ArrowParams class
PORT_PARAMS = {
    "default": port_chemistry.default_params(),
    "builtin": port_chemistry.load_model(
        port_simulator.make_subreads_header().chemistry()),
}


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_params_to_torch_equals_params_to_device(name):
    params = PARAMS[name]
    ref = hmm_jax.params_to_device(params)
    got = tt.params_to_torch(PORT_PARAMS[name], "cpu")
    assert set(ref) == set(tt.PARAM_KEYS)
    for k in tt.PARAM_KEYS:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    np.testing.assert_array_equal(got["clean_perr"].numpy(), CLEAN_PERR_V0)


def test_tables_from_numpy_carries_jax_tables():
    ref = hmm_jax.params_to_device(PARAMS["builtin"])
    got = tt.tables_from_numpy({k: np.asarray(v) for k, v in ref.items()},
                               "cpu")
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_position_tables_equal(name):
    rng = np.random.default_rng(0)
    B, T = 6, 20
    tpl = rng.integers(0, 4, (B, T)).astype(np.int8)
    for b, tl in enumerate(rng.integers(1, T + 1, B)):
        tpl[b, tl:] = -1
    snr = rng.integers(0, 8, B).astype(np.int32)
    ref = hmm_jax.position_tables(jnp.asarray(tpl), jnp.asarray(snr),
                                  hmm_jax.params_to_device(PARAMS[name]))
    got = tt.position_tables(torch.from_numpy(tpl), torch.from_numpy(snr),
                             tt.params_to_torch(PORT_PARAMS[name], "cpu"))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_decode_reads_equal():
    rng = np.random.default_rng(1)
    reads = rng.integers(-1, 16, (3, 4, 30)).astype(np.int8)
    ref = hmm_jax.decode_reads(jnp.asarray(reads))
    got = tt.decode_reads(torch.from_numpy(reads))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
