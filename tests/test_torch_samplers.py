"""The port's six samplers against arbius_tpu.schedulers: the float32
tables are exactly equal, and fed the same (x, eps, noise) sequences the
float32 trajectories agree within rtol = atol = 1e-5 (the two frameworks
may fuse a*x + b*eps into an FMA differently)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arbius_tpu.schedulers import get_sampler as jax_sampler
from arbius_tpu_torch.schedulers import SAMPLER_NAMES, get_sampler

TABLES = ("timesteps", "input_scale", "_c_x", "_c_e", "_dsigma", "_sig_up",
          "_coeffs", "_inv_alpha", "_sig_over_alpha", "_xcoef", "_d0coef",
          "_inv_2r0", "_second", "_sc", "_dc", "_w_cur", "_w_hist")


def test_names_match_reference():
    from arbius_tpu.schedulers import SAMPLER_NAMES as ref

    assert SAMPLER_NAMES == ref


@pytest.mark.parametrize("name", SAMPLER_NAMES)
@pytest.mark.parametrize("steps", [2, 20])
def test_tables_equal(name, steps):
    ref, port = jax_sampler(name, steps), get_sampler(name, steps)
    assert port.num_model_calls == ref.num_model_calls
    assert port.init_noise_sigma == ref.init_noise_sigma
    assert port.needs_noise == ref.needs_noise
    for attr in TABLES:
        if hasattr(ref, attr):
            np.testing.assert_array_equal(np.asarray(getattr(port, attr)),
                                          np.asarray(getattr(ref, attr)))


@pytest.mark.parametrize("name", SAMPLER_NAMES)
@pytest.mark.parametrize("steps", [2, 20])
def test_trajectory_matches(name, steps):
    ref, port = jax_sampler(name, steps), get_sampler(name, steps)
    rng = np.random.default_rng(steps)
    x0 = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    jx, tx = jnp.asarray(x0), torch.from_numpy(x0)
    jstate, tstate = ref.init_carry(jx), port.init_carry(tx)
    for i in range(ref.num_model_calls):
        eps = rng.standard_normal(x0.shape).astype(np.float32)
        noise = rng.standard_normal(x0.shape).astype(np.float32)
        jx, jstate = ref.step(i, jx, jnp.asarray(eps), jstate,
                              jnp.asarray(noise))
        tx, tstate = port.step(i, tx, torch.from_numpy(eps), tstate,
                               torch.from_numpy(noise))
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5,
                                   atol=1e-5, err_msg=f"{name} step {i}")


def test_unknown_scheduler_raises():
    with pytest.raises(ValueError, match="unknown scheduler"):
        get_sampler("EULER_PLUS", 20)
