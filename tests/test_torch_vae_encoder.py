"""The port's `VAEEncoder` (arbius_tpu_torch/models/sd15/vae.py) against
the reference's (arbius_tpu/models/sd15/vae.py:85-107) at the tiny
config in float32: the same seeded weights (numpy draws into the
reference's `eval_shape` tree, through the bridge) and images give
moments within 5e-5, the decoder's tolerance in tests/test_torch_sd15.py.
No caller in either package uses the encoder: it is a twin for
completeness."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arbius_tpu.models.sd15.vae import VAEConfig as JConfig
from arbius_tpu.models.sd15.vae import VAEEncoder as JEncoder
from arbius_tpu_torch.models.sd15 import VAEConfig, VAEEncoder
from arbius_tpu_torch.models.sd15.bridge import (
    params_from_jax,
    template_from_models,
)
from test_torch_convert import _draw, _flat

F32_TOL = 5e-5


@pytest.mark.parametrize("hw", [(32, 32), (16, 24)])
def test_vae_encoder_matches_reference_f32(hw):
    jcfg = dataclasses.replace(JConfig.tiny(), dtype="float32")
    cfg = dataclasses.replace(VAEConfig.tiny(), dtype="float32")
    x = np.random.default_rng(hw[1]).uniform(
        -1, 1, (2, *hw, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda: JEncoder(jcfg).init(
        jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    tree = _draw(shapes, 3)
    want = np.asarray(JEncoder(jcfg).apply({"params": tree},
                                           jnp.asarray(x)))
    enc = VAEEncoder(cfg).eval()
    assert {k: tuple(v.shape) for k, v in _flat(
        template_from_models(enc)).items()} == \
        {k: tuple(v.shape) for k, v in _flat(shapes).items()}
    enc.load_state_dict(params_from_jax(tree), strict=True)
    with torch.no_grad():
        got = enc(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, hw[0] // 8, hw[1] // 8, 8)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
