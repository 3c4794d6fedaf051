"""The port's attention (arbius_tpu_torch/ops/flash.py) against the JAX
reference on the CPU: its plain version against the Pallas kernel in
interpret mode and against `sp_attention_reference`, at
tests/test_flash.py's shapes and tolerances (2e-5 in float32, 2e-2 in
bf16). Inputs come from numpy with a seed. The CUDA kernel itself is
checked on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arbius_tpu.ops.flash import flash_attention as jax_flash
from arbius_tpu.ops.ring import sp_attention_reference
from arbius_tpu_torch.ops import flash


def _qkv(shape_q, shape_kv, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape_q).astype(dtype),
            rng.standard_normal(shape_kv).astype(dtype),
            rng.standard_normal(shape_kv).astype(dtype))


def _both(q, k, v, jdtype=jnp.float32, tdtype=torch.float32):
    jq, jk, jv = (jnp.asarray(a, jdtype) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(tdtype) for a in (q, k, v))
    got = flash.attention(tq, tk, tv).float().numpy()
    return got, (jq, jk, jv)


@pytest.mark.parametrize("b,h,sq,skv,d", [
    (1, 2, 200, 200, 40),     # ragged seq + SD-1.5 level-0 head dim
    (1, 2, 256, 77, 64),      # cross-attention over 77 text tokens
    (1, 1, 128, 128, 128),    # exactly one tile
    (1, 1, 200, 200, 512),    # ragged seq + the VAE's head dim
])
def test_plain_matches_pallas_interpret_and_reference(b, h, sq, skv, d):
    q, k, v = _qkv((b, h, sq, d), (b, h, skv, d), seed=sq + d)
    got, jargs = _both(q, k, v)
    assert got.shape == (b, h, sq, d)
    np.testing.assert_allclose(
        got, np.asarray(jax_flash(*jargs, interpret=True)),
        rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        got, np.asarray(sp_attention_reference(*jargs)),
        rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("d", [40, 64, 80, 160, 512])
@pytest.mark.parametrize("skv", [48, 77])
def test_plain_main_path_head_dims(d, skv):
    """The main paths' head dims (UNet 40/80/160, UNet3D 64, VAE 512),
    self- and cross-shaped, at a tiny length."""
    q, k, v = _qkv((2, 1, 48, d), (2, 1, skv, d), seed=d + skv)
    got, jargs = _both(q, k, v)
    np.testing.assert_allclose(
        got, np.asarray(sp_attention_reference(*jargs)), rtol=2e-5,
        atol=2e-5)


def test_plain_bf16_inputs():
    q, k, v = _qkv((1, 2, 128, 64), (1, 2, 128, 64), seed=7)
    got, jargs = _both(q, k, v, jnp.bfloat16, torch.bfloat16)
    want = np.asarray(jax_flash(*jargs, interpret=True), dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
    want = np.asarray(sp_attention_reference(*jargs), dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


def test_plain_extreme_logits():
    q = np.full((1, 1, 128, 64), 20.0, np.float32)
    v = np.random.default_rng(3).standard_normal((1, 1, 128, 64)).astype(
        np.float32)
    got, jargs = _both(q, q.copy(), v)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(
        got, np.asarray(jax_flash(*jargs, interpret=True)), rtol=1e-5,
        atol=1e-5)


def test_kernel_wrapper_rejects_cpu_tensors():
    q = torch.zeros(1, 1, 8, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash.flash_attention(q, q, q)
    assert flash.flash_attention.launches == 0


@pytest.mark.parametrize("bad", ["dtype", "shape", "stride"])
def test_kernel_wrapper_checks_inputs(bad):
    q = torch.zeros(1, 2, 8, 16)
    k = v = torch.zeros(1, 2, 5, 16)
    if bad == "dtype":
        k = k.double()
    elif bad == "shape":
        k = torch.zeros(1, 2, 5, 8)
    else:
        q = torch.zeros(1, 2, 16, 8).transpose(2, 3)
    with pytest.raises(ValueError):
        flash.flash_attention(q, k, v)
