"""The port's LayerNorms compute flax's arithmetic (models/common.py
`LayerNorm32`): var = max(0, E[x^2] - E[x]^2), not torch's two-pass
variance. Held on rows whose mean is large against their spread, where
the two forms part, at every LayerNorm site of each module that carries
one: models/common.py's `TransformerBlock`, the text encoder's layer and
the kandinsky2 prior's `PriorBlock`, each site's parameters drawn in the
reference's tree and bridged into the port's module.

The rows are 64 wide at mean 100 with a few entries a quarter or a half
off it. Every value lies on a quarter grid, so each sum of x and of x^2
over a row is exact in float32 in any order, and both packages compute
the same statistics; the one rounding left is E[x]^2's, the rounding
that makes flax's form differ from the two-pass one (by up to ~6% of
the variance on these rows). Rows with a spread below the grid (mean
100, sd 1e-3) would not do: there both forms' statistics are rounding
noise that depends on the order of the sums, and the reference's own
jitted and op-by-op runs of one `TransformerBlock` differ by 5.6e-3.
For the same reason each site is fed the rows directly: inside a block,
the residual sum before the second site takes its rows off the grid.
"""
from __future__ import annotations

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arbius_tpu.models import common as jcommon
from arbius_tpu.models.kandinsky2 import prior as jprior
from arbius_tpu.models.sd15 import text_encoder as jtext
from arbius_tpu_torch.models import common
from arbius_tpu_torch.models.kandinsky2 import prior
from arbius_tpu_torch.models.sd15 import params_from_jax, text_encoder

WIDTH = 64
RTOL = 1e-6


def _rows(seed: int, n: int) -> np.ndarray:
    """[2, n, WIDTH] float32 at mean 100 on the quarter grid."""
    rng = np.random.default_rng(seed)
    k = rng.choice([-2, -1, 0, 1, 2], size=(2, n, WIDTH),
                   p=[0.02, 0.05, 0.86, 0.05, 0.02])
    return (100.0 + k / 4.0).astype(np.float32)


def _plain(tree):
    return {k: _plain(v) if hasattr(v, "items") else np.asarray(v)
            for k, v in tree.items()}


def _modules():
    """(name, reference module, port module, its inputs, its LayerNorm
    sites): the reference's and the port's modules share the sites'
    names."""
    x = _rows(0, 8)
    ctx = np.random.default_rng(1).standard_normal((2, 5, 16)).astype(
        np.float32)
    causal = np.tril(np.ones((8, 8), bool))[None, None]
    kw = dict(vocab_size=512, max_length=8, width=WIDTH, layers=1, heads=2,
              dtype="float32")
    return [
        ("transformer_block", jcommon.TransformerBlock(2, 32, jnp.float32),
         common.TransformerBlock(WIDTH, 2, 32, 16, torch.float32), (x, ctx),
         ("LayerNorm_0", "LayerNorm_1", "LayerNorm_2")),
        ("text_encoder_layer",
         jtext._EncoderLayer(jtext.TextEncoderConfig(**kw)),
         text_encoder._EncoderLayer(text_encoder.TextEncoderConfig(**kw)),
         (x, causal), ("LayerNorm_0", "LayerNorm_1")),
        ("prior_block", jprior.PriorBlock(2, 32, jnp.float32),
         prior.PriorBlock(WIDTH, 2, torch.float32), (x,),
         ("norm1", "norm3")),
    ]


def _sites(case, torch_layernorm: bool = False):
    """Per LayerNorm site of the module: the reference's flax LayerNorm
    and the port's on the large-mean rows, with the site's parameters
    drawn at random in the reference's tree and bridged into the port's
    module. `torch_layernorm` runs torch's nn.LayerNorm with the same
    parameters in the port's place."""
    _, jmod, tmod, args, names = case
    variables = jmod.init(jax.random.PRNGKey(0), *map(jnp.asarray, args))
    tree = _plain(dict(variables["params"]))
    rng = np.random.default_rng(2)
    for name in names:
        tree[name] = {"scale": (1 + 0.2 * rng.standard_normal(WIDTH))
                      .astype(np.float32),
                      "bias": (0.1 * rng.standard_normal(WIDTH))
                      .astype(np.float32)}
    tmod.load_state_dict(params_from_jax(tree))
    rows = args[0]
    out = []
    for i, name in enumerate(names):
        x = rows + np.float32(i / 4)     # each site its own mean
        want = np.asarray(fnn.LayerNorm(epsilon=1e-5, dtype=jnp.float32)
                          .apply({"params": tree[name]}, jnp.asarray(x)))
        site = getattr(tmod, name)
        assert isinstance(site, common.LayerNorm32), name
        if torch_layernorm:
            ln = torch.nn.LayerNorm(WIDTH, eps=site.eps)
            ln.load_state_dict(site.state_dict())
            site = ln
        with torch.no_grad():
            got = site(torch.from_numpy(x)).numpy()
        out.append((name, got, want))
    return out


def _rel(got, want) -> float:
    """The largest difference relative to the output's magnitude (the
    ones that remain are of one float32 ulp: XLA's rsqrt and torch's
    round differently now and then)."""
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("case", _modules(), ids=lambda c: c[0])
def test_large_mean_rows_match_reference(case):
    for name, got, want in _sites(case):
        print(f"{case[0]}.{name}: largest relative difference "
              f"{_rel(got, want):.2e}")
        assert _rel(got, want) <= RTOL


@pytest.mark.parametrize("case", _modules(), ids=lambda c: c[0])
def test_torch_two_pass_layernorm_misses_reference(case):
    """The same comparison with torch's nn.LayerNorm in the port's
    place fails by far more than the tolerance."""
    for name, got, want in _sites(case, torch_layernorm=True):
        print(f"{case[0]}.{name} with nn.LayerNorm: largest relative "
              f"difference {_rel(got, want):.2e}")
        assert _rel(got, want) > 100 * RTOL


def test_every_port_layernorm_is_layernorm32():
    """No module of the port's model families keeps torch's LayerNorm."""
    from arbius_tpu_torch.models.kandinsky2 import pipeline as k2
    from arbius_tpu_torch.models.sd15 import pipeline as sd15
    from arbius_tpu_torch.models.video import pipeline as video

    for models in (sd15.SD15Models(sd15.SD15Config.tiny(), "cpu"),
                   k2.Kandinsky2Models(k2.Kandinsky2Config.tiny(), "cpu"),
                   video.Text2VideoModels(video.Text2VideoConfig.tiny(),
                                          "cpu")):
        kinds = {type(m) for m in models.modules()}
        assert torch.nn.LayerNorm not in kinds
        assert common.LayerNorm32 in kinds


def test_layernorm32_is_flax_arithmetic():
    """Constant rows normalise to the bias exactly; rows of any dtype come
    back in float32; the parameters keep nn.LayerNorm's names."""
    ln = common.LayerNorm32(WIDTH)
    with torch.no_grad():
        ln.bias.copy_(torch.linspace(-1, 1, WIDTH))
        ln.weight.copy_(torch.linspace(0.5, 2, WIDTH))
    x = torch.full((3, WIDTH), 100.25, dtype=torch.bfloat16)
    y = ln(x)
    assert y.dtype == torch.float32
    torch.testing.assert_close(y, ln.bias.expand(3, -1), rtol=0, atol=0)
    assert set(ln.state_dict()) == {"weight", "bias"}
