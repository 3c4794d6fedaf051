"""The six deterministic samplers the anythingv3 template declares, on
torch tensors.

Twin of arbius_tpu/schedulers/samplers.py. The per-step tables are the
same float64 numpy math cast to float32 (the tests hold them equal to the
reference's); `step` reads its coefficients from those tables as Python
floats (exact float32 values) and runs a few elementwise torch ops on the
latents, on whatever device they live on. The reference's scan carries
become plain tuples, and its `jnp.where` on the step index becomes a
Python branch, since the loop over steps runs in Python here.

Ancestral noise is supplied by the caller (derived from the task seed via
`fold_in`, see arbius_tpu_torch/random.py), keeping sampling
bit-reproducible for a given task id.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from arbius_tpu_torch.schedulers.diffusion import (
    NUM_TRAIN_TIMESTEPS,
    alphas_cumprod,
    karras_style_sigmas,
    leading_timesteps,
    linspace_timesteps,
)

__all__ = ["get_sampler", "SAMPLER_NAMES", "Sampler"]


class Sampler:
    """Uniform sampler interface consumed by the pipeline.

    Attributes:
      num_model_calls: number of model evaluations.
      timesteps: f32[num_model_calls] conditioning value per call.
      input_scale: f32[num_model_calls] multiplier applied to x before the
        model (sigma-space samplers divide by sqrt(sigma^2+1)).
      init_noise_sigma: float; initial latent noise multiplier.
      needs_noise: whether `step` consumes fresh noise (ancestral only).
    """

    name: str = ""
    needs_noise: bool = False
    init_noise_sigma: float = 1.0

    def init_carry(self, x: torch.Tensor) -> tuple:
        return ()

    def step(self, i: int, x, eps, carry, noise):
        raise NotImplementedError


def _f32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


def _weighted(weights: np.ndarray, tensors) -> torch.Tensor:
    """sum_j weights[j] * tensors[j] (the reference's tensordot)."""
    out = float(weights[0]) * tensors[0]
    for w, t in zip(weights[1:], tensors[1:]):
        out = out + float(w) * t
    return out


class DDIMSampler(Sampler):
    """DDIM, eta=0: x' = c_x[i]*x + c_e[i]*eps (pure deterministic ODE step).

    Leading timestep spacing with offset 1; final step targets
    alphas_cumprod[0] (set_alpha_to_one=False convention for SD).
    """

    name = "DDIM"

    def __init__(self, num_steps: int):
        acp = alphas_cumprod()
        ts = leading_timesteps(num_steps)
        ratio = NUM_TRAIN_TIMESTEPS // num_steps
        acp_t = acp[ts]
        prev = ts - ratio
        acp_p = np.where(prev >= 0, acp[np.clip(prev, 0, None)], acp[0])
        a_t, s_t = np.sqrt(acp_t), np.sqrt(1 - acp_t)
        a_p, s_p = np.sqrt(acp_p), np.sqrt(1 - acp_p)
        self.num_model_calls = num_steps
        self.timesteps = _f32(ts)
        self.input_scale = _f32(np.ones(num_steps))
        self._c_x = _f32(a_p / a_t)
        self._c_e = _f32(s_p - a_p * s_t / a_t)

    def step(self, i, x, eps, carry, noise):
        return float(self._c_x[i]) * x + float(self._c_e[i]) * eps, carry


class EulerSampler(Sampler):
    """K_EULER — Euler method on the sigma-space probability-flow ODE."""

    name = "K_EULER"

    def __init__(self, num_steps: int):
        acp = alphas_cumprod()
        ts = linspace_timesteps(num_steps)
        sig = np.concatenate([karras_style_sigmas(ts, acp), [0.0]])
        self.num_model_calls = num_steps
        self.timesteps = _f32(ts)
        self.input_scale = _f32(1.0 / np.sqrt(sig[:-1] ** 2 + 1))
        self._dsigma = _f32(sig[1:] - sig[:-1])
        self.init_noise_sigma = float(sig[0])

    def step(self, i, x, eps, carry, noise):
        # d = (x - (x - sigma*eps)) / sigma = eps
        return x + float(self._dsigma[i]) * eps, carry


class EulerAncestralSampler(Sampler):
    """K_EULER_ANCESTRAL — Euler step to sigma_down plus fresh noise*sigma_up.

    Noise comes from the caller (seeded per task+step), keeping the sampler
    bit-deterministic for a given task id.
    """

    name = "K_EULER_ANCESTRAL"
    needs_noise = True

    def __init__(self, num_steps: int):
        acp = alphas_cumprod()
        ts = linspace_timesteps(num_steps)
        sig = np.concatenate([karras_style_sigmas(ts, acp), [0.0]])
        s, sn = sig[:-1], sig[1:]
        with np.errstate(divide="ignore", invalid="ignore"):
            sig_up = np.sqrt(np.maximum(sn**2 * (s**2 - sn**2) / s**2, 0.0))
        sig_down = np.sqrt(np.maximum(sn**2 - sig_up**2, 0.0))
        self.num_model_calls = num_steps
        self.timesteps = _f32(ts)
        self.input_scale = _f32(1.0 / np.sqrt(s**2 + 1))
        self._dsigma = _f32(sig_down - s)
        self._sig_up = _f32(sig_up)
        self.init_noise_sigma = float(sig[0])

    def step(self, i, x, eps, carry, noise):
        return (x + float(self._dsigma[i]) * eps
                + float(self._sig_up[i]) * noise), carry


class LMSSampler(Sampler):
    """KLMS — 4th-order linear multistep over the sigma-space ODE.

    Adams-Bashforth-style coefficients: integrals of the Lagrange basis over
    each [sigma_i, sigma_{i+1}] interval, computed host-side on a fixed
    Simpson grid (deterministic, no adaptive quadrature).
    """

    name = "KLMS"
    ORDER = 4

    def __init__(self, num_steps: int):
        acp = alphas_cumprod()
        ts = linspace_timesteps(num_steps)
        sig = np.concatenate([karras_style_sigmas(ts, acp), [0.0]])
        coeffs = np.zeros((num_steps, self.ORDER), dtype=np.float64)
        for i in range(num_steps):
            order = min(i + 1, self.ORDER)
            for j in range(order):
                coeffs[i, j] = self._lms_coeff(sig, i, j, order)
        self.num_model_calls = num_steps
        self.timesteps = _f32(ts)
        self.input_scale = _f32(1.0 / np.sqrt(sig[:-1] ** 2 + 1))
        self._coeffs = _f32(coeffs)
        self.init_noise_sigma = float(sig[0])

    @staticmethod
    def _lms_coeff(sig: np.ndarray, i: int, j: int, order: int) -> float:
        # integral over [sig[i], sig[i+1]] of prod_{k!=j} (s - sig[i-k]) /
        # (sig[i-j] - sig[i-k]); fixed 4096-interval Simpson rule.
        n = 4096
        s = np.linspace(sig[i], sig[i + 1], n + 1)
        prod = np.ones_like(s)
        for k in range(order):
            if k == j:
                continue
            prod *= (s - sig[i - k]) / (sig[i - j] - sig[i - k])
        w = np.ones(n + 1)
        w[1:-1:2], w[2:-1:2] = 4.0, 2.0
        h = (sig[i + 1] - sig[i]) / n
        return float(h / 3.0 * np.sum(w * prod))

    def init_carry(self, x):
        return ((torch.zeros_like(x),) * self.ORDER,)

    def step(self, i, x, eps, carry, noise):
        (hist,) = carry
        # recent-first derivative history; d = eps in sigma space
        hist = (eps,) + hist[:-1]
        return x + _weighted(self._coeffs[i], hist), (hist,)


class DPMSolverMultistepSampler(Sampler):
    """DPMSolverMultistep — DPM-Solver++(2M), epsilon-pred, midpoint rule.

    Second-order multistep in lambda = log(alpha/sigma) space; first-order
    (=DDIM-like) on the first call and, matching common practice, on the
    final call when num_steps < 15.
    """

    name = "DPMSolverMultistep"

    def __init__(self, num_steps: int):
        acp = alphas_cumprod()
        ts = np.linspace(0, NUM_TRAIN_TIMESTEPS - 1,
                         num_steps + 1).round()[::-1][:-1].astype(np.int64)
        # boundary target after the last call: t=0
        t_all = np.concatenate([ts, [0]])
        acp_all = acp[t_all]
        alpha = np.sqrt(acp_all)
        sigma = np.sqrt(1 - acp_all)
        lam = np.log(alpha / sigma)
        h = lam[1:] - lam[:-1]                       # [S] per-call step in lambda
        self.num_model_calls = num_steps
        self.timesteps = _f32(ts)
        self.input_scale = _f32(np.ones(num_steps))
        # x0 prediction: x0 = inv_alpha[i]*x - sig_ratio[i]*eps
        self._inv_alpha = _f32(1.0 / alpha[:-1])
        self._sig_over_alpha = _f32(sigma[:-1] / alpha[:-1])
        self._xcoef = _f32(sigma[1:] / sigma[:-1])   # (sigma_t / sigma_s0)
        self._d0coef = _f32(-alpha[1:] * (np.exp(-h) - 1.0))
        with np.errstate(divide="ignore", invalid="ignore"):
            r0 = np.concatenate([[1.0], (lam[1:-1] - lam[:-2]) / h[1:]])
        self._inv_2r0 = _f32(np.where(np.isfinite(r0), 0.5 / r0, 0.0))
        second = np.ones(num_steps, dtype=bool)
        second[0] = False
        if num_steps < 15:
            second[-1] = False
        self._second = second

    def init_carry(self, x):
        return (torch.zeros_like(x),)

    def step(self, i, x, eps, carry, noise):
        (m_prev,) = carry
        m0 = float(self._inv_alpha[i]) * x - float(self._sig_over_alpha[i]) * eps
        d = m0
        if self._second[i]:
            d = m0 + (m0 - m_prev) * float(self._inv_2r0[i])
        x_next = float(self._xcoef[i]) * x + float(self._d0coef[i]) * d
        return x_next, (m0,)


class PNDMSampler(Sampler):
    """PNDM (PLMS path, skip_prk_steps) — pseudo linear multistep.

    Call sequence duplicates the second timestep (S+1 model calls for S
    steps): call 1 refines call 0's step via a trapezoid correction applied
    from the SAVED pre-step sample. History weights and the transfer
    coefficients of the underlying DDIM-like update are all precomputed.
    """

    name = "PNDM"
    ORDER = 3  # history slots used in addition to the current eps

    def __init__(self, num_steps: int):
        acp = alphas_cumprod()
        ratio = NUM_TRAIN_TIMESTEPS // num_steps
        ts = leading_timesteps(num_steps)  # descending [T0..T_{S-1}]
        # model-call timesteps: [T0, T1, T1, T2, ..., T_{S-1}]
        call_ts = np.concatenate([ts[:1], ts[1:2], ts[1:]])
        # per-call (from, to) pairs
        pair_from = np.concatenate([ts[:1], ts[:1], ts[1:]])
        pair_to = pair_from - ratio
        acp_t = acp[pair_from]
        acp_p = np.where(pair_to >= 0, acp[np.clip(pair_to, 0, None)], acp[0])
        self._sc = _f32(np.sqrt(acp_p / acp_t))
        denom = acp_t * np.sqrt(1 - acp_p) + np.sqrt(acp_t * (1 - acp_t) * acp_p)
        self._dc = _f32(-(acp_p - acp_t) / denom)
        calls = num_steps + 1
        w_cur = np.zeros(calls)
        w_hist = np.zeros((calls, self.ORDER))
        for i in range(calls):
            if i == 0:
                w_cur[i] = 1.0
            elif i == 1:
                w_cur[i], w_hist[i, 0] = 0.5, 0.5
            elif i == 2:
                w_cur[i], w_hist[i, 0] = 1.5, -0.5
            elif i == 3:
                w_cur[i], w_hist[i, :2] = 23 / 12, (-16 / 12, 5 / 12)
            else:
                w_cur[i], w_hist[i, :3] = 55 / 24, (-59 / 24, 37 / 24, -9 / 24)
        self.num_model_calls = calls
        self.timesteps = _f32(call_ts)
        self.input_scale = _f32(np.ones(calls))
        self._w_cur = _f32(w_cur)
        self._w_hist = _f32(w_hist)

    def init_carry(self, x):
        return ((torch.zeros_like(x),) * self.ORDER, torch.zeros_like(x))

    def step(self, i, x, eps, carry, noise):
        hist, cur_sample = carry
        e_prime = float(self._w_cur[i]) * eps + _weighted(self._w_hist[i], hist)
        x_from = cur_sample if i == 1 else x
        x_next = float(self._sc[i]) * x_from + float(self._dc[i]) * e_prime
        # append eps to history except on the trapezoid-refinement call
        if i != 1:
            hist = (eps,) + hist[:-1]
        if i == 0:
            cur_sample = x
        return x_next, (hist, cur_sample)


_REGISTRY = {
    "DDIM": DDIMSampler,
    "K_EULER": EulerSampler,
    "K_EULER_ANCESTRAL": EulerAncestralSampler,
    "DPMSolverMultistep": DPMSolverMultistepSampler,
    "PNDM": PNDMSampler,
    "KLMS": LMSSampler,
}

SAMPLER_NAMES = tuple(_REGISTRY)


@functools.lru_cache(maxsize=64)
def get_sampler(name: str, num_steps: int) -> Sampler:
    """Sampler instance cache — static tables are reused across tasks."""
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown scheduler {name!r}; expected one of {SAMPLER_NAMES}")
    if num_steps < 1 or num_steps > NUM_TRAIN_TIMESTEPS:
        raise ValueError(f"num_steps must be in [1, {NUM_TRAIN_TIMESTEPS}]")
    return cls(num_steps)
