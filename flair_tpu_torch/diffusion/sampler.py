"""FLAIR guided sampler as a Python loop over steps.

Counterpart of ``flair_tpu/diffusion/sampler.py`` (reference
guided_diffusion/gaussian_diffusion.py:372-689). Per step (:423-517):

  1. denoise:      x0 = p_mean_variance(model(x, t))
  2. data consist: x0 ← x0 − γ_t · restore_fn(x0), clip
  3. (face prior:  not in this package yet; ``p_sample`` has no face hook)
  4. pin overlap:  first OVERLAP frames ← prev_recon
  5. update:       ddpm (FLAIR's ρ rule) or η-DDIM

The JAX package's ``guided_sample_loop`` (one ``lax.scan`` program) and its
``make_guided_update`` two-program split are XLA dispatch forms; here both
are this one loop, ``guided_sample_steps``. Noise comes from a
``torch.Generator`` or an injected ``noise_fn(shape)``, so tests can feed
the port and the JAX package the same numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .gaussian import Diffusion, extract, p_mean_variance, predict_eps_from_xstart


def compute_ws(num_timesteps: int, w: float, tau: int, start_timestep: int,
               use_aux: bool) -> np.ndarray:
    """Per-step GAN-fusion weight schedule (gaussian_diffusion.py:632-646)."""
    if not use_aux:
        return np.ones(num_timesteps, dtype=np.float64)
    if start_timestep - tau > 0:
        ws = np.linspace(0, 1, start_timestep - tau + 1)
        ws = 1.0 * np.exp(-ws * 1)
        ws = (ws - ws.min()) / (ws.max() - ws.min()) * (1 - w)
        ws = 1 - ws
        ws = np.append(ws, np.ones(num_timesteps - start_timestep - 1))
        ws = np.concatenate([np.ones(tau), ws])
    else:
        ws = np.ones(num_timesteps) * w
    return ws


def compute_gammas(betas, sqrt_alphas_cumprod, sqrt_one_minus_alphas_cumprod,
                   zeta: float, noise_level: float) -> np.ndarray:
    """ζ-scaled SNR-dependent data-consistency step sizes
    (gaussian_diffusion.py:648-657). ζ = -1 disables the schedule."""
    if zeta == -1:
        return np.ones_like(betas)
    gammas = zeta * (noise_level ** 2
                     / (sqrt_one_minus_alphas_cumprod / sqrt_alphas_cumprod) ** 2)
    gammas = np.asarray(gammas, dtype=np.float64).copy()
    gammas[gammas >= 1] = 0.991
    gammas[gammas <= 1e-1] = 1e-6
    return 1 - gammas


@dataclasses.dataclass(frozen=True)
class GuidanceConfig:
    """Static guidance hyper-parameters (scripts/video_sample.py:265-308)."""

    w: float = 0.5
    tau: int = 5
    rho: float = 0.35
    noise_level: float = 12.75
    zeta: float = -1.0
    t_start: int = -1          # -1 → start from T-1
    clip_denoised: bool = True
    use_aux: bool = True       # GAN face prior enabled


def guidance_tables(d: Diffusion, cfg: GuidanceConfig):
    """Host-side (indices, ws, gammas, start_timestep)."""
    T = d.num_timesteps
    t_hi = T - 1 if cfg.t_start == -1 else cfg.t_start
    if not (0 <= t_hi < T):
        raise ValueError("t_start must be in [0, num_timesteps)")
    indices = np.arange(t_hi, -1, -1, dtype=np.int64)
    start_timestep = int(indices[0])
    ws = compute_ws(T, cfg.w, cfg.tau, start_timestep, cfg.use_aux)
    gammas = compute_gammas(
        d.betas.cpu().numpy(),
        d.sqrt_alphas_cumprod.cpu().numpy().astype(np.float64),
        d.sqrt_one_minus_alphas_cumprod.cpu().numpy().astype(np.float64),
        cfg.zeta, cfg.noise_level)
    return indices, ws.astype(np.float32), gammas.astype(np.float32), start_timestep


def p_sample(d: Diffusion, model_out, x, t: int, z, *, gamma_t: float,
             rho: float, clip_denoised: bool = True,
             restore_fn: Optional[Callable] = None, pin_mask=None,
             pin_values=None, rule: str = "ddpm", eta: float = 0.0):
    """One guided reverse step given the raw model output and pre-drawn
    gaussian noise ``z`` (gaussian_diffusion.py:423-517). ``t`` is the
    shared spaced step. Returns (sample, pred_xstart).

    - ``"ddpm"``: FLAIR's ρ-interpolated update
      x_{t−1} = √ᾱ′·x0 + 1[t≠0]·√(1−ᾱ′)·(√(1−ρ)·ε̂ + √ρ·z).
    - ``"ddim"``: Song et al. η-DDIM; σ = η·√((1−ᾱ′)/(1−ᾱ))·√(1−ᾱ/ᾱ′);
      x_{t−1} = √ᾱ′·x0 + 1[t≠0]·(√(1−ᾱ′−σ²)·ε̂ + σ·z). ``rho`` is ignored.
    """
    nd = x.dim()
    tb = torch.full((x.shape[0],), int(t), dtype=torch.int64, device=x.device)
    x0 = p_mean_variance(d, model_out, x, tb, clip_denoised)["pred_xstart"]
    if restore_fn is not None:
        x0 = x0 - gamma_t * restore_fn(x0)
        if clip_denoised:
            x0 = x0.clamp(-1, 1)
    if pin_mask is not None:
        x0 = torch.where(pin_mask, pin_values, x0)
    eps = predict_eps_from_xstart(d, x, tb, x0)
    nonzero = (tb != 0).to(x.dtype).reshape((-1,) + (1,) * (nd - 1))
    if rule == "ddpm":
        co_noise = extract(d.sqrt_one_minus_alphas_cumprod_prev, tb, nd)
        sample = extract(d.sqrt_alphas_cumprod_prev, tb, nd) * x0 + nonzero * (
            np.sqrt(1 - rho) * co_noise * eps + np.sqrt(rho) * co_noise * z)
    elif rule == "ddim":
        alpha_bar = extract(d.alphas_cumprod, tb, nd)
        alpha_bar_prev = extract(d.alphas_cumprod_prev, tb, nd)
        sigma = (eta * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
                 * torch.sqrt(1 - alpha_bar / alpha_bar_prev))
        sample = torch.sqrt(alpha_bar_prev) * x0 + nonzero * (
            torch.sqrt(torch.clamp(1 - alpha_bar_prev - sigma ** 2, min=0.0))
            * eps + sigma * z)
    else:
        raise ValueError(f"unknown update rule: {rule!r}")
    return sample, x0


def make_guided_update(d: Diffusion, cfg: GuidanceConfig, *, restore_fn=None,
                       rule: str = "ddpm", eta: float = 0.0):
    """The guidance half of a step, with the ws/γ tables bound:
    ``update(x, model_out, t, z, pin_mask=None, pin_values=None,
    restore_args=()) -> sample``; ``restore_fn(x0, *restore_args)``."""
    _, _, gammas, _ = guidance_tables(d, cfg)

    def update(x, model_out, t, z, pin_mask=None, pin_values=None,
               restore_args=()):
        rfn = None
        if restore_fn is not None:
            rfn = lambda x0: restore_fn(x0, *restore_args)  # noqa: E731
        sample, _ = p_sample(
            d, model_out, x, t, z, gamma_t=float(gammas[t]), rho=cfg.rho,
            clip_denoised=cfg.clip_denoised, restore_fn=rfn,
            pin_mask=pin_mask, pin_values=pin_values, rule=rule, eta=eta)
        return sample

    return update


def draw_noise(shape, like: torch.Tensor, generator=None, noise_fn=None):
    """Gaussian noise of ``shape`` on ``like``'s device and dtype: from
    ``noise_fn(shape)`` when given, else from ``generator``."""
    if noise_fn is not None:
        return torch.as_tensor(noise_fn(tuple(shape)), dtype=like.dtype,
                               device=like.device)
    return torch.randn(tuple(shape), generator=generator, dtype=like.dtype,
                       device=like.device)


def guided_sample_steps(d: Diffusion, model_fn, noise, cfg: GuidanceConfig,
                        *, restore_fn=None, pin_mask=None, pin_values=None,
                        update=None, restore_args=(), rule: str = "ddpm",
                        eta: float = 0.0, generator=None,
                        noise_fn=None) -> torch.Tensor:
    """The guided sampler: one model call and one update per step, from
    ``noise`` (x_T) down to t=0. ``model_fn(x, t)`` gets the spaced step.
    Pass ``update`` (from :func:`make_guided_update`) to share one across
    windows; otherwise one is built from ``restore_fn(x0)``."""
    indices, _, _, _ = guidance_tables(d, cfg)
    if update is None:
        rfn = None if restore_fn is None else (lambda x0, *a: restore_fn(x0))
        update = make_guided_update(d, cfg, restore_fn=rfn, rule=rule, eta=eta)
    x = noise
    for t in indices.tolist():
        z = draw_noise(x.shape, x, generator, noise_fn)
        model_out = model_fn(x, t)
        x = update(x, model_out, t, z, pin_mask, pin_values, restore_args)
    return x
