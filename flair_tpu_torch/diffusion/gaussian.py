"""Gaussian diffusion core: q/p distributions and eps↔x0 conversions.

Counterpart of ``flair_tpu/diffusion/gaussian.py`` (the reference
``GaussianDiffusion``, guided_diffusion/gaussian_diffusion.py:95-370). The
``Diffusion`` container holds float32 tables on one device, derived on the
host in float64 by ``schedules.compute_tables``.

Timesteps ``t`` are a Python int (all batch elements share the step, as in
the sampler loop) or an int64 tensor of shape (B,).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.device import resolve_device
from .schedules import (
    LossType,
    ModelMeanType,
    ModelVarType,
    compute_tables,
    get_named_beta_schedule,
    respace_betas,
    space_timesteps,
)

_TABLE_FIELDS = (
    "betas",
    "alphas_cumprod",
    "alphas_cumprod_prev",
    "sqrt_alphas_cumprod",
    "sqrt_alphas_cumprod_prev",
    "sqrt_one_minus_alphas_cumprod",
    "sqrt_one_minus_alphas_cumprod_prev",
    "log_one_minus_alphas_cumprod",
    "sqrt_recip_alphas_cumprod",
    "sqrt_recipm1_alphas_cumprod",
    "posterior_variance",
    "posterior_log_variance_clipped",
    "posterior_mean_coef1",
    "posterior_mean_coef2",
    "log_betas",
)


@dataclasses.dataclass(frozen=True)
class Diffusion:
    """Per-timestep float32 tables (possibly respaced) plus static config.

    ``timestep_map`` maps spaced indices → original indices
    (respace.py:90-101); ``original_num_steps`` is the length of the base
    schedule. ``sqrt_alphas_cumprod_prev`` has length T+1."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_alphas_cumprod_prev: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod_prev: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    log_betas: torch.Tensor
    timestep_map: torch.Tensor
    num_timesteps: int
    original_num_steps: int
    model_mean_type: ModelMeanType
    model_var_type: ModelVarType
    loss_type: LossType
    rescale_timesteps: bool

    @property
    def device(self) -> torch.device:
        return self.betas.device


def make_diffusion(
    betas: np.ndarray,
    *,
    model_mean_type: ModelMeanType = ModelMeanType.EPSILON,
    model_var_type: ModelVarType = ModelVarType.FIXED_SMALL,
    loss_type: LossType = LossType.MSE,
    rescale_timesteps: bool = False,
    use_timesteps=None,
    device=None,
) -> Diffusion:
    """A (possibly respaced) Diffusion from a base float64 beta schedule
    (GaussianDiffusion.__init__ composed with SpacedDiffusion.__init__)."""
    dev = resolve_device(device)
    betas = np.asarray(betas, dtype=np.float64)
    original_num_steps = len(betas)
    if use_timesteps is not None:
        betas, timestep_map = respace_betas(betas, use_timesteps)
    else:
        timestep_map = np.arange(len(betas), dtype=np.int32)
    tables = compute_tables(betas)
    to_dev = {f: torch.as_tensor(getattr(tables, f), dtype=torch.float32,
                                 device=dev) for f in _TABLE_FIELDS}
    return Diffusion(
        **to_dev,
        timestep_map=torch.as_tensor(timestep_map, dtype=torch.int64,
                                     device=dev),
        num_timesteps=tables.num_timesteps,
        original_num_steps=original_num_steps,
        model_mean_type=model_mean_type,
        model_var_type=model_var_type,
        loss_type=loss_type,
        rescale_timesteps=rescale_timesteps,
    )


def make_task_diffusion(task: str, steps: str = "100", device=None) -> Diffusion:
    """Per-task SpacedDiffusion factory matching the demo CLI
    (scripts/video_sample.py:35-68, 311-325)."""
    schedule_name, diffusion_steps, var_type, loss_type = {
        "x8_bicubic": ("face_bicubic", 2000, ModelVarType.FIXED_SMALL, LossType.MSE),
        "x16_bicubic": ("face_bicubic", 2000, ModelVarType.FIXED_SMALL, LossType.MSE),
        "gaussian": ("face_blur", 1000, ModelVarType.LEARNED_RANGE, LossType.RESCALED_MSE),
        "jpeg": ("face_blur", 1000, ModelVarType.LEARNED_RANGE, LossType.RESCALED_MSE),
    }[task]
    return make_diffusion(
        get_named_beta_schedule(schedule_name, diffusion_steps),
        model_mean_type=ModelMeanType.EPSILON,
        model_var_type=var_type,
        loss_type=loss_type,
        rescale_timesteps=False,
        use_timesteps=space_timesteps(diffusion_steps, steps, "uniform"),
        device=device,
    )


def _index(arr: torch.Tensor, t) -> torch.Tensor:
    return arr[torch.as_tensor(t, dtype=torch.int64, device=arr.device)]


def extract(arr: torch.Tensor, t, ndim: int) -> torch.Tensor:
    """Per-timestep scalars reshaped to broadcast against an ndim-dimensional
    batch (gaussian_diffusion.py:692-705)."""
    out = _index(arr, t).float()
    return out.reshape(out.shape + (1,) * (ndim - out.dim()))


def q_mean_variance(d: Diffusion, x_start, t):
    """q(x_t | x_0) moments (gaussian_diffusion.py:189-204)."""
    nd = x_start.dim()
    mean = extract(d.sqrt_alphas_cumprod, t, nd) * x_start
    variance = extract(1.0 - d.alphas_cumprod, t, nd)
    log_variance = extract(d.log_one_minus_alphas_cumprod, t, nd)
    return mean, variance, log_variance


def q_sample(d: Diffusion, x_start, t, noise):
    """Sample q(x_t | x_0) (gaussian_diffusion.py:206-224)."""
    nd = x_start.dim()
    return (extract(d.sqrt_alphas_cumprod, t, nd) * x_start
            + extract(d.sqrt_one_minus_alphas_cumprod, t, nd) * noise)


def q_posterior_mean_variance(d: Diffusion, x_start, x_t, t):
    """q(x_{t-1} | x_t, x_0) moments (gaussian_diffusion.py:226-248)."""
    nd = x_t.dim()
    mean = (extract(d.posterior_mean_coef1, t, nd) * x_start
            + extract(d.posterior_mean_coef2, t, nd) * x_t)
    return (mean, extract(d.posterior_variance, t, nd),
            extract(d.posterior_log_variance_clipped, t, nd))


def predict_xstart_from_eps(d: Diffusion, x_t, t, eps):
    """(gaussian_diffusion.py:344-349)"""
    nd = x_t.dim()
    return (extract(d.sqrt_recip_alphas_cumprod, t, nd) * x_t
            - extract(d.sqrt_recipm1_alphas_cumprod, t, nd) * eps)


def predict_eps_from_xstart(d: Diffusion, x_t, t, pred_xstart):
    """(gaussian_diffusion.py:361-365)"""
    nd = x_t.dim()
    return ((extract(d.sqrt_recip_alphas_cumprod, t, nd) * x_t - pred_xstart)
            / extract(d.sqrt_recipm1_alphas_cumprod, t, nd))


def sr3_noise_level(d: Diffusion, t) -> torch.Tensor:
    """SR3 continuous noise-level conditioning: the respaced
    ``sqrt_alphas_cumprod_prev[t + 1]`` (respace.py:161-165)."""
    return _index(d.sqrt_alphas_cumprod_prev,
                  torch.as_tensor(t, dtype=torch.int64) + 1).float()


def map_timesteps(d: Diffusion, t) -> torch.Tensor:
    """Spaced index → original schedule index (respace.py:155-157)."""
    return _index(d.timestep_map, t)


def scale_timesteps(d: Diffusion, t) -> torch.Tensor:
    """Optional 0..1000 rescaling of ORIGINAL (mapped) indices
    (gaussian_diffusion.py:367-370, respace.py:158-159)."""
    t = torch.as_tensor(t)
    if d.rescale_timesteps:
        return t.float() * (1000.0 / d.original_num_steps)
    return t


def p_mean_variance(d: Diffusion, model_output, x, t,
                    clip_denoised: bool = True) -> dict:
    """Reverse-step moments from a raw denoiser output
    (gaussian_diffusion.py:250-342). Channels are the LAST axis (the
    pipeline keeps the JAX package's (B, T, H, W, C) layout); LEARNED /
    LEARNED_RANGE outputs carry 2·C channels."""
    nd = x.dim()
    c = x.shape[-1]
    if d.model_var_type in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE):
        assert model_output.shape[-1] == 2 * c, model_output.shape
        model_output, model_var_values = model_output.split(c, dim=-1)
        if d.model_var_type == ModelVarType.LEARNED:
            model_log_variance = model_var_values
        else:
            min_log = extract(d.posterior_log_variance_clipped, t, nd)
            max_log = extract(d.log_betas, t, nd)
            frac = (model_var_values + 1) / 2
            model_log_variance = frac * max_log + (1 - frac) * min_log
        model_variance = torch.exp(model_log_variance)
    else:
        if model_output.shape[-1] == 2 * c:
            model_output = model_output[..., :c]
        if d.model_var_type == ModelVarType.FIXED_LARGE:
            var_table = torch.cat([d.posterior_variance[1:2], d.betas[1:]])
            model_variance = extract(var_table, t, nd)
            model_log_variance = torch.log(model_variance)
        elif d.model_var_type == ModelVarType.FIXED_SMALL:
            model_variance = extract(d.posterior_variance, t, nd)
            model_log_variance = extract(d.posterior_log_variance_clipped, t, nd)
        else:
            raise NotImplementedError(d.model_var_type)

    def process_xstart(x0):
        return x0.clamp(-1, 1) if clip_denoised else x0

    if d.model_mean_type == ModelMeanType.PREVIOUS_X:
        coef1 = extract(1.0 / d.posterior_mean_coef1, t, nd)
        coef2 = extract(d.posterior_mean_coef2 / d.posterior_mean_coef1, t, nd)
        pred_xstart = process_xstart(coef1 * model_output - coef2 * x)
        model_mean = model_output
    elif d.model_mean_type in (ModelMeanType.START_X, ModelMeanType.EPSILON):
        if d.model_mean_type == ModelMeanType.START_X:
            pred_xstart = process_xstart(model_output)
        else:
            pred_xstart = process_xstart(
                predict_xstart_from_eps(d, x, t, model_output))
        model_mean, _, _ = q_posterior_mean_variance(d, pred_xstart, x, t)
    else:
        raise NotImplementedError(d.model_mean_type)
    return dict(mean=model_mean, variance=model_variance,
                log_variance=model_log_variance, pred_xstart=pred_xstart)
