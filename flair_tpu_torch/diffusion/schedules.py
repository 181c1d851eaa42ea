"""Beta schedules, coefficient tables, and timestep respacing.

The port's own copy of ``flair_tpu/diffusion/schedules.py`` (numpy only, so
the port imports nothing of the JAX package). All cumulative-product tables
are computed on the host in numpy float64 (as the reference does, see
``guided_diffusion/gaussian_diffusion.py:126-173``) and moved to the device
as float32 tensors by ``diffusion/gaussian.py``.

Reference parity:
- ``get_named_beta_schedule``  → gaussian_diffusion.py:15-36
- ``betas_for_alpha_bar``      → gaussian_diffusion.py:39-56
- coefficient tables           → gaussian_diffusion.py:126-173
- ``space_timesteps``          → respace.py:7-66
- respaced betas               → respace.py:93-102
"""

from __future__ import annotations

import dataclasses
import enum
import math

import numpy as np


class ModelMeanType(enum.Enum):
    """What the denoiser predicts (gaussian_diffusion.py:59-66)."""

    PREVIOUS_X = enum.auto()
    START_X = enum.auto()
    EPSILON = enum.auto()


class ModelVarType(enum.Enum):
    """How the reverse-process variance is produced (gaussian_diffusion.py:69-80)."""

    LEARNED = enum.auto()
    FIXED_SMALL = enum.auto()
    FIXED_LARGE = enum.auto()
    LEARNED_RANGE = enum.auto()


class LossType(enum.Enum):
    """Training loss selector (gaussian_diffusion.py:83-92)."""

    MSE = enum.auto()
    RESCALED_MSE = enum.auto()
    KL = enum.auto()
    RESCALED_KL = enum.auto()

    def is_vb(self) -> bool:
        return self in (LossType.KL, LossType.RESCALED_KL)


def get_named_beta_schedule(schedule_name: str, num_diffusion_timesteps: int) -> np.ndarray:
    """Named beta schedules (gaussian_diffusion.py:15-36).

    ``face_blur``    — Ho et al. linear schedule scaled to the step count.
    ``face_bicubic`` — linspace(1e-6, 1e-2, 2000); note the fixed 2000 length.
    """
    if schedule_name == "face_blur":
        scale = 1000 / num_diffusion_timesteps
        return np.linspace(
            scale * 0.0001, scale * 0.02, num_diffusion_timesteps, dtype=np.float64
        )
    if schedule_name == "face_bicubic":
        return np.linspace(1e-6, 1e-2, 2000, dtype=np.float64)
    if schedule_name == "linear":
        scale = 1000 / num_diffusion_timesteps
        return np.linspace(
            scale * 0.0001, scale * 0.02, num_diffusion_timesteps, dtype=np.float64
        )
    if schedule_name == "cosine":
        return betas_for_alpha_bar(
            num_diffusion_timesteps,
            lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2,
        )
    raise NotImplementedError(f"unknown beta schedule: {schedule_name}")


def betas_for_alpha_bar(num_diffusion_timesteps, alpha_bar, max_beta=0.999) -> np.ndarray:
    """Discretize a continuous alpha-bar function (gaussian_diffusion.py:39-56)."""
    betas = []
    for i in range(num_diffusion_timesteps):
        t1 = i / num_diffusion_timesteps
        t2 = (i + 1) / num_diffusion_timesteps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas, dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class ScheduleTables:
    """All per-timestep coefficient tables, float64 numpy on host.

    Mirrors gaussian_diffusion.py:126-173, including the non-standard
    length-(T+1) ``sqrt_alphas_cumprod_prev`` used both by the FLAIR update
    rule (gaussian_diffusion.py:511) and the SR3 continuous-noise-level
    conditioning (respace.py:161-165).
    """

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    alphas_cumprod_next: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_alphas_cumprod_prev: np.ndarray  # length T+1: sqrt(append(1, acp))
    sqrt_one_minus_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod_prev: np.ndarray  # length T: append(0, ...)
    log_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    log_betas: np.ndarray

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])


def compute_tables(betas: np.ndarray) -> ScheduleTables:
    """Derive every coefficient table in float64 (gaussian_diffusion.py:126-173)."""
    betas = np.asarray(betas, dtype=np.float64)
    assert betas.ndim == 1 and (betas > 0).all() and (betas <= 1).all()
    alphas = 1.0 - betas
    acp = np.cumprod(alphas, axis=0)
    acp_prev = np.append(1.0, acp[:-1])
    acp_next = np.append(acp[1:], 0.0)
    posterior_variance = betas * (1.0 - acp_prev) / (1.0 - acp)
    return ScheduleTables(
        betas=betas,
        alphas_cumprod=acp,
        alphas_cumprod_prev=acp_prev,
        alphas_cumprod_next=acp_next,
        sqrt_alphas_cumprod=np.sqrt(acp),
        sqrt_alphas_cumprod_prev=np.sqrt(np.append(1.0, acp)),
        sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - acp),
        sqrt_one_minus_alphas_cumprod_prev=np.append(0.0, np.sqrt(1.0 - acp[:-1])),
        log_one_minus_alphas_cumprod=np.log(1.0 - acp),
        sqrt_recip_alphas_cumprod=np.sqrt(1.0 / acp),
        sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / acp - 1),
        posterior_variance=posterior_variance,
        posterior_log_variance_clipped=np.log(
            np.append(posterior_variance[1], posterior_variance[1:])
        ),
        posterior_mean_coef1=betas * np.sqrt(acp_prev) / (1.0 - acp),
        posterior_mean_coef2=(1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp),
        log_betas=np.log(betas),
    )


def space_timesteps(num_timesteps: int, section_counts, mode: str = "uniform"):
    """Select a subset of timesteps to retain (respace.py:7-66).

    ``section_counts`` may be "100", "ddim25", a comma list, or a sequence.
    Returns a set (uniform) or list (quad) of original timestep indices.
    """
    if mode == "uniform":
        if isinstance(section_counts, str):
            if section_counts.startswith("ddim"):
                desired_count = int(section_counts[len("ddim"):])
                for i in range(1, num_timesteps):
                    if len(range(0, num_timesteps, i)) == desired_count:
                        return set(range(0, num_timesteps, i))
                raise ValueError(
                    f"cannot create exactly {desired_count} steps with an integer stride"
                )
            section_counts = [int(x) for x in section_counts.split(",")]
        size_per = num_timesteps // len(section_counts)
        extra = num_timesteps % len(section_counts)
        start_idx = 0
        all_steps = []
        for i, section_count in enumerate(section_counts):
            size = size_per + (1 if i < extra else 0)
            if size < section_count:
                raise ValueError(
                    f"cannot divide section of {size} steps into {section_count}"
                )
            frac_stride = 1 if section_count <= 1 else (size - 1) / (section_count - 1)
            cur_idx = 0.0
            taken_steps = []
            for _ in range(section_count):
                taken_steps.append(start_idx + round(cur_idx))
                cur_idx += frac_stride
            all_steps += taken_steps
            start_idx += size
        return set(all_steps)
    if mode == "quad":
        num_steps = int(section_counts)
        seq = np.linspace(0, np.sqrt(num_timesteps * 0.8), num_steps) ** 2
        return [int(s) for s in list(seq)]
    raise ValueError(f"unknown respacing mode: {mode}")


def respace_betas(betas: np.ndarray, use_timesteps) -> tuple[np.ndarray, np.ndarray]:
    """Recompute betas over the retained timestep subset (respace.py:93-102).

    Returns ``(new_betas, timestep_map)`` where ``timestep_map[i]`` is the
    original index of spaced step ``i``.
    """
    use = set(int(t) for t in use_timesteps)
    acp = compute_tables(betas).alphas_cumprod
    last_alpha_cumprod = 1.0
    new_betas, timestep_map = [], []
    for i, alpha_cumprod in enumerate(acp):
        if i in use:
            new_betas.append(1 - alpha_cumprod / last_alpha_cumprod)
            last_alpha_cumprod = alpha_cumprod
            timestep_map.append(i)
    return np.array(new_betas, dtype=np.float64), np.array(timestep_map, dtype=np.int32)
