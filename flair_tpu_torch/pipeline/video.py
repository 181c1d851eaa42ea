"""Windowed guided restoration of a face-video clip (face prior off).

Counterpart of ``flair_tpu/pipeline/video.py`` (demo driver
scripts/video_sample.py:265-497):
- clips run in sliding windows of FRAME_SLICE_LEN=10 frames with OVERLAP=3;
- each window starts from q_sample(init, T-1), init being the degraded
  input upscaled to the output size;
- the previous window's last OVERLAP reconstructed frames are pinned into
  pred_xstart at every step and dropped at stitch time;
- SPyNet flows are computed once per window;
- the gaussian/jpeg tasks condition SPyNet on the bicubic-upscaled degraded
  frames (video_sample.py:405-425) while the model input is the
  area-upscaled ``low_res``; their correction is PseudoSR's null-space
  step, with the JPEG round-trip for jpeg.

The window loop and the step loop are plain Python (the JAX package's
"steps" two-program dispatch and its scan forms collapse into one loop
here). The face prior and multi-device meshes are not in this package yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..diffusion.gaussian import Diffusion, make_task_diffusion, q_sample
from ..diffusion.sampler import (
    GuidanceConfig, draw_noise, guided_sample_steps, make_guided_update)
from ..operators.factory import BLUR_TASKS, get_operator, make_restore_fn_p
from ..ops.resize import resize_area, resize_bicubic
from ..utils.device import resolve_device

FRAME_SLICE_LEN = 10
OVERLAP = 3


@dataclasses.dataclass(frozen=True)
class TaskConfig:
    """Per-task demo configuration (scripts/video_sample.py:35-171,499-556)."""

    task: str
    model_name: str
    input_size: int
    output_size: int = 512
    init_mode: str = "bicubic"
    steps: str = "100"
    w: float = 1.0
    rho: float = 0.35
    noise_level: float = 0.0
    zeta: float = -1.0
    tau: int = 5
    t_start: int = -1
    jpeg_qf: int = -1
    vsrpp_bg_weight: float = -1.0


TASK_CONFIGS = {
    "x8_bicubic": TaskConfig(
        "x8_bicubic", "bicubic_unet", 64, init_mode="bicubic",
        w=0.85, rho=0.85, noise_level=0.0, vsrpp_bg_weight=0.93),
    "x16_bicubic": TaskConfig(
        "x16_bicubic", "bicubic_unet", 32, init_mode="bicubic",
        w=0.7, rho=0.85, noise_level=0.0, vsrpp_bg_weight=0.98),
    "gaussian": TaskConfig(
        "gaussian", "blur_unet", 128, init_mode="area",
        w=0.75, rho=0.25, noise_level=2.55, zeta=1.0),
    "jpeg": TaskConfig(
        "jpeg", "blur_unet", 128, init_mode="area",
        w=0.5, rho=0.5, noise_level=12.75, zeta=1.0, jpeg_qf=60),
}


def scale_tau(tau: int, num_timesteps: int) -> int:
    """Rescale a demo tau (in 100-step units) to a respaced schedule,
    keeping the same fraction of the trajectory in the face window."""
    if num_timesteps == 100:
        return tau
    return max(1, round(tau * num_timesteps / 100))


def window_slices(num_frames: int, win: int = FRAME_SLICE_LEN,
                  overlap: int = OVERLAP):
    """(start, length) of each sliding window, step win−overlap, with a
    SHORT tail window (video_sample.py:361-368)."""
    step = win - overlap
    out = []
    start = 0
    while True:
        length = min(win, num_frames - start)
        out.append((start, length))
        if start + length >= num_frames:
            break
        start += step
    return out


def init_from_degraded(frames01: torch.Tensor, cfg: TaskConfig) -> torch.Tensor:
    """Upscale degraded [0,1] frames (..., h, w, 3) to the output size and
    map to [-1, 1] (video_sample.py:372-377)."""
    size = (cfg.output_size, cfg.output_size)
    resize = resize_bicubic if cfg.init_mode == "bicubic" else resize_area
    return torch.clamp(resize(frames01, size), 0, 1) * 2.0 - 1.0


def rnn_input_for(frames01: torch.Tensor, init: torch.Tensor,
                  cfg: TaskConfig) -> torch.Tensor:
    """The clip SPyNet's flows are computed from: for gaussian/jpeg the
    bicubic upscale of the degraded [0,1] frames, in [-1, 1]
    (video_sample.py:405-425); for the other tasks the conditioning
    ``init`` itself (unet_new.py:1332-1333)."""
    if cfg.task not in BLUR_TASKS:
        return init
    size = (cfg.output_size, cfg.output_size)
    return torch.clamp(resize_bicubic(frames01, size) * 2.0 - 1.0, -1.0, 1.0)


@torch.no_grad()
def restore_video(
    degraded01: np.ndarray,
    cfg: TaskConfig,
    model_apply: Callable,
    *,
    diffusion: Optional[Diffusion] = None,
    guidance: Optional[GuidanceConfig] = None,
    win: int = FRAME_SLICE_LEN,
    overlap: int = OVERLAP,
    pad_tail: bool = True,
    sampler: str = "steps",
    eta: float = 0.0,
    device=None,
    generator: Optional[torch.Generator] = None,
    noise_fn: Optional[Callable] = None,
    face_fn=None,
    face_helper=None,
    codeformer_apply=None,
    parsenet_apply=None,
) -> np.ndarray:
    """Restore a clip window by window.

    ``degraded01``: (T, h, w, 3) in [0, 1], or (B, T, h, w, 3) for B
    independent clips batched through the same model calls. Returns
    (T, H, W, 3) — or (B, T, H, W, 3) — in [0, 1].
    ``model_apply(x, t, low_res, rnn_input, vsrpp_weights, flows)`` is the
    wrapped denoiser (``wrap_bicubic_model`` / ``wrap_blur_model``).
    ``sampler``: "steps" (FLAIR's ddpm ρ rule) or "ddim" (η-DDIM, for a
    respaced ``cfg.steps="ddimN"``).
    ``pad_tail`` repeats the last frame to fill a short tail window.
    Noise: ``noise_fn(shape)`` when given, else ``generator``. Runs on
    ``device`` (default cuda; raises if CUDA is missing)."""
    if any(a is not None for a in (face_fn, face_helper, codeformer_apply,
                                   parsenet_apply)):
        raise NotImplementedError("the face prior is not in this package yet")
    if sampler not in ("steps", "ddim"):
        raise ValueError(f"unknown sampler: {sampler!r}")
    dev = resolve_device(device)
    d = diffusion or make_task_diffusion(cfg.task, cfg.steps, device=dev)
    operator = get_operator(cfg.task, cfg.output_size, device=dev)
    batched = degraded01.ndim == 5
    frames = torch.as_tensor(
        np.asarray(degraded01 if batched else degraded01[None], np.float32),
        device=dev)
    nclips, t_all = frames.shape[0], frames.shape[1]
    flows_fn = getattr(model_apply, "flows_fn", None)
    restore_p = make_restore_fn_p(cfg.task, operator, jpeg_qf=cfg.jpeg_qf)

    def restore_fn_p(x0, degraded):
        flat = x0.reshape((x0.shape[0] * x0.shape[1],) + x0.shape[2:])
        return restore_p(flat, degraded).reshape(x0.shape)

    g = guidance or GuidanceConfig(
        w=cfg.w, rho=cfg.rho, noise_level=cfg.noise_level, zeta=cfg.zeta,
        tau=cfg.tau, t_start=cfg.t_start, use_aux=False)
    update = make_guided_update(d, g, restore_fn=restore_fn_p,
                                rule="ddim" if sampler == "ddim" else "ddpm",
                                eta=eta)
    outputs = [None] * t_all
    prev_recon = None  # (B, overlap, H, W, 3) tail of the previous window
    for start, length in window_slices(t_all, win, overlap):
        sl = frames[:, start:start + length]
        if pad_tail and length < win:
            sl = torch.cat([sl, sl[:, -1:].expand(
                nclips, win - length, *sl.shape[2:])], dim=1)
        tw = sl.shape[1]
        init = init_from_degraded(sl, cfg)
        low_res = init
        rnn_input = rnn_input_for(sl, init, cfg)
        degraded_pm1 = (sl * 2.0 - 1.0).reshape(nclips * tw, *sl.shape[2:])
        noise = draw_noise(init.shape, init, generator, noise_fn)
        t_init = d.num_timesteps - 1 if cfg.t_start == -1 else cfg.t_start
        x_t = q_sample(d, init, t_init, noise)
        pin_mask = pin_values = None
        if prev_recon is not None:
            pin_mask = torch.zeros((1, tw, 1, 1, 1), dtype=torch.bool,
                                   device=dev)
            pin_mask[:, :overlap] = True
            pin_values = torch.zeros_like(x_t)
            pin_values[:, :overlap] = prev_recon
        flows = None if flows_fn is None else flows_fn(rnn_input)

        def model_fn(x, t):
            return model_apply(x, t, low_res, rnn_input, None, flows)

        sample = guided_sample_steps(
            d, model_fn, x_t, g, update=update, pin_mask=pin_mask,
            pin_values=pin_values, restore_args=(degraded_pm1,),
            generator=generator, noise_fn=noise_fn)
        keep_from = overlap if prev_recon is not None else 0
        recon = sample.float().cpu().numpy()
        for i in range(keep_from, length):
            outputs[start + i] = recon[:, i]
        prev_recon = sample[:, length - overlap:length]
    out = np.clip((np.stack(outputs, axis=1) + 1.0) / 2.0, 0.0, 1.0)
    return out if batched else out[0]
