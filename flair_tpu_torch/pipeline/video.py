"""Windowed guided restoration of a face-video clip.

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
  step, with the JPEG round-trip for jpeg;
- the face prior (x8/x16 demo): the face helper's affine matrices are
  computed once per window from the init frames, and every step in the
  face window crops, restores, parses, blurs and pastes on the device
  (``face/helper.make_face_fn_p``); ParseNet's background class on the
  init frames down-weights VSR++ propagation (``vsrpp_bg_weight``).

The window loop and the step loop are plain Python (the JAX package's
"steps" two-program dispatch and its scan forms collapse into one loop
here). Under a mesh (``restore_video(mesh=)``) each window's frames are
split over the mesh's frame axis (``parallel``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..diffusion.gaussian import Diffusion, make_task_diffusion, q_sample
from ..diffusion.sampler import (
    GuidanceConfig, draw_noise, guided_sample_steps, make_guided_update)
from ..face.helper import make_face_fn_p
from ..operators.factory import BLUR_TASKS, get_operator, make_restore_fn_p
from ..ops.resize import resize_area, resize_bicubic
from ..parallel import all_gather_frames, axis_size, set_frame_group
from ..utils.device import resolve_device
from ..utils.spans import span

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


def _fill_missing_matrices(mats):
    """Give frames with no detected face (None) the nearest frame's matrix.
    Returns (T, 2, 3) float32, or None when no frame has a face
    (flair_tpu/pipeline/video.py:135-151)."""
    idx = [i for i, m in enumerate(mats) if m is not None]
    if not idx:
        return None
    return np.stack([
        mats[i] if mats[i] is not None
        else mats[min(idx, key=lambda k: abs(k - i))]
        for i in range(len(mats))]).astype(np.float32)


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
    mesh=None,
    frame_axis: str = "frame",
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
    ``device`` (default cuda; raises if CUDA is missing).

    Face prior: ``face_fn(x0, x_t)`` fixed for every window, or
    ``face_helper`` (``get_affine_matrices``, once per window on the init
    frames) with ``codeformer_apply`` and optionally ``parsenet_apply``
    (``wrappers.wrap_codeformer`` / ``wrap_parsenet``). A window where any
    clip has no face runs without it. With ``parsenet_apply`` and
    ``cfg.vsrpp_bg_weight > 0`` the denoiser gets VSR++ weights:
    ``vsrpp_bg_weight`` on ParseNet's background class, 1 elsewhere.

    ``mesh``: a ``parallel.make_mesh`` mesh; every rank calls with the same
    arguments and returns the whole clip (video.py:235-252). In each window
    whose length the ``frame_axis`` size n divides, a rank runs the
    denoiser, the consistency step and the face prior on its tw / n frames
    (the model's frame group set: joint norms, halos, VSR++ gathers);
    SPyNet's flows, the noise, the face matrices and the VSR++ weights are
    computed for the whole window on every rank and cut, so the run draws
    noise as the unsharded one does, and each window's sample is gathered
    before stitching. Other windows run whole on every rank, as JAX leaves
    those tensors unsharded. Needs ``model_apply.model``."""
    if sampler not in ("steps", "ddim"):
        raise ValueError(f"unknown sampler: {sampler!r}")
    model = None
    if mesh is not None:
        model = getattr(model_apply, "model", None)
        if model is None:
            raise ValueError("restore_video(mesh=) needs a denoiser wrapped "
                             "by pipeline.wrappers (model_apply.model)")
        n_frame = axis_size(mesh, frame_axis)
        frame_group = mesh.get_group(frame_axis)
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

    face_fn_p = face_fn     # called with face_args () when fixed
    if face_fn is None and codeformer_apply is not None:
        face_fn_p = make_face_fn_p(codeformer_apply, parsenet_apply,
                                   face_size=cfg.output_size)

    def prepare(start, length, prev_recon):
        """A window's frames, conditioning, start x_T, pins, flows and
        guided update: (x_t, model_fn, frame group, the sampler's
        keywords)."""
        sl = frames[:, start:start + length]
        if pad_tail and length < win:
            sl = torch.cat([sl, sl[:, -1:].expand(
                nclips, win - length, *sl.shape[2:])], dim=1)
        tw = sl.shape[1]
        # this rank's frames of the window and the group they are cut
        # over (unsharded: all of them, no group)
        mine, group = slice(None), None
        if mesh is not None and tw % n_frame == 0:
            tl = tw // n_frame
            lo = mesh.get_local_rank(frame_axis) * tl
            mine, group = slice(lo, lo + tl), frame_group
        if model is not None:
            set_frame_group(model, group)
        init = init_from_degraded(sl, cfg)
        low_res = init[:, mine]
        rnn_input = rnn_input_for(sl, init, cfg)
        degraded_pm1 = (sl[:, mine] * 2.0 - 1.0).reshape(
            -1, *sl.shape[2:])

        def window_noise(shape, like=init):
            """The whole window's draw, cut to this rank's frames."""
            return draw_noise(like.shape, like, generator,
                              noise_fn)[:, mine]

        t_init = d.num_timesteps - 1 if cfg.t_start == -1 else cfg.t_start
        x_t = q_sample(d, low_res, t_init, window_noise(None))
        pin_mask = pin_values = None
        if prev_recon is not None:
            pin_mask = torch.zeros((1, tw, 1, 1, 1), dtype=torch.bool,
                                   device=dev)
            pin_mask[:, :overlap] = True
            pin_values = torch.zeros_like(init)
            pin_values[:, :overlap] = prev_recon
            pin_mask, pin_values = pin_mask[:, mine], pin_values[:, mine]
        flows = None if flows_fn is None else flows_fn(rnn_input)
        # x8/x16: down-weight VSR++ propagation on the parsed background
        # (video_sample.py:427-444)
        vsrpp_weights = None
        if cfg.vsrpp_bg_weight > 0 and parsenet_apply is not None:
            logits = parsenet_apply(
                init.reshape(nclips * tw, *init.shape[2:]))
            bg = (torch.argmax(logits, dim=-1) == 0).float()[..., None]
            vsrpp_weights = (bg * cfg.vsrpp_bg_weight + (1.0 - bg)
                             ).reshape(nclips, tw, *bg.shape[1:])[:, mine]
        # face matrices once per window on the init frames
        # (video_sample.py:446-448); whether the window runs the face
        # prior is decided on the whole window, so every rank agrees
        face_args = () if face_fn is not None else None
        if (face_fn is None and face_helper is not None
                and codeformer_apply is not None):
            mats = [_fill_missing_matrices(face_helper.get_affine_matrices(
                        ((init[i] + 1.0) / 2.0).float().cpu().numpy(),
                        only_keep_largest=True, eye_dist_threshold=0.1))
                    for i in range(nclips)]
            if all(m is not None for m in mats):
                face_args = (torch.as_tensor(np.stack(mats),
                                             device=dev)[:, mine],)
        g = guidance or GuidanceConfig(
            w=cfg.w, rho=cfg.rho, noise_level=cfg.noise_level,
            zeta=cfg.zeta, tau=cfg.tau, t_start=cfg.t_start,
            use_aux=face_args is not None)
        update = make_guided_update(
            d, g, restore_fn=restore_fn_p, face_fn=face_fn_p,
            rule="ddim" if sampler == "ddim" else "ddpm", eta=eta)

        def model_fn(x, t):
            return model_apply(x, t, low_res, rnn_input, vsrpp_weights,
                               flows)

        return x_t, model_fn, group, dict(
            cfg=g, update=update, pin_mask=pin_mask, pin_values=pin_values,
            restore_args=(degraded_pm1,), face_args=face_args,
            noise_fn=window_noise)

    outputs = [None] * t_all
    prev_recon = None  # (B, overlap, H, W, 3) tail of the previous window
    try:
        for start, length in window_slices(t_all, win, overlap):
            with span("window"):
                with span("prep"):
                    x_t, model_fn, group, kw = prepare(start, length,
                                                       prev_recon)
                sample = guided_sample_steps(d, model_fn, x_t, **kw)
                if group is not None:
                    sample = all_gather_frames(sample, group, 1)
                keep_from = overlap if prev_recon is not None else 0
                recon = sample.float().cpu().numpy()
                for i in range(keep_from, length):
                    outputs[start + i] = recon[:, i]
                prev_recon = sample[:, length - overlap:length]
    finally:
        if model is not None:
            set_frame_group(model, None)
    out = np.clip((np.stack(outputs, axis=1) + 1.0) / 2.0, 0.0, 1.0)
    return out if batched else out[0]
