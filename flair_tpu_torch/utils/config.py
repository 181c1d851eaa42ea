"""Config registry: flag defaults, the model/diffusion factory, the argparse
bridge.

Counterpart of ``flair_tpu/utils/config.py`` (reference
script_util.py:14-310). The demo CLI's per-task settings are
``pipeline.video.TASK_CONFIGS``; this module is the training-side
``*_defaults()`` dict flattened into argparse, and
``create_model_and_diffusion`` on the port's registry. The port's BlurUNet
has only the reference's ``resblock_updown`` and ``temporal_block`` form, so
other values raise.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict

import torch


def model_and_diffusion_defaults() -> Dict[str, Any]:
    """Flag defaults (script_util.py:14-62)."""
    return dict(
        task="gaussian",
        image_size=512,
        num_channels=128,
        num_res_blocks=2,
        num_heads=1,
        num_head_channels=64,
        attention_resolutions="16,32,64",
        rnn_resolutions="1,2",
        channel_mult="0.5,1,1,2,2,4,4",
        dropout=0.0,
        learn_sigma=True,
        diffusion_steps=1000,
        noise_schedule="face_blur",
        timestep_respacing="",
        use_kl=False,
        predict_xstart=False,
        rescale_timesteps=False,
        rescale_learned_sigmas=False,
        use_scale_shift_norm=True,
        resblock_updown=True,
        use_fp16=True,
        temporal_block=True,
    )


def _ints(s) -> tuple:
    return tuple(int(v) for v in str(s).split(","))


def create_model_and_diffusion(device=None, **kwargs):
    """Factory (script_util.py:65-282): the task's denoiser module (on the
    CPU; move it with ``.to``) and the (respaced) Diffusion on ``device``
    (default cuda)."""
    from ..diffusion import make_diffusion
    from ..diffusion.schedules import (
        LossType, ModelMeanType, ModelVarType, get_named_beta_schedule,
        space_timesteps)
    from ..models.registry import get_model

    cfg = model_and_diffusion_defaults()
    cfg.update(kwargs)

    task = cfg["task"]
    dtype = torch.bfloat16 if cfg["use_fp16"] else torch.float32
    if task in ("x8_bicubic", "x16_bicubic"):
        model = get_model("bicubic_unet", image_size=cfg["image_size"],
                          dtype=dtype)
        learn_sigma = False
        schedule = "face_bicubic"
        steps = 2000
    else:
        if not (cfg["resblock_updown"] and cfg["temporal_block"]):
            raise ValueError("the port's BlurUNet has resblock_updown=True "
                             "and temporal_block=True only")
        model = get_model(
            "blur_unet",
            image_size=cfg["image_size"],
            model_channels=cfg["num_channels"],
            num_res_blocks=cfg["num_res_blocks"],
            attention_resolutions=_ints(cfg["attention_resolutions"]),
            rnn_resolutions=_ints(cfg["rnn_resolutions"]),
            channel_mult=tuple(
                float(s) for s in str(cfg["channel_mult"]).split(",")),
            num_head_channels=cfg["num_head_channels"],
            use_scale_shift_norm=cfg["use_scale_shift_norm"],
            out_channels=6 if cfg["learn_sigma"] else 3,
            dtype=dtype,
        )
        learn_sigma = cfg["learn_sigma"]
        schedule = cfg["noise_schedule"]
        steps = cfg["diffusion_steps"]

    betas = get_named_beta_schedule(schedule, steps)
    if cfg["use_kl"]:
        loss_type = LossType.RESCALED_KL
    elif cfg["rescale_learned_sigmas"]:
        loss_type = LossType.RESCALED_MSE
    else:
        loss_type = LossType.MSE
    use_timesteps = None
    if cfg["timestep_respacing"]:
        use_timesteps = space_timesteps(len(betas), cfg["timestep_respacing"])
    diffusion = make_diffusion(
        betas,
        model_mean_type=(ModelMeanType.START_X if cfg["predict_xstart"]
                         else ModelMeanType.EPSILON),
        model_var_type=(ModelVarType.LEARNED_RANGE if learn_sigma
                        else ModelVarType.FIXED_SMALL),
        loss_type=loss_type,
        rescale_timesteps=cfg["rescale_timesteps"],
        use_timesteps=use_timesteps,
        device=device,
    )
    return model, diffusion


def add_dict_to_argparser(parser: argparse.ArgumentParser, default_dict):
    """(script_util.py:285-296)."""
    for k, v in default_dict.items():
        v_type = type(v)
        if v is None:
            v_type = str
        elif isinstance(v, bool):
            v_type = str2bool
        parser.add_argument(f"--{k}", default=v, type=v_type)


def args_to_dict(args, keys):
    return {k: getattr(args, k) for k in keys}


def str2bool(v):
    """(script_util.py:299-310)."""
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("boolean value expected")
