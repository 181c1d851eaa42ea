"""The port alone against the archived reference goldens.

``goldens/{x8,x16,gaussian,jpeg}_s64`` hold the reference demo script's
output (tools/make_goldens.py) with the converted flax weights; the port
restores the same clip from those weights with zero noise and must reach
the bar tests/test_goldens.py sets for the JAX package: PSNR > 40 dB and
SSIM > 0.99. The gaussian/jpeg goldens run the BlurUNet, PseudoSR with its
live γ schedule and, for jpeg, the JPEG round-trip. Needs no JAX.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


BLUR_TASKS = ("gaussian", "jpeg")


def golden_program(gold_name, steps=None, sampler="steps"):
    """The golden's clip, the port's wrapped denoiser built from its
    archived weights, and ``restore_video``'s other arguments for a
    zero-noise restoration at the golden's steps unless ``steps`` is given.
    The x8/x16 goldens hold a BicubicUNet, the gaussian/jpeg goldens a
    BlurUNet (tests/test_goldens.py builds the same models)."""
    from flair_tpu_torch.diffusion import GuidanceConfig, make_task_diffusion
    from flair_tpu_torch.models.adm import BlurUNet
    from flair_tpu_torch.models.sr3 import BicubicUNet
    from flair_tpu_torch.pipeline.video import TASK_CONFIGS
    from flair_tpu_torch.pipeline.wrappers import (
        wrap_bicubic_model, wrap_blur_model)
    from flair_tpu_torch.utils.convert import (
        from_flax_bicubic_unet, from_flax_blur_unet)

    gold = os.path.join(ROOT, "goldens", gold_name)
    meta = json.load(open(os.path.join(gold, "meta.json")))
    size = meta["size"]
    task = meta.get("task", "gaussian" if "gaussian" in gold_name
                    else "x8_bicubic")
    blur = task in BLUR_TASKS
    cfg = dataclasses.replace(
        TASK_CONFIGS[task], output_size=size,
        input_size=size // meta["factor"], steps=steps or str(meta["steps"]),
        w=meta["w"], rho=meta["rho"], zeta=meta["zeta"], tau=meta["tau"],
        noise_level=meta["noise_level"] if blur else 0.0,
        jpeg_qf=meta.get("jpeg_qf", -1), vsrpp_bg_weight=0.0)
    d = make_task_diffusion(cfg.task, cfg.steps, device="cpu")
    flat = dict(np.load(os.path.join(gold, "params.npz")))
    if blur:
        model = BlurUNet(
            image_size=size, model_channels=32, num_res_blocks=1,
            attention_resolutions=(2,), rnn_resolutions=(1,),
            channel_mult=(1, 2), num_heads=1, num_head_channels=8,
            temporal_frames=5)
        model.load_state_dict(from_flax_blur_unet(flat))
        apply = wrap_blur_model(d, model)
    else:
        model = BicubicUNet(
            inner_channel=32, norm_groups=16, channel_mults=(1, 2),
            attn_res=(32,), vsrpp_res=(64,), image_size=size, res_blocks=1,
            num_frames=meta["win"], head_dim=8)
        model.load_state_dict(from_flax_bicubic_unet(flat))
        apply = wrap_bicubic_model(d, model)
    clip = np.load(os.path.join(gold, "degraded01.npy"))
    return clip, cfg, apply, dict(
        diffusion=d,
        guidance=GuidanceConfig(use_aux=False, w=cfg.w, rho=cfg.rho,
                                tau=cfg.tau, zeta=cfg.zeta,
                                noise_level=cfg.noise_level),
        win=meta["win"], overlap=meta["overlap"], pad_tail=False,
        sampler=sampler, device="cpu",
        noise_fn=lambda s: np.zeros(s, np.float32))


def restore_golden(gold_name, steps=None, sampler="steps"):
    """The port's zero-noise restoration of a golden's clip
    (``golden_program``)."""
    from flair_tpu_torch.pipeline.video import restore_video

    clip, cfg, apply, kwargs = golden_program(gold_name, steps, sampler)
    return restore_video(clip, cfg, apply, **kwargs)


@pytest.mark.parametrize("gold_name", ["x8_s64", "x16_s64", "gaussian_s64",
                                       "jpeg_s64"])
def test_port_reproduces_reference_goldens(gold_name):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from metrics import load_frames, psnr, ssim

    gold = os.path.join(ROOT, "goldens", gold_name)
    ours = restore_golden(gold_name)
    ref = load_frames(gold)
    assert ours.shape == ref.shape
    p, s = psnr(ours, ref), ssim(ours, ref)
    assert p > 40.0, f"PSNR vs archived reference goldens: {p:.2f} dB"
    assert s > 0.99, f"SSIM vs archived reference goldens: {s:.4f}"


@pytest.mark.slow
def test_port_ddim25_divergence_from_ddpm100_bounded():
    """The serving schedule (25 η=0 DDIM steps respaced from the 2000-step
    x8 schedule) against the archived 100-step DDPM output of the same
    weights and clip: the divergence ``goldens/respace_x8_s64`` records for
    the JAX package must not grow by more than 1 dB in the port (the bound
    tests/test_goldens.py holds the JAX package to)."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from metrics import psnr

    gold = os.path.join(ROOT, "goldens", "respace_x8_s64")
    meta = json.load(open(os.path.join(gold, "meta.json")))
    ddpm100 = np.load(os.path.join(gold, "ddpm100.npy"))
    ddim25 = restore_golden("x8_s64", steps="ddim25", sampler="ddim")
    assert ddim25.shape == ddpm100.shape
    p = psnr(ddim25, ddpm100)
    assert p > meta["psnr_ddim25_vs_ddpm100"] - 1.0, p
    assert p > 25.0, p


@pytest.mark.slow
def test_port_ddim25_divergence_from_ddpm100_bounded_gaussian():
    """The same drift check for the face_blur schedule family:
    ``goldens/respace_gaussian_s64`` archives the 100-step DDPM output of
    the gaussian_s64 weights and records PSNR(DDIM-25, DDPM-100); the port's
    DDIM-25 must land within 1 dB of it in both directions, the bound
    tests/test_goldens.py holds the JAX package to."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from metrics import psnr

    gold = os.path.join(ROOT, "goldens", "respace_gaussian_s64")
    meta = json.load(open(os.path.join(gold, "meta.json")))
    ddpm100 = np.load(os.path.join(gold, "ddpm100.npy"))
    ddim25 = restore_golden("gaussian_s64", steps="ddim25", sampler="ddim")
    assert ddim25.shape == ddpm100.shape
    p = psnr(ddim25, ddpm100)
    assert abs(p - meta["psnr_ddim25_vs_ddpm100"]) < 1.0, p
