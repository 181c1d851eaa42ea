"""Port pipeline (flair_tpu_torch.pipeline.restore_video) against flair_tpu.

Both packages restore the same 64² clip with the same weights and zero
noise (as tests/test_goldens.py does for the JAX package), through two
windows (the tail window padded, the overlap pinned), and agree to ≥45 dB
PSNR in float32. A subprocess checks that the port imports neither JAX nor
the JAX package.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_KW = dict(inner_channel=32, norm_groups=16, channel_mults=(1, 2),
                attn_res=(32,), vsrpp_res=(64,), image_size=64, res_blocks=1,
                num_frames=3, head_dim=8)


def psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return float("inf") if mse == 0 else float(10 * np.log10(1.0 / mse))


def golden(name):
    gold = os.path.join(ROOT, "goldens", name)
    meta = json.load(open(os.path.join(gold, "meta.json")))
    flat = dict(np.load(os.path.join(gold, "params.npz")))
    return gold, meta, flat


def task_config(pkg_configs, meta, steps):
    return dataclasses.replace(
        pkg_configs[meta.get("task", "x8_bicubic")], output_size=64,
        input_size=64 // meta["factor"], steps=steps, w=meta["w"],
        rho=0.35, zeta=-1, tau=0, noise_level=0.0, vsrpp_bg_weight=0.0)


def run_port(flat, degraded01, cfg, sampler, **kw):
    from flair_tpu_torch.diffusion import GuidanceConfig, make_task_diffusion
    from flair_tpu_torch.models.sr3 import BicubicUNet
    from flair_tpu_torch.pipeline.video import restore_video
    from flair_tpu_torch.pipeline.wrappers import wrap_bicubic_model
    from flair_tpu_torch.utils.convert import from_flax_bicubic_unet

    d = make_task_diffusion(cfg.task, cfg.steps, device="cpu")
    model = BicubicUNet(**MODEL_KW)
    model.load_state_dict(from_flax_bicubic_unet(flat))
    g = GuidanceConfig(use_aux=False, w=cfg.w, rho=cfg.rho, tau=cfg.tau,
                       zeta=cfg.zeta, noise_level=0.0)
    return restore_video(
        degraded01, cfg, wrap_bicubic_model(d, model), diffusion=d,
        guidance=g, sampler=sampler, device="cpu",
        noise_fn=lambda s: np.zeros(s, np.float32), **kw)


@pytest.mark.parametrize("gold_name,sampler,steps", [
    ("x8_s64", "ddim", "ddim4"), ("x16_s64", "steps", "3")])
def test_restore_video_matches_flair_tpu(monkeypatch, gold_name, sampler,
                                         steps):
    from flair_tpu.diffusion import GuidanceConfig, make_task_diffusion
    from flair_tpu.models.sr3 import BicubicUNet as JU
    from flair_tpu.pipeline import video as jvideo
    from flair_tpu.pipeline.wrappers import wrap_bicubic_model
    from flair_tpu.utils.checkpoint import unflatten_params
    from flair_tpu_torch.pipeline.video import TASK_CONFIGS

    _, meta, flat = golden(gold_name)
    # 4 frames, windows of 3 with overlap 1: the tail window (1 frame) is
    # padded to 3 and its first frame pinned to the previous window
    clip = np.random.default_rng(0).uniform(
        0, 1, (4, 64 // meta["factor"], 64 // meta["factor"], 3)).astype(
        np.float32)
    cfg_t = task_config(TASK_CONFIGS, meta, steps)
    out_t = run_port(flat, clip, cfg_t, sampler, win=3, overlap=1)

    cfg_j = task_config(jvideo.TASK_CONFIGS, meta, steps)
    d = make_task_diffusion(cfg_j.task, cfg_j.steps)
    apply = wrap_bicubic_model(d, JU(**MODEL_KW), unflatten_params(flat))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=None, dtype=jnp.float32:
                        jnp.zeros(shape if shape is not None else (), dtype))
    out_j = jvideo.restore_video(
        clip, cfg_j, apply, diffusion=d,
        guidance=GuidanceConfig(use_aux=False, w=cfg_j.w, rho=cfg_j.rho,
                                tau=cfg_j.tau, zeta=cfg_j.zeta,
                                noise_level=0.0),
        win=3, overlap=1, sampler=sampler)
    assert out_t.shape == out_j.shape == (4, 64, 64, 3)
    p = psnr(out_t, out_j)
    assert p >= 45.0, p


BLUR_KW = dict(image_size=64, in_channels=6, model_channels=32,
               out_channels=6, num_res_blocks=1, attention_resolutions=(2,),
               rnn_resolutions=(1,), channel_mult=(1, 2), num_heads=1,
               num_head_channels=8, use_scale_shift_norm=True,
               temporal_frames=5)


def blur_task_config(pkg_configs, meta, steps):
    """The blur golden's guidance (γ schedule live: ζ = 1, its noise level,
    the jpeg round-trip at the golden's qf) at 16² → 64²."""
    return dataclasses.replace(
        pkg_configs[meta.get("task", "gaussian")], output_size=64,
        input_size=16, steps=steps, w=meta["w"], rho=meta["rho"],
        zeta=meta["zeta"], tau=0, noise_level=meta["noise_level"],
        jpeg_qf=meta.get("jpeg_qf", -1))


@pytest.mark.parametrize("gold_name,sampler,steps", [
    ("gaussian_s64", "ddim", "ddim4"), ("jpeg_s64", "steps", "3")])
def test_restore_video_blur_tasks_match_flair_tpu(monkeypatch, gold_name,
                                                  sampler, steps):
    """The gaussian / jpeg branch: area-upscaled conditioning, SPyNet on
    the bicubic-upscaled clip, PseudoSR's null-space correction (with the
    JPEG round-trip for jpeg), 6-channel LEARNED_RANGE output. The JAX
    BlurUNet uses its exact DCN (``dcn_patch_size=None``)."""
    from flair_tpu import diffusion as jd
    from flair_tpu.models.adm import BlurUNet as JB
    from flair_tpu.pipeline import video as jvideo
    from flair_tpu.pipeline.wrappers import wrap_blur_model as j_wrap
    from flair_tpu.utils.checkpoint import unflatten_params
    from flair_tpu_torch import diffusion as td
    from flair_tpu_torch.models.adm import BlurUNet
    from flair_tpu_torch.pipeline import video as tvideo
    from flair_tpu_torch.pipeline.wrappers import wrap_blur_model
    from flair_tpu_torch.utils.convert import from_flax_blur_unet

    _, meta, flat = golden(gold_name)
    clip = np.random.default_rng(1).uniform(0, 1, (4, 16, 16, 3)).astype(
        np.float32)

    def guidance(pkg, cfg):
        return pkg.GuidanceConfig(use_aux=False, w=cfg.w, rho=cfg.rho, tau=0,
                                  zeta=cfg.zeta, noise_level=cfg.noise_level)

    cfg_t = blur_task_config(tvideo.TASK_CONFIGS, meta, steps)
    d_t = td.make_task_diffusion(cfg_t.task, cfg_t.steps, device="cpu")
    model = BlurUNet(**BLUR_KW)
    model.load_state_dict(from_flax_blur_unet(flat))
    out_t = tvideo.restore_video(
        clip, cfg_t, wrap_blur_model(d_t, model), diffusion=d_t,
        guidance=guidance(td, cfg_t), win=3, overlap=1, sampler=sampler,
        device="cpu", noise_fn=lambda s: np.zeros(s, np.float32))

    cfg_j = blur_task_config(jvideo.TASK_CONFIGS, meta, steps)
    d_j = jd.make_task_diffusion(cfg_j.task, cfg_j.steps)
    apply = j_wrap(d_j, JB(**BLUR_KW, dcn_patch_size=None),
                   unflatten_params(flat))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=None, dtype=jnp.float32:
                        jnp.zeros(shape if shape is not None else (), dtype))
    out_j = jvideo.restore_video(
        clip, cfg_j, apply, diffusion=d_j,
        guidance=guidance(jd, cfg_j),
        win=3, overlap=1, sampler=sampler)
    assert out_t.shape == out_j.shape == (4, 64, 64, 3)
    p = psnr(out_t, out_j)
    assert p >= 45.0, p


def test_port_imports_neither_jax_nor_flair_tpu():
    code = (
        "import sys\n"
        "import flair_tpu_torch\n"
        "import flair_tpu_torch.diffusion, flair_tpu_torch.models.sr3\n"
        "import flair_tpu_torch.models.adm, flair_tpu_torch.ops.jpeg\n"
        "import flair_tpu_torch.operators, flair_tpu_torch.ops.dcn\n"
        "import flair_tpu_torch.operators.pseudo_sr\n"
        "import flair_tpu_torch.pipeline.video\n"
        "import flair_tpu_torch.pipeline.wrappers\n"
        "import flair_tpu_torch.utils.convert\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'flair_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_chip_smoke_imports_neither_jax_nor_flair_tpu():
    code = (
        "import sys\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'flair_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
