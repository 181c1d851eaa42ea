"""Port pipeline (flair_tpu_torch.pipeline.restore_video) against flair_tpu.

Both packages restore the same 64² clip with the same weights and zero
noise (as tests/test_goldens.py does for the JAX package), through two
windows (the tail window padded, the overlap pinned), and agree to ≥45 dB
PSNR in float32 with the face prior off, and to ≥40 dB (the goldens' bar)
with it on: tiny CodeFormer / ParseNet carried across from flax, a stub
face helper with fixed matrices, VSR++ background weights. A subprocess
checks that the port imports neither JAX nor the JAX package. JAX is
imported inside the parity tests, so the ``cuda`` cases run on a machine
without it (``python -m pytest -m cuda tests/test_torch_pipeline.py``).
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

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


def zero_jax_noise(monkeypatch):
    """The JAX package's noise draws return zeros (the port gets
    ``noise_fn`` zeros), as tests/test_goldens.py runs it."""
    import jax
    import jax.numpy as jnp

    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=None, dtype=jnp.float32:
                        jnp.zeros(shape if shape is not None else (), dtype))


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
    zero_jax_noise(monkeypatch)
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
    zero_jax_noise(monkeypatch)
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
        "import flair_tpu_torch.face, flair_tpu_torch.face.helper\n"
        "import flair_tpu_torch.models.codeformer\n"
        "import flair_tpu_torch.models.parsenet, flair_tpu_torch.ops.blur\n"
        "import flair_tpu_torch.ops.warp, flair_tpu_torch.models.registry\n"
        "flair_tpu_torch.models.registry.list_models()\n"
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


# ------------------------------------------------------------- face prior ---

FACE_CF_KW = dict(dim_embd=64, n_head=4, n_layers=1, codebook_size=32,
                  latent_size=256, connect_list=("32", "64"), nf=32,
                  ch_mult=(1, 2, 2))      # 64² faces, a 16² latent
FACE_PN_KW = dict(in_size=64, out_size=64, min_feat_size=16, base_ch=16,
                  res_depth=1, ch_range=(16, 64))
FACE_MATRIX = np.array([[1.05, 0.06, -4.0], [-0.06, 1.05, 1.5]], np.float32)


class FixedFaceHelper:
    """The face helper's interface with fixed matrices; the last frame of
    every window has no face (the pipeline gives it its neighbour's)."""

    def get_affine_matrices(self, frames01, **kw):
        return [FACE_MATRIX] * (len(frames01) - 1) + [None]


def flax_face_models():
    """Tiny flax CodeFormer and ParseNet at 64², every leaf perturbed by
    seeded noise (ParseNet's running statistics too); returns the modules
    and their flat variables."""
    import jax
    import jax.numpy as jnp
    from flair_tpu.models.codeformer import CodeFormer as JCF
    from flair_tpu.models.parsenet import ParseNet as JPN
    from flair_tpu.utils.checkpoint import flatten_params

    rng = np.random.default_rng(11)
    x = jnp.zeros((1, 64, 64, 3))
    out = []
    for module, init in (
            (JCF(**FACE_CF_KW), lambda m, k: m.init(k, x, w=1.0, adain=True)),
            (JPN(**FACE_PN_KW), lambda m, k: m.init(k, x))):
        flat = flatten_params(init(module, jax.random.PRNGKey(3)))
        out.append((module, {
            k: (np.abs(v) + 0.5 if k.endswith("/var") else v
                + rng.standard_normal(v.shape) * 0.05).astype(np.float32)
            for k, v in flat.items()}))
    return out


def port_face_models(flat_cf, flat_pn):
    from flair_tpu_torch.models.codeformer import CodeFormer
    from flair_tpu_torch.models.parsenet import ParseNet
    from flair_tpu_torch.pipeline.wrappers import wrap_codeformer, wrap_parsenet
    from flair_tpu_torch.utils.convert import (
        from_flax_codeformer, from_flax_parsenet)

    cf, pn = CodeFormer(**FACE_CF_KW), ParseNet(**FACE_PN_KW)
    cf.load_state_dict(from_flax_codeformer(flat_cf), strict=True)
    pn.load_state_dict(from_flax_parsenet(flat_pn), strict=True)
    return wrap_codeformer(cf.eval()), wrap_parsenet(pn.eval())


def test_restore_video_face_on_matches_flair_tpu(monkeypatch):
    """x8 ``ddim`` over 4 steps and two windows with the face prior on:
    crop → CodeFormer → ParseNet mask → paste in every step, VSR++
    background weights 0.93 from ParseNet on the init frames."""
    from flair_tpu.diffusion import make_task_diffusion
    from flair_tpu.models.sr3 import BicubicUNet as JU
    from flair_tpu.pipeline import video as jvideo
    from flair_tpu.pipeline.wrappers import wrap_bicubic_model
    from flair_tpu.utils.checkpoint import unflatten_params
    from flair_tpu_torch.pipeline.video import TASK_CONFIGS

    _, meta, flat = golden("x8_s64")
    (jcf, flat_cf), (jpn, flat_pn) = flax_face_models()
    clip = np.random.default_rng(0).uniform(0, 1, (4, 8, 8, 3)).astype(
        np.float32)

    def cfg_of(pkg_configs):
        return dataclasses.replace(task_config(pkg_configs, meta, "ddim4"),
                                   vsrpp_bg_weight=0.93)

    cf_t, pn_t = port_face_models(flat_cf, flat_pn)
    from flair_tpu_torch.diffusion import make_task_diffusion as t_diffusion
    from flair_tpu_torch.models.sr3 import BicubicUNet
    from flair_tpu_torch.pipeline.video import restore_video
    from flair_tpu_torch.pipeline.wrappers import wrap_bicubic_model as t_wrap
    from flair_tpu_torch.utils.convert import from_flax_bicubic_unet

    cfg_t = cfg_of(TASK_CONFIGS)
    d_t = t_diffusion(cfg_t.task, cfg_t.steps, device="cpu")
    model = BicubicUNet(**MODEL_KW)
    model.load_state_dict(from_flax_bicubic_unet(flat))
    out_t = restore_video(
        clip, cfg_t, t_wrap(d_t, model), diffusion=d_t, win=3, overlap=1,
        sampler="ddim", device="cpu", face_helper=FixedFaceHelper(),
        codeformer_apply=cf_t, parsenet_apply=pn_t,
        noise_fn=lambda s: np.zeros(s, np.float32))

    cfg_j = cfg_of(jvideo.TASK_CONFIGS)
    d_j = make_task_diffusion(cfg_j.task, cfg_j.steps)
    apply = wrap_bicubic_model(d_j, JU(**MODEL_KW), unflatten_params(flat))
    cf_p, pn_p = unflatten_params(flat_cf), unflatten_params(flat_pn)
    zero_jax_noise(monkeypatch)
    out_j = jvideo.restore_video(
        clip, cfg_j, apply, diffusion=d_j, win=3, overlap=1, sampler="ddim",
        face_helper=FixedFaceHelper(),
        codeformer_apply=lambda f: jcf.apply(cf_p, f, w=1.0, adain=True)[0],
        parsenet_apply=lambda f: jpn.apply(pn_p, f)[0])
    assert out_t.shape == out_j.shape == (4, 64, 64, 3)
    p = psnr(out_t, out_j)
    assert p >= 40.0, p


def stub_face_models():
    def codeformer_apply(faces):
        return torch.clamp(faces + 0.5, -1, 1)

    def parsenet_apply(imgs):
        # background (class 0) on the left half, class 1 on the right
        n, h, w, _ = imgs.shape
        left = (torch.arange(w) < w // 2)[None, None, :, None]
        eye = torch.eye(19)
        return torch.where(left, eye[0], eye[1]).expand(n, h, w, 19)

    return codeformer_apply, parsenet_apply


def test_restore_video_face_fusion_and_vsrpp_weights():
    """tests/test_pipeline.py's wiring test at 64² (the mask blur's
    reflect padding needs more than 50 px): the face changes the output
    against no face, and the x8 VSR++ weights come from the ParseNet
    background mask (video_sample.py:427-448)."""
    from flair_tpu_torch.pipeline.video import TASK_CONFIGS, restore_video

    cfg = dataclasses.replace(TASK_CONFIGS["x8_bicubic"], output_size=64,
                              input_size=8, steps="2", tau=0)
    captured = {}

    def model_apply(x, t, low_res, rnn, w, flows=None):
        captured["vsrpp_weights"] = w
        return torch.zeros_like(x)

    class StubHelper:
        def get_affine_matrices(self, frames01, **kw):
            ident = np.array([[1.0, 0, 0], [0, 1.0, 0]])
            return [ident] * (len(frames01) - 1) + [None]   # one miss

    codeformer_apply, parsenet_apply = stub_face_models()
    frames = np.random.RandomState(2).rand(2, 8, 8, 3).astype(np.float32)

    def run(**face):
        return restore_video(frames, cfg, model_apply, win=2, overlap=1,
                             device="cpu",
                             generator=torch.Generator().manual_seed(0),
                             **face)

    out_face = run(face_helper=StubHelper(), codeformer_apply=codeformer_apply,
                   parsenet_apply=parsenet_apply)
    w = captured["vsrpp_weights"]
    assert w is not None and tuple(w.shape) == (1, 2, 64, 64, 1)
    assert np.allclose(np.unique(w.numpy()), [0.93, 1.0])
    out_plain = run()
    assert captured["vsrpp_weights"] is None
    assert out_face.shape == out_plain.shape == (2, 64, 64, 3)
    assert not np.allclose(out_face, out_plain)
    # a window where no frame has a face runs without the prior
    class NoFace:
        def get_affine_matrices(self, frames01, **kw):
            return [None] * len(frames01)

    out_none = run(face_helper=NoFace(), codeformer_apply=codeformer_apply)
    np.testing.assert_array_equal(out_none, out_plain)


def test_restore_video_face_prior_defaults_to_cuda(monkeypatch):
    from flair_tpu_torch.pipeline.video import TASK_CONFIGS, restore_video

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    codeformer_apply, parsenet_apply = stub_face_models()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        restore_video(np.zeros((2, 8, 8, 3), np.float32),
                      TASK_CONFIGS["x8_bicubic"], lambda *a: None,
                      face_helper=FixedFaceHelper(),
                      codeformer_apply=codeformer_apply,
                      parsenet_apply=parsenet_apply)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [False, True])
def test_cuda_face_fn_matches_cpu(cuda_device, aligned):
    """The face fusion with seeded random tiny CodeFormer / ParseNet on the
    card (cuDNN, grid_sample) against the CPU, float32 with TF32 off."""
    from flair_tpu_torch.face.helper import make_face_fn_p
    from flair_tpu_torch.models.codeformer import CodeFormer
    from flair_tpu_torch.models.parsenet import ParseNet
    from flair_tpu_torch.pipeline.wrappers import wrap_codeformer, wrap_parsenet

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cf, pn = CodeFormer(**FACE_CF_KW), ParseNet(**FACE_PN_KW)
    cf.random_init(seed=1, scale=0.2)
    pn.random_init(seed=2, scale=0.2)
    rng = np.random.default_rng(4)
    x0 = torch.from_numpy(rng.uniform(-1, 1, (1, 3, 64, 64, 3)).astype(
        np.float32))
    mats = torch.from_numpy(np.tile(FACE_MATRIX, (3, 1, 1)))
    outs = []
    for dev in ("cpu", cuda_device):
        fn = make_face_fn_p(wrap_codeformer(cf.to(dev).eval()),
                            wrap_parsenet(pn.to(dev).eval()), face_size=64,
                            aligned=aligned)
        with torch.no_grad():
            outs.append(fn(x0.to(dev), x0.to(dev), mats.to(dev)).cpu())
    torch.backends.cudnn.allow_tf32 = True
    assert torch.isfinite(outs[1]).all()
    assert psnr(outs[0].numpy() / 2, outs[1].numpy() / 2) >= 50.0
