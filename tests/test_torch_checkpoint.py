"""The port's checkpoint loading against flair_tpu.

- For each model ``load_params`` takes from an upstream torch checkpoint
  (SPyNet, BicubicUNet, BlurUNet, CodeFormer, ParseNet, RetinaFace with
  both bodies, SuperSloMo, AMT, DAVSRNet's HyPaNet and SuperSloMo UNets),
  at a small configuration: an upstream-named state dict is
  built here from the flax model's variables by running the port's name
  map backwards. The JAX package's ``convert_<model>`` must rebuild
  exactly those variables from it, and the port's ``convert_<model>``
  must give the ``state_dict`` that ``from_flax`` gives, load it
  with ``strict=True``, and run a forward that matches the flax one
  (≤1e-4 of the output's largest magnitude). The state dict also goes
  through a ``.pth`` file and ``load_params``.
- ``load_params`` on ``goldens/x8_s64/params.npz`` (a flat flax ``.npz``),
  and the orbax-directory error.
- ``config.create_model_and_diffusion`` against the JAX one: the diffusion
  tables and the model's parameter shapes.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flair_tpu.utils import convert as jconvert
from flax_init import random_flax_params
from flair_tpu.utils.checkpoint import flatten_params, unflatten_params
from flair_tpu_torch.utils import checkpoint as tckpt
from flair_tpu_torch.utils import convert as tconvert

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# flax layout → upstream layout: the inverse of tconvert.LAYOUTS
INVERSE = {
    None: lambda a, heads: a,
    "conv": lambda a, heads: a.transpose(3, 2, 0, 1),
    "conv3d": lambda a, heads: a.transpose(4, 3, 0, 1, 2),
    "linear": lambda a, heads: a.T,
    "conv1x1_dense": lambda a, heads: a.T[:, :, None, None],
    "conv1d_dense": lambda a, heads: a.T[:, :, None],
    "conv3d_dense": lambda a, heads: a.T[:, :, None, None, None],
    "convtranspose": lambda a, heads: a[::-1, ::-1].transpose(2, 3, 0, 1),
    "heads_in": lambda a, heads: a.reshape(a.shape[0], -1).T,
    "heads_out": lambda a, heads: a.reshape(-1, a.shape[-1]).T,
    "heads_bias": lambda a, heads: a.reshape(-1),
}


class InverseReader:
    """The port's name maps run backwards: each ``put(t, j, layout)``
    writes upstream entry ``t`` from flax leaf ``j``; ``has`` answers from
    the flax side. ``spynet_key``: the upstream key the map searches for
    the SPyNet under."""

    def __init__(self, flat, spynet_key=None):
        self.flat, self.state, self.pieces, self.used = flat, {}, {}, set()
        self.spynet_key = spynet_key

    def has(self, t, j):
        return f"params/{j}" in self.flat

    def keys(self):
        has_spynet = any(k.startswith("params/spynet/") for k in self.flat)
        return [self.spynet_key] if has_spynet and self.spynet_key else []

    def put(self, t, j, layout=None, *, rows=None, heads=None,
            collection="params"):
        key = f"{collection}/{j}"
        self.used.add(key)
        a = np.ascontiguousarray(INVERSE[layout](self.flat[key], heads))
        if rows is None:
            self.state[t] = a
        else:
            self.pieces.setdefault(t, {})[rows[0]] = a

    def state_dict(self):
        for t, parts in self.pieces.items():
            self.state[t] = np.concatenate([parts[k] for k in sorted(parts)])
        return self.state


def perturbed(variables, seed):
    rng = np.random.default_rng(seed)

    def one(k, v):
        v = np.asarray(v) * (1 + 0.1 * rng.standard_normal(v.shape)) \
            + 0.02 * rng.standard_normal(v.shape)
        return (np.abs(v) + 0.1 if k.endswith("/var") else v).astype(
            np.float32)

    return {k: one(k, v) for k, v in flatten_params(variables).items()}


def uniform(seed, *shape, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


# ---------------------------------------------------------------- models ---
# Each case: (flat flax variables, the flax forward, the port model, its
# forward on the same numpy inputs, the map's name, its config, the
# upstream key the SPyNet is searched under).


def case_spynet():
    from flair_tpu.models.spynet import SPyNet as J
    from flair_tpu_torch.models.spynet import SPyNet as T

    ref = uniform(0, 1, 32, 32, 3, lo=0.0)
    supp = np.roll(ref, 2, axis=2)
    jm = J()
    flat = perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0), ref, supp), 1)
    j_out = np.asarray(jax.jit(jm.apply)(unflatten_params(flat), ref, supp))
    return (flat, j_out, T(),
            lambda m: nhwc(m(nchw(ref), nchw(supp))), "spynet", {}, None)


BICUBIC_KW = dict(inner_channel=32, norm_groups=16, channel_mults=(1, 2),
                  attn_res=(32,), vsrpp_res=(64,), image_size=64,
                  res_blocks=1, num_frames=3, head_dim=8)
BLUR_KW = dict(image_size=64, in_channels=6, model_channels=32,
               out_channels=6, num_res_blocks=1, attention_resolutions=(2,),
               rnn_resolutions=(1,), channel_mult=(1, 2), num_heads=1,
               num_head_channels=8, use_scale_shift_norm=True,
               temporal_frames=5)


def golden_flat(name, seed):
    flat = dict(np.load(os.path.join(ROOT, "goldens", name, "params.npz")))
    rng = np.random.default_rng(seed)
    return {k: (v + rng.standard_normal(v.shape) * 0.02).astype(np.float32)
            for k, v in flat.items()}


def case_bicubic_unet():
    from flair_tpu.models.sr3 import BicubicUNet as J
    from flair_tpu_torch.models.sr3 import BicubicUNet as T

    flat = golden_flat("x8_s64", 2)
    x = uniform(3, 1, 3, 64, 64, 3)
    low = uniform(4, 1, 3, 64, 64, 3, lo=-0.5, hi=0.5)
    lvl = np.full((1, 3), 0.3, np.float32)
    j_out = np.asarray(jax.jit(J(**BICUBIC_KW).apply)(
        unflatten_params(flat), x, lvl, low))

    def fwd(m):
        return m(*map(torch.from_numpy, (x, lvl, low))).numpy()

    return (flat, j_out, T(**BICUBIC_KW), fwd, "bicubic_unet",
            dict(channel_mults=(1, 2), res_blocks=1),
            "downs.1.vsrpp.wrapped_module.spynet.basic_module.0."
            "basic_module.0.conv.weight")


def case_blur_unet():
    from flair_tpu.models.adm import BlurUNet as J
    from flair_tpu_torch.models.adm import BlurUNet as T

    flat = golden_flat("gaussian_s64", 5)
    x = uniform(6, 1, 3, 64, 64, 3)
    low = uniform(7, 1, 3, 64, 64, 3, lo=-0.5, hi=0.5)
    ts = np.array([[500, 500, 500]], np.int32)
    j_out = np.asarray(jax.jit(J(**BLUR_KW, dcn_patch_size=None).apply)(
        unflatten_params(flat), x, ts, low))

    def fwd(m):
        return m(torch.from_numpy(x), torch.from_numpy(ts).long(),
                 torch.from_numpy(low)).numpy()

    return (flat, j_out, T(**BLUR_KW), fwd, "blur_unet",
            dict(channel_mult=(1, 2), num_res_blocks=1, attention_ds=(2,),
                 rnn_ds=(1,), temporal_block=True),
            "spynet.basic_module.0.basic_module.0.conv.weight")


CF_KW = dict(dim_embd=64, n_head=4, n_layers=2, codebook_size=32,
             latent_size=256, connect_list=("32",), nf=32, ch_mult=(1, 2))


def case_codeformer():
    from flair_tpu.models.codeformer import CodeFormer as J
    from flair_tpu_torch.models.codeformer import CodeFormer as T

    x = uniform(8, 1, 32, 32, 3)
    jm = J(**CF_KW)
    flat = perturbed(jax.jit(lambda k, x: jm.init(k, x, w=1.0, adain=True))(
        jax.random.PRNGKey(9), x), 10)
    j_out = np.asarray(jax.jit(lambda p, x: jm.apply(
        p, x, w=1.0, adain=True)[0])(unflatten_params(flat), x))
    return (flat, j_out, T(**CF_KW),
            lambda m: nhwc(m(nchw(x), w=1.0, adain=True)[0]), "codeformer",
            dict(nf=32, ch_mult=(1, 2), resolution=32, dim_embd=64,
                 n_head=4, n_layers=2, codebook_size=32,
                 connect_list=("32",)), None)


def case_parsenet():
    from flair_tpu.models.parsenet import ParseNet as J
    from flair_tpu_torch.models.parsenet import ParseNet as T

    kw = dict(in_size=64, out_size=64, min_feat_size=16, base_ch=16,
              res_depth=2, ch_range=(16, 64))
    x = uniform(11, 1, 64, 64, 3)
    jm = J(**kw)
    flat = perturbed(jax.jit(jm.init)(jax.random.PRNGKey(12), x), 13)
    j_out = np.asarray(jax.jit(lambda p, x: jm.apply(p, x)[0])(
        unflatten_params(flat), x))
    return (flat, j_out, T(**kw), lambda m: nhwc(m(nchw(x))[0]), "parsenet",
            dict(down_steps=2, up_steps=2, res_depth=2), None)


def case_retinaface(network):
    from flair_tpu.models.retinaface import RetinaFace as J
    from flair_tpu_torch.models.retinaface import RetinaFace as T

    x = uniform(14, 1, 64, 64, 3)
    jm = J(network=network)
    flat = perturbed(jax.jit(jm.init)(jax.random.PRNGKey(15), x), 16)
    j_out = np.concatenate([np.asarray(o) for o in jax.jit(jm.apply)(
        unflatten_params(flat), x)], -1)
    return (flat, j_out, T(network=network),
            lambda m: torch.cat(m(nchw(x)), -1).numpy(), "retinaface",
            dict(network=network), None)


def case_superslomo():
    from flair_tpu.models.superslomo import SuperSloMo as J
    from flair_tpu_torch.models.superslomo import SuperSloMo as T

    f0, f1 = uniform(17, 1, 32, 32, 3), uniform(18, 1, 32, 32, 3)
    jm = J()
    flat = random_flax_params(jm, 19, f0, f1)
    j_out = np.asarray(jax.jit(jm.apply)(unflatten_params(flat), f0, f1))
    return (flat, j_out, T(),
            lambda m: m(torch.from_numpy(f0), torch.from_numpy(f1)).numpy(),
            "superslomo", {}, None)


def case_amt():
    from flair_tpu.models.amt import AMT as J
    from flair_tpu_torch.models.amt import AMT as T

    kw = dict(channels=(16, 24, 32, 48), skip_channels=16, num_flows=2,
              corr_lvls=2, corr_radius=2)
    i0, i1 = uniform(20, 1, 32, 32, 3, lo=0.0), uniform(21, 1, 32, 32, 3,
                                                         lo=0.0)
    embt = np.array([0.5], np.float32)
    jm = J(**kw)
    flat = random_flax_params(jm, 22, i0, i1, embt)
    j_out = np.asarray(jax.jit(jm.apply)(unflatten_params(flat), i0, i1,
                                         embt))
    return (flat, j_out, T(**kw),
            lambda m: m(*map(torch.from_numpy, (i0, i1, embt))).numpy(),
            "amt", {}, None)


def case_davsr_aux():
    """HyPaNet and the SuperSloMo UNets: the part of DAVSRNet the map
    covers, run up to its first prox (the regularizer is left out of the
    map, and of the port's model here)."""
    from flair_tpu.models.davsr import DAVSRNet as J
    from flair_tpu_torch.models.davsr import DAVSRNet as T

    kw = dict(n_iter=2, h_nc=8, mid_channels=32, num_blocks=1, sf=(2, 2, 2),
              deform_groups=2)
    x = uniform(23, 1, 2, 32, 32, 3, lo=0.0)
    jm = J(**kw)
    flat = random_flax_params(jm, 24, x, return_after_first_prox=True)
    j_out = np.asarray(jax.jit(lambda p, v: jm.apply(
        p, v, return_after_first_prox=True))(unflatten_params(flat), x))
    model = T(**kw)
    del model.vsr

    def fwd(m):
        return m(torch.from_numpy(x), return_after_first_prox=True).numpy()

    return flat, j_out, model, fwd, "davsr_aux", {}, None


CASES = {
    "spynet": case_spynet,
    "bicubic_unet": case_bicubic_unet,
    "blur_unet": case_blur_unet,
    "codeformer": case_codeformer,
    "parsenet": case_parsenet,
    "retinaface_mobile0.25": lambda: case_retinaface("mobile0.25"),
    "retinaface_resnet50": lambda: case_retinaface("resnet50"),
    "superslomo": case_superslomo,
    "amt": case_amt,
    "davsr_aux": case_davsr_aux,
}
# the registry model whose checkpoints a map reads, where the names differ
MODEL_NAMES = {"davsr_aux": "davsr"}
NAME_MAPS = {
    "spynet": tconvert.spynet_names,
    "bicubic_unet": tconvert.bicubic_unet_names,
    "blur_unet": tconvert.blur_unet_names,
    "codeformer": tconvert.codeformer_names,
    "parsenet": tconvert.parsenet_names,
    "retinaface": tconvert.retinaface_names,
    "superslomo": tconvert.superslomo_names,
    "amt": tconvert.amt_names,
    "davsr_aux": tconvert.davsr_aux_names,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_upstream_map(case, tmp_path):
    flat, j_out, model, fwd, name, config, spynet_key = CASES[case]()
    inv = InverseReader(flat, spynet_key)
    NAME_MAPS[name](inv, **config)
    assert inv.used == set(flat), sorted(set(flat) - inv.used)[:5]
    state = inv.state_dict()

    # the JAX package's map rebuilds the flax variables exactly
    rebuilt = flatten_params(getattr(jconvert, f"convert_{name}")(
        state, **config))
    assert sorted(rebuilt) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(np.asarray(rebuilt[k]), flat[k],
                                      err_msg=k)

    # the port's map: the from_flax state_dict, through a .pth file too
    ours = getattr(tconvert, f"convert_{name}")(state, **config)
    via = tconvert.from_flax(flat)
    assert sorted(ours) == sorted(via)
    for k in via:
        assert torch.equal(ours[k], via[k]), k
    path = str(tmp_path / f"{name}.pth")
    torch.save({"params_ema": {k: torch.from_numpy(v)
                               for k, v in state.items()}}, path)
    if config in ({}, {"network": "resnet50"}):
        # load_params converts at the released configuration only
        loaded = tckpt.load_params(path, MODEL_NAMES.get(name, name))
        assert all(torch.equal(loaded[k], via[k]) for k in via)
    model.load_state_dict(ours, strict=True)
    with torch.no_grad():
        t_out = fwd(model.eval())
    assert t_out.shape == j_out.shape
    np.testing.assert_allclose(t_out, j_out,
                               atol=1e-4 * float(np.abs(j_out).max()))


def test_load_params_npz_and_errors(tmp_path):
    from flair_tpu_torch.models.sr3 import BicubicUNet

    path = os.path.join(ROOT, "goldens", "x8_s64", "params.npz")
    sd = tckpt.load_params(path, "bicubic_unet")
    flat = dict(np.load(path))
    assert sd.keys() == tconvert.from_flax_bicubic_unet(flat).keys()
    BicubicUNet(**BICUBIC_KW).load_state_dict(sd, strict=True)
    with pytest.raises(ValueError, match="flatten_params"):
        tckpt.load_params(str(tmp_path), "bicubic_unet")
    with pytest.raises(ValueError, match="no converter"):
        tckpt.load_params(path, "basicvsrpp")
    # flatten / unflatten round trip, and the generic mapping helper
    tree = tckpt.unflatten_params(flat)
    assert tckpt.flatten_params(tree).keys() == flat.keys()
    w = np.arange(24, dtype=np.float32).reshape(2, 3, 2, 2)
    out = tckpt.convert_torch_params(
        {"c.weight": w, "c.bias": np.ones(2)},
        {"c.weight": ("c/kernel", tckpt.t2j_conv2d), "c.bias": ("c/bias", None)})
    np.testing.assert_array_equal(out["c"]["kernel"], w.transpose(2, 3, 1, 0))
    with pytest.raises(KeyError):
        tckpt.convert_torch_params({}, {"x": ("x", None)})


def test_load_torch_state_dict_unwraps(tmp_path):
    sd = {"a.weight": torch.ones(2, 3), "a.bias": torch.zeros(2)}
    for wrap in (lambda s: s, lambda s: {"state_dict": s},
                 lambda s: {"params_ema": s}):
        path = str(tmp_path / "w.pt")
        torch.save(wrap(sd), path)
        got = tckpt.load_torch_state_dict(path)
        assert sorted(got) == sorted(sd)
        np.testing.assert_array_equal(got["a.weight"], np.ones((2, 3)))


SMALL_BLUR = dict(task="gaussian", image_size=64, num_channels=32,
                  num_res_blocks=1, attention_resolutions="2",
                  rnn_resolutions="1", channel_mult="1,2",
                  num_head_channels=8, timestep_respacing="25",
                  use_fp16=False)


@pytest.mark.parametrize("kw", [
    SMALL_BLUR, dict(SMALL_BLUR, learn_sigma=False, use_kl=True),
    dict(SMALL_BLUR, predict_xstart=True, rescale_learned_sigmas=True,
         timestep_respacing="ddim10"),
    dict(task="x8_bicubic", timestep_respacing="ddim25")])
def test_create_model_and_diffusion(kw):
    from flair_tpu.utils.config import (
        create_model_and_diffusion as j_create)
    from flair_tpu_torch.utils.config import (
        create_model_and_diffusion as t_create)

    tm, td = t_create(device="cpu", **kw)
    jm, jd = j_create(**kw)
    for f in ("betas", "alphas_cumprod", "sqrt_alphas_cumprod_prev",
              "posterior_variance", "posterior_log_variance_clipped",
              "posterior_mean_coef1", "posterior_mean_coef2",
              "timestep_map"):
        np.testing.assert_allclose(getattr(td, f).numpy(),
                                   np.asarray(getattr(jd, f)), rtol=1e-6,
                                   err_msg=f)
    for f in ("num_timesteps", "original_num_steps", "rescale_timesteps"):
        assert getattr(td, f) == getattr(jd, f)
    for f in ("model_mean_type", "model_var_type", "loss_type"):
        assert getattr(td, f).name == getattr(jd, f).name
    if kw["task"] == "x8_bicubic":
        return      # the full-width BicubicUNet: its shapes are tested apart
    x = jnp.zeros((1, 2, 64, 64, 3))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x,
                            jnp.zeros((1, 2), jnp.int32), x)
    flat = flatten_params(jax.tree_util.tree_map(
        lambda v: np.zeros(v.shape, np.float32), shapes))
    tm.load_state_dict(tconvert.from_flax_blur_unet(flat), strict=True)


def test_config_argparse_bridge():
    import argparse

    from flair_tpu.utils import config as jc
    from flair_tpu_torch.utils import config as tc

    assert tc.model_and_diffusion_defaults() == jc.model_and_diffusion_defaults()
    argv = ["--num_channels", "64", "--use_fp16", "no", "--task", "jpeg"]
    out = []
    for mod in (tc, jc):
        p = argparse.ArgumentParser()
        mod.add_dict_to_argparser(p, mod.model_and_diffusion_defaults())
        args = p.parse_args(argv)
        out.append(mod.args_to_dict(args, mod.model_and_diffusion_defaults()))
    assert out[0] == out[1] and out[0]["use_fp16"] is False
    with pytest.raises(argparse.ArgumentTypeError):
        tc.str2bool("maybe")
    with pytest.raises(ValueError, match="temporal_block"):
        tc.create_model_and_diffusion(device="cpu", **dict(
            SMALL_BLUR, temporal_block=False))
