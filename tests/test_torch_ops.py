"""Port ops (flair_tpu_torch/ops) against flair_tpu on seeded numpy inputs.

Embeddings, norms, separable resizes, warps and attention, each held to
≤1e-5 absolute error in float32; ``group_norm_act``'s plain version also
bit for bit against the models' old op sequence, its dispatch, and the
layout every norm site hands the kernel.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flair_tpu.ops import attention as j_attn
from flair_tpu.ops import embed as j_embed
from flair_tpu.ops import norms as j_norms
from flair_tpu.ops import resize as j_resize
from flair_tpu.ops import warp as j_warp
from flair_tpu_torch.models.common import GroupNorm32
from flair_tpu_torch.models.registry import get_model
from flair_tpu_torch.ops import attention as t_attn
from flair_tpu_torch.ops import embed as t_embed
from flair_tpu_torch.ops import norms as t_norms
from flair_tpu_torch.ops import resize as t_resize
from flair_tpu_torch.ops import warp as t_warp

torch.set_num_threads(1)
ATOL = 1e-5


def rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def close(t_out, j_out, atol=ATOL):
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("dim", [32, 33])
def test_embeddings(dim):
    lvl = np.random.default_rng(0).uniform(0, 1, 7).astype(np.float32)
    ts = np.array([0, 1, 5, 17, 999, 3.5], np.float32)
    close(t_embed.sr3_noise_embedding(torch.from_numpy(lvl), dim),
          j_embed.sr3_noise_embedding(jnp.asarray(lvl), dim))
    close(t_embed.timestep_embedding(torch.from_numpy(ts), dim),
          j_embed.timestep_embedding(jnp.asarray(ts), dim))


def test_group_norm_joint_over_frames():
    x = rand(1, 2, 3, 5, 6, 16, scale=3.0) + 1.0
    wgt, bias = rand(2, 16), rand(3, 16)
    close(t_norms.group_norm(torch.from_numpy(x), 4, torch.from_numpy(wgt),
                             torch.from_numpy(bias)),
          j_norms.group_norm(jnp.asarray(x), 4, jnp.asarray(wgt),
                             jnp.asarray(bias)))


@pytest.mark.parametrize("win,mode", [(3, "replicate"), (5, "replicate"),
                                      (3, "zeros")])
def test_shift_window_group_norm(win, mode):
    x = rand(4, 2, 6, 4, 5, 8, scale=2.0)
    wgt, bias = rand(5, 8), rand(6, 8)
    close(t_norms.shift_window_group_norm(
        torch.from_numpy(x), 2, win, torch.from_numpy(wgt),
        torch.from_numpy(bias), padding_mode=mode),
        j_norms.shift_window_group_norm(
            jnp.asarray(x), 2, win, jnp.asarray(wgt), jnp.asarray(bias),
            padding_mode=mode))


@pytest.mark.parametrize("name", ["resize_bicubic", "resize_bilinear",
                                  "resize_area", "resize_bilinear_aa"])
@pytest.mark.parametrize("out_hw", [(16, 24), (5, 7)])
def test_separable_resizes(name, out_hw):
    x = rand(7, 2, 3, 8, 12, 3)
    close(getattr(t_resize, name)(torch.from_numpy(x), out_hw),
          getattr(j_resize, name)(jnp.asarray(x), out_hw))


def test_resize_matrix_nearest():
    np.testing.assert_array_equal(t_resize.resize_matrix(13, 5, "nearest"),
                                  j_resize.resize_matrix(13, 5, "nearest"))


def test_grid_sample_zeros_align_corners():
    img = rand(8, 2, 9, 11, 4)
    grid = np.random.default_rng(9).uniform(-1.3, 1.3, (2, 6, 7, 2)).astype(
        np.float32)
    out = t_warp.grid_sample(torch.from_numpy(img).permute(0, 3, 1, 2),
                             torch.from_numpy(grid))
    close(out.permute(0, 2, 3, 1),
          j_warp.grid_sample(jnp.asarray(img), jnp.asarray(grid)))


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_flow_warp(padding_mode):
    img = rand(10, 2, 12, 10, 64)
    flow = rand(11, 2, 12, 10, 2, scale=3.0)   # carries samples off-image
    out = t_warp.flow_warp(torch.from_numpy(img).permute(0, 3, 1, 2),
                           torch.from_numpy(flow).permute(0, 3, 1, 2),
                           padding_mode=padding_mode)
    close(out.permute(0, 2, 3, 1),
          j_warp.flow_warp(jnp.asarray(img), jnp.asarray(flow),
                           padding_mode=padding_mode))


def test_dot_product_attention():
    q, k, v = (rand(s, 2, 10, 3, 8) for s in (12, 13, 14))
    close(t_attn.dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                       scale=0.3),
          j_attn.dot_product_attention(*map(jnp.asarray, (q, k, v)),
                                       scale=0.3))


@pytest.mark.parametrize("t,f", [(5, 3), (4, 7)])
def test_temporal_window_attention(t, f):
    q, k, v = (rand(s, 2, t, 3, 4, 16) for s in (15, 16, 17))
    k_pos = rand(18, f - 1, 16)
    close(t_attn.temporal_window_attention(
        *map(torch.from_numpy, (q, k, v, k_pos)), f, 4),
        j_attn.temporal_window_attention(
            *map(jnp.asarray, (q, k, v, k_pos)), f, 4))


GN_VARIANTS = ("plain", "silu", "pre_add", "scale_shift", "f32_out")


def gn_case(variant, cpg, dtype, seed=20):
    """A GroupNorm32 of 4 groups of ``cpg`` channels with seeded weights,
    an (N = B·T, C, H, W) channels_last x (B = 2, T = 3) in ``dtype``, and
    the variant's keywords: pre_add / scale / shift are (N, C), scale and
    shift halves of one (N, 2C) tensor as ResBlock's ``emb_proj`` gives
    them."""
    b, t, c = 2, 3, 4 * cpg
    norm = GroupNorm32(c, 4)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(1 + rand(seed, c, scale=0.1)))
        norm.bias.copy_(torch.from_numpy(rand(seed + 1, c, scale=0.1)))
    x = torch.from_numpy(rand(seed + 2, b * t, 4, 5, c, scale=3.0) + 1.0)
    x = x.to(dtype).permute(0, 3, 1, 2)            # channels_last NCHW
    kw = {}
    if variant != "plain":
        kw["act"] = "silu"
    if variant == "pre_add":
        kw["pre_add"] = torch.from_numpy(rand(seed + 3, b * t, c)).to(dtype)
    if variant == "scale_shift":
        emb = torch.from_numpy(rand(seed + 4, b * t, 2 * c, scale=0.3))
        kw["scale"], kw["shift"] = emb.to(dtype).chunk(2, dim=1)
    if variant == "f32_out":
        kw["out_dtype"] = torch.float32
    return norm, x, b, kw


def gn_before(norm, x, b, kw):
    """The models' sequence before ``group_norm_act``: GroupNorm32 as the
    plain ``group_norm`` of the (B, T, H, W, C) view, with the pre-add, the
    scale-shift and the SiLU around it in NCHW."""
    def old_norm(h):
        n, c, hh, ww = h.shape
        v = h.permute(0, 2, 3, 1).reshape(b, n // b, hh, ww, c)
        y = t_norms.group_norm(v, norm.num_groups, norm.weight, norm.bias)
        return y.reshape(n, hh, ww, c).permute(0, 3, 1, 2)

    col = lambda a: a[:, :, None, None]            # noqa: E731
    if "pre_add" in kw:
        h = old_norm(x + col(kw["pre_add"]).to(x.dtype))
    elif "scale" in kw:
        h = old_norm(x) * (1 + col(kw["scale"])) + col(kw["shift"])
    elif "out_dtype" in kw:
        h = old_norm(x.float())
    else:
        h = old_norm(x)
    return torch.nn.functional.silu(h) if "act" in kw else h


@pytest.mark.parametrize("cpg", [2, 4, 8, 64])
@pytest.mark.parametrize("variant", GN_VARIANTS)
def test_group_norm_act(variant, cpg):
    """group_norm_act's plain version is the models' old op sequence bit for
    bit in bf16, matches the JAX group_norm followed by the same operations
    in float32, and launches nothing on the CPU."""
    t_norms.group_norm_act.launches = 0
    with torch.no_grad():
        norm, x, b, kw = gn_case(variant, cpg, torch.bfloat16)
        out = norm(x, b, **kw)
        assert out.dtype == kw.get("out_dtype", torch.bfloat16)
        assert torch.equal(out, gn_before(norm, x, b, kw))

        norm, x, b, kw = gn_case(variant, cpg, torch.float32)
        n, c, hh, ww = x.shape
        v = x.permute(0, 2, 3, 1).reshape(b, n // b, hh, ww, c)
        out = t_norms.group_norm_act(v, norm.num_groups, norm.weight,
                                     norm.bias, **kw)

    def per(a):
        return jnp.asarray(a.numpy()).reshape(b, n // b, 1, 1, c)
    xj = jnp.asarray(v.numpy())
    if "pre_add" in kw:
        xj = xj + per(kw["pre_add"])
    ref = j_norms.group_norm(xj, norm.num_groups,
                             jnp.asarray(norm.weight.detach().numpy()),
                             jnp.asarray(norm.bias.detach().numpy()))
    if "scale" in kw:
        ref = ref * (1 + per(kw["scale"])) + per(kw["shift"])
    if "act" in kw:
        ref = ref * (1 / (1 + jnp.exp(-ref)))
    close(out, ref)
    assert t_norms.group_norm_act.launches == 0


@pytest.mark.parametrize("case", ["grad", "frame_group", "odd_width",
                                  "wide", "f32_to_bf16"])
def test_group_norm_act_dispatch(case, monkeypatch):
    """With every tensor taken for a card's and the kernel's launch replaced
    by the plain version: a no-grad call reaches the launch; a call that
    records autograd reaches it too, through the autograd Function whose
    backward (the plain version's float32 VJP) gives plain autograd's
    gradients; a frame group takes the plain version with no launch; C % 8
    != 0, C > 2048 and a float32 x with a bf16 result raise before any."""
    launched = []

    def fake_launch(x, g, weight, bias, pre, scale, shift, act, out_dtype,
                    eps):
        launched.append(x)
        return t_norms.group_norm_act_plain(
            x, g, weight, bias, pre_add=pre, scale=scale, shift=shift,
            act=act, out_dtype=out_dtype, eps=eps)

    monkeypatch.setattr(t_norms, "_on_card", lambda x: True)
    monkeypatch.setattr(t_norms, "_launch", fake_launch)
    monkeypatch.setattr(t_norms, "all_reduce_mean", lambda m, group: m)
    cpg = {"odd_width": 3, "wide": 514}.get(case, 4)   # C = 12, 2056 or 16
    norm, x, b, kw = gn_case("scale_shift", cpg, torch.float32)
    v = x.permute(0, 2, 3, 1).reshape(b, -1, *x.shape[2:], x.shape[1])
    v = v.contiguous()
    args = (v, norm.num_groups, norm.weight, norm.bias)
    if case in ("odd_width", "wide", "f32_to_bf16"):
        if case == "f32_to_bf16":
            kw["out_dtype"] = torch.bfloat16
        with pytest.raises(TypeError if case == "f32_to_bf16"
                           else ValueError):
            t_norms.group_norm_act(*args, **kw)
        assert not launched
        return
    group = object() if case == "frame_group" else None
    with torch.no_grad():
        expect = t_norms.group_norm_act_plain(*args, group=group, **kw)
        t_norms.group_norm_act(*args, **kw)
        assert len(launched) == 1                  # the patch is reached
        launched.clear()
    if case == "grad":
        v.requires_grad_()
        kw["scale"], kw["shift"] = (kw[k].clone().requires_grad_()
                                    for k in ("scale", "shift"))
    with torch.set_grad_enabled(case == "grad"):
        out = t_norms.group_norm_act(*args, group=group, **kw)
    assert torch.equal(out.detach(), expect)
    if case == "frame_group":
        assert not launched
        return
    assert len(launched) == 1 and out.requires_grad
    wrt = [v, norm.weight, norm.bias, kw["scale"], kw["shift"]]
    grads = torch.autograd.grad(out.square().sum(), wrt)
    plain = t_norms.group_norm_act_plain(*args, **kw)
    for g, r in zip(grads, torch.autograd.grad(plain.square().sum(), wrt)):
        torch.testing.assert_close(g, r)


@pytest.mark.parametrize("name", ["bicubic_unet", "blur_unet"])
def test_norm_sites_take_channels_last(name):
    """Every GroupNorm32 of a small BicubicUNet / BlurUNet runs once a
    denoiser call, on input that is contiguous channels-last, the layout
    the kernel reads (its wrapper raises on any other)."""
    kw = (dict(inner_channel=32, norm_groups=16, channel_mults=(1, 2),
               attn_res=(16,), vsrpp_res=(32,), image_size=32, num_frames=3,
               head_dim=8)
          if name == "bicubic_unet" else
          dict(image_size=32, in_channels=6, model_channels=32,
               out_channels=6, num_res_blocks=1, attention_resolutions=(2,),
               rnn_resolutions=(1,), channel_mult=(1, 2), num_heads=1,
               num_head_channels=8, use_scale_shift_norm=True,
               temporal_frames=3))
    torch.manual_seed(0)
    model = get_model(name, **kw).eval()
    calls = {}

    def hook(mod, args):
        x = args[0]
        assert x.permute(0, 2, 3, 1).is_contiguous()
        calls[mod] = calls.get(mod, 0) + 1

    norms = [m for m in model.modules() if isinstance(m, GroupNorm32)]
    for m in norms:
        m.register_forward_pre_hook(hook)
    rng = np.random.default_rng(0)
    x, low = (torch.from_numpy(rng.uniform(-1, 1, (1, 3, 32, 32, 3))
                               .astype(np.float32)) for _ in range(2))
    with torch.no_grad():
        if name == "bicubic_unet":
            model(x, torch.full((1, 3), 0.5), low)
        else:
            model(x, torch.full((1, 3), 10), low)
    assert len(norms) > 10 and calls == {m: 1 for m in norms}
