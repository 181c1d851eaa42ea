"""The gaussian / jpeg path of the port against flair_tpu, in float32.

- imresize kernel synthesis (``imresize_kernel``, ``center_mass``,
  ``calc_strides``) against the JAX package's host code (≤1e-6);
- the depthwise filter in its four paddings (reflect by ``jnp.pad``'s
  rule at images narrower than the pad), ``imresize_efficient`` with and
  without zero padding in JAX's call form, and PseudoSR ``A`` /
  ``A_pinv`` / ``Lambda`` at ×4 with the demo blur kernel (≤1e-4);
- the 8×8 block DCT and the JPEG codec at qf 60: the quantised
  coefficients may differ only where one sits at a rounding tie that float
  sums break differently (at most 1e-3 of them), and the round-trip agrees
  to a mean abs of ≤1e-4;
- ``ResBlock`` up/down, ``AttentionBlock``, ``AttentionBottleBlock`` and
  ``BlurUNet`` at the goldens' config, each loaded through
  ``from_flax_blur_unet`` (≤1e-4 relative: max abs error over max abs
  output).

The JAX BlurUNet is built with ``dcn_patch_size=None``, its exact DCN: its
default patch of 16 pixels drops samples whose residue exceeds 6 pixels,
which the max residue magnitude of 10 allows, while the port's DCN is exact.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flair_tpu.utils.checkpoint import flatten_params, unflatten_params
from flair_tpu_torch.utils.convert import from_flax_blur_unet

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-4
GOLDEN_KW = dict(image_size=64, in_channels=6, model_channels=32,
                 out_channels=6, num_res_blocks=1, attention_resolutions=(2,),
                 rnn_resolutions=(1,), channel_mult=(1, 2), num_heads=1,
                 num_head_channels=8, use_scale_shift_norm=True,
                 temporal_frames=5)


def rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def perturb(flat, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return {k: (np.asarray(v) + rng.standard_normal(v.shape) * scale
                ).astype(np.float32) for k, v in flat.items()}


def rel_err(t_out, j_out):
    j = np.asarray(j_out)
    return float(np.abs(np.asarray(t_out) - j).max() / np.abs(j).max())


def demo_kernel():
    from flair_tpu_torch.operators.factory import load_blur_kernel
    return load_blur_kernel(3)


# ---------------------------------------------------------------- resize ----


@pytest.mark.parametrize("kernel,indx", [
    (None, 0), ("demo", 10), ("gauss", 0)])
def test_imresize_kernel_matches_flair_tpu(kernel, indx):
    from flair_tpu.ops import resize as jr
    from flair_tpu_torch.ops import resize as tr

    blur = {None: None, "demo": demo_kernel(),
            "gauss": np.outer(*[np.exp(-np.arange(-2, 3) ** 2 / 2.0)] * 2)}[kernel]
    if kernel == "gauss":
        blur = blur / blur.sum()
    kt, pre_t, post_t = tr.imresize_kernel(4, blur, indx)
    kj, pre_j, post_j = jr.imresize_kernel(4, blur, indx)
    assert kt.dtype == np.float32 and kt.shape == kj.shape
    np.testing.assert_allclose(kt, kj, atol=1e-6)
    np.testing.assert_array_equal(pre_t, pre_j)
    np.testing.assert_array_equal(post_t, post_j)


@pytest.mark.parametrize("sf", [2, 3, 4])
def test_center_mass_and_strides_match_flair_tpu(sf):
    from flair_tpu.ops import resize as jr
    from flair_tpu_torch.ops import resize as tr

    k = demo_kernel()
    np.testing.assert_allclose(tr.center_mass(k, sf), jr.center_mass(k, sf),
                               atol=1e-6)
    for shape, factor, align in (((0, 0), sf, False), ((49, 49), 1.0 / sf, True),
                                 ((50, 48), 1.0 / sf, True)):
        for a, b in zip(tr.calc_strides(shape, factor, align),
                        jr.calc_strides(shape, factor, align)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(tr.cubic_kernel_2d(sf), jr.cubic_kernel_2d(sf),
                               atol=1e-12)


@pytest.mark.parametrize("padding,correlate,hw,khw,atol", [
    pytest.param("reflect", False, (20, 18), (7, 5), 1e-5, id="reflect-False"),
    pytest.param("reflect", True, (20, 18), (7, 5), 1e-5, id="reflect-True"),
    pytest.param("edge", True, (20, 18), (7, 5), 1e-5, id="edge-True"),
    pytest.param("zero", False, (20, 18), (7, 5), 1e-5, id="zero-False"),
    # the ×4 demo kernel (9×9, unit sum) on images in [-1, 1]: the valid
    # output, and images no wider than the kernel's half-width, reflected
    # again as jnp.pad does
    pytest.param("none", False, (16, 16), "demo", 1e-6, id="none-False"),
    pytest.param("reflect", False, (4, 4), "demo", 1e-6, id="reflect-4x4"),
    pytest.param("reflect", True, (5, 5), "demo", 1e-6, id="reflect-5x5"),
    pytest.param("edge", False, (4, 4), "demo", 1e-6, id="edge-4x4"),
    pytest.param("zero", False, (5, 5), "demo", 1e-6, id="zero-5x5")])
def test_depthwise_filter2d(padding, correlate, hw, khw, atol):
    from flair_tpu.ops.resize import depthwise_filter2d as jf
    from flair_tpu_torch.ops.resize import depthwise_filter2d as tf
    from flair_tpu_torch.ops.resize import imresize_kernel

    if khw == "demo":
        x = np.tanh(rand(1, 2, *hw, 3))
        k = imresize_kernel(4, demo_kernel(), 10)[0]
        assert k.shape == (9, 9)
    else:
        x = rand(1, 2, *hw, 3)
        k = rand(2, *khw)
    out = tf(torch.from_numpy(x), k, padding=padding, correlate=correlate)
    ref = jf(jnp.asarray(x), k, padding=padding, correlate=correlate)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=atol)


@pytest.mark.parametrize("use_zero_padding", [False, True])
def test_imresize_efficient_padding(use_zero_padding):
    """JAX's call ``imresize_efficient(x, k, f, pre, post,
    use_zero_padding=...)`` and ``PseudoSR.A(hr, use_zero_padding=...)``,
    at 4² (below the 9×9 kernel's half-width) and 64²."""
    from flair_tpu.operators.factory import get_operator as jget
    from flair_tpu.ops.resize import imresize_efficient as jf
    from flair_tpu.ops.resize import imresize_kernel
    from flair_tpu_torch.operators.factory import get_operator as tget
    from flair_tpu_torch.ops.resize import imresize_efficient as tf

    k, pre, post = imresize_kernel(4, demo_kernel(), 10)
    for seed, size in ((6, 4), (7, 64)):
        x = np.tanh(rand(seed, 1, size, size, 3))
        out = tf(torch.from_numpy(x), k, 4, pre, post,
                 use_zero_padding=use_zero_padding)
        ref = jf(jnp.asarray(x), k, 4, pre, post,
                 use_zero_padding=use_zero_padding)
        assert out.shape == ref.shape
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    op_t, op_j = tget("gaussian", 64, device="cpu"), jget("gaussian", 64)
    out = op_t.A(torch.from_numpy(x), use_zero_padding=use_zero_padding)
    ref = op_j.A(jnp.asarray(x), use_zero_padding=use_zero_padding)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("sf,kernel", [(2, None), (4, "demo")])
def test_matlab_imresize_matches_flair_tpu(sf, kernel):
    from flair_tpu.ops.resize import matlab_imresize as jm
    from flair_tpu_torch.ops.resize import matlab_imresize as tm

    blur, indx = (None, 0) if kernel is None else (demo_kernel(), 10)
    x = rand(20, 2, 32, 24, 3)
    out = tm(torch.from_numpy(x), sf, blur, indx)
    ref = jm(jnp.asarray(x), sf, blur, indx)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


# ------------------------------------------------------------- pseudo SR ----


@pytest.fixture(scope="module")
def pseudo_sr_pair():
    from flair_tpu.operators.factory import get_operator as jget
    from flair_tpu_torch.operators.factory import get_operator as tget

    return tget("gaussian", 64, device="cpu"), jget("gaussian", 64)


def test_pseudo_sr_filters_match_flair_tpu(pseudo_sr_pair):
    op_t, op_j = pseudo_sr_pair
    np.testing.assert_allclose(op_t.ds_kernel, op_j.ds_kernel, atol=1e-6)
    np.testing.assert_allclose(op_t.inv_hth, op_j.inv_hth, atol=1e-6)
    np.testing.assert_array_equal(op_t.pre_stride, op_j.pre_stride)
    assert op_t.inv_hth.shape == op_j.inv_hth.shape


@pytest.mark.parametrize("what", ["A", "A_pinv_y", "A_pinv_xy"])
def test_pseudo_sr_a_and_pinv(pseudo_sr_pair, what):
    """×4 with the demo kernel at the goldens' 64² (``A`` reflect-pads by
    half the 9×9 kernel; the 39×39 inverse filter edge-pads a 16² frame by
    19, which only replicate padding allows)."""
    op_t, op_j = pseudo_sr_pair
    x = np.tanh(rand(3, 2, 64, 64, 3))
    y = np.tanh(rand(4, 2, 16, 16, 3))
    if what == "A":
        out, ref = op_t.A(torch.from_numpy(x)), op_j.A(jnp.asarray(x))
    elif what == "A_pinv_y":
        out, ref = op_t.A_pinv(torch.from_numpy(y)), op_j.A_pinv(jnp.asarray(y))
    else:
        out = op_t.A_pinv(torch.from_numpy(y), torch.from_numpy(x))
        ref = op_j.A_pinv(jnp.asarray(y), jnp.asarray(x))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_pseudo_sr_lambdas(pseudo_sr_pair):
    op_t, op_j = pseudo_sr_pair
    v = rand(5, 2, 8, 8, 3)
    for a, sy, st in ((1.0, 0.1, 0.05), (1.0, 0.1, 0.5)):
        for f in ("Lambda", "Lambda_noise"):
            out = getattr(op_t, f)(torch.from_numpy(v), a, sy, st, 0.3)
            ref = getattr(op_j, f)(jnp.asarray(v), a, sy, st, 0.3)
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


# ------------------------------------------------------------------ jpeg ----


def test_block_dct_and_color_matrices():
    from flair_tpu.ops import dct as jd
    from flair_tpu.ops import jpeg as jj
    from flair_tpu_torch.ops import dct as td
    from flair_tpu_torch.ops import jpeg as tj

    x = rand(6, 2, 3, 16, 24) * 50
    c = td.block_dct8(torch.from_numpy(x))
    np.testing.assert_allclose(c.numpy(), np.asarray(jd.block_dct8(
        jnp.asarray(x))), atol=1e-3)
    np.testing.assert_allclose(td.block_idct8(c).numpy(), x, atol=1e-3)
    np.testing.assert_allclose(td.dct_matrix(8, "idct"),
                               jd.dct_matrix(8, "idct"), atol=1e-12)
    rgb = np.random.default_rng(7).uniform(0, 255, (4, 5, 3)).astype(np.float32)
    ycc = tj.rgb_to_ycbcr(torch.from_numpy(rgb))
    np.testing.assert_allclose(ycc.numpy(), np.asarray(jj.rgb_to_ycbcr(
        jnp.asarray(rgb))), atol=1e-4)
    np.testing.assert_allclose(tj.ycbcr_to_rgb(ycc).numpy(), rgb, atol=0.05)
    for qf in (10, 60, 95):
        for a, b in zip(tj.quantization_matrix(qf), jj.quantization_matrix(qf)):
            np.testing.assert_array_equal(a, b)


def test_jpeg_round_trip_qf60():
    """Quantised coefficients agree except at rounding ties (flip fraction
    ≤1e-3; the ties are where float sums in the two packages differ in the
    last bit); the decoded images agree to a mean abs ≤1e-4."""
    from flair_tpu.ops import jpeg as jj
    from flair_tpu_torch.ops import jpeg as tj

    yy, xx = np.meshgrid(np.arange(32) / 32, np.arange(48) / 48, indexing="ij")
    phase = np.random.default_rng(8).uniform(0, 6.28, (2, 1, 1, 3))
    x = (0.8 * np.sin(2 * np.pi * (yy + 2 * xx)[None, :, :, None] + phase)
         + rand(8, 2, 32, 48, 3, scale=0.05)).astype(np.float32)
    pt = tj.jpeg_encode(torch.from_numpy(x), 60)
    pj = jj.jpeg_encode(jnp.asarray(x), 60)
    n_coef = sum(p.numel() for p in pt)
    flips = sum(int((a.numpy() != np.asarray(b)).sum()) for a, b in zip(pt, pj))
    assert pt[0].shape == (2, 32, 48, 1) and pt[1].shape == (2, 16, 24, 2)
    assert flips / n_coef <= 1e-3, (flips, n_coef)
    out = tj.jpeg_decode(pt, 60).numpy()
    ref = np.asarray(jj.jpeg_decode(pj, 60))
    assert np.mean(np.abs(out - ref)) <= 1e-4


def test_pseudo_sr_pinv_with_jpeg(pseudo_sr_pair):
    op_t, op_j = pseudo_sr_pair
    x = np.tanh(rand(9, 1, 64, 64, 3))
    y = np.tanh(rand(10, 1, 16, 16, 3))
    out = op_t.A_pinv(torch.from_numpy(y), torch.from_numpy(x), jpeg_qf=60)
    ref = op_j.A_pinv(jnp.asarray(y), jnp.asarray(x), jpeg_qf=60)
    assert np.mean(np.abs(out.numpy() - np.asarray(ref))) <= 1e-4


# ---------------------------------------------------------------- blocks ----


def _init_perturbed(module, seed, *args):
    flat = flatten_params(jax.jit(module.init)(jax.random.PRNGKey(seed), *args))
    return perturb(flat, seed + 1)


@pytest.mark.parametrize("mode", ["up", "down", "none"])
def test_resblock_up_down(mode):
    from flair_tpu.models.blocks import ResBlock as JR
    from flair_tpu_torch.models.blocks import ResBlock

    b, t, h, w, cin, cout, e = 1, 2, 8, 8, 32, 64, 48
    x, emb = rand(11, b, t, h, w, cin), rand(12, b, t, e)
    kw = dict(up=mode == "up", down=mode == "down")
    jm = JR(cout, use_scale_shift_norm=True, **kw)
    flat = _init_perturbed(jm, 13, x, emb)
    j_out = jm.apply(unflatten_params(flat), x, emb)
    tm = ResBlock(cin, cout, e, use_scale_shift_norm=True, **kw)
    tm.load_state_dict(from_flax_blur_unet(flat))
    xt = torch.from_numpy(x).reshape(b * t, h, w, cin).permute(0, 3, 1, 2)
    with torch.no_grad():
        out = tm(xt, torch.from_numpy(emb).reshape(b * t, e), b)
    out = out.permute(0, 2, 3, 1).reshape(j_out.shape)
    assert rel_err(out.numpy(), j_out) < RTOL


@pytest.mark.parametrize("bottle", [False, True])
def test_attention_blocks(bottle):
    """Per-head (q, k, v) interleave of the packed qkv Dense, 1/√Dh scale;
    the bottleneck adds emb_proj(silu(emb)) before the projection."""
    from flair_tpu.models import blocks as jb
    from flair_tpu_torch.models import blocks as tb

    b, t, h, w, c, e = 1, 3, 6, 5, 64, 48
    x, emb = rand(14, b, t, h, w, c), rand(15, b, t, e)
    if bottle:
        jm = jb.AttentionBottleBlock(c, 1, 16)
        flat = _init_perturbed(jm, 16, x, emb)
        j_out = jm.apply(unflatten_params(flat), x, emb)
        tm = tb.AttentionBottleBlock(c, e, num_heads=1, num_head_channels=16)
    else:
        jm = jb.AttentionBlock(c, 1, 16)
        flat = _init_perturbed(jm, 16, x)
        j_out = jm.apply(unflatten_params(flat), x)
        tm = tb.AttentionBlock(c, num_heads=1, num_head_channels=16)
    tm.load_state_dict(from_flax_blur_unet(flat))
    xt = torch.from_numpy(x).reshape(b * t, h, w, c).permute(0, 3, 1, 2)
    with torch.no_grad():
        if bottle:
            out = tm(xt, torch.from_numpy(emb).reshape(b * t, e), b)
        else:
            out = tm(xt, b)
    out = out.permute(0, 2, 3, 1).reshape(j_out.shape)
    assert rel_err(out.numpy(), j_out) < RTOL


def test_blur_unet_goldens_config():
    """BlurUNet at the goldens' config (tests/test_goldens.py:125-131),
    weights from goldens/gaussian_s64 perturbed so the zero-initialised
    layers (offset_out, projections, out_conv) are live; flows computed
    inside; 6 output channels (ε and the variance fractions)."""
    from flair_tpu.models.adm import BlurUNet as JB
    from flair_tpu_torch.models.adm import BlurUNet

    flat = perturb(dict(np.load(f"{ROOT}/goldens/gaussian_s64/params.npz")),
                   17, 0.02)
    x = rand(18, 1, 3, 64, 64, 3)
    low = np.clip(rand(19, 1, 3, 64, 64, 3, scale=0.5), -1, 1)
    ts = np.array([[500, 500, 500]], np.int32)
    j_out = jax.jit(JB(**GOLDEN_KW, dcn_patch_size=None).apply)(
        unflatten_params(flat), x, ts, low)
    tm = BlurUNet(**GOLDEN_KW)
    tm.load_state_dict(from_flax_blur_unet(flat))
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(ts).long(),
                 torch.from_numpy(low))
    assert out.shape == (1, 3, 64, 64, 6) and out.dtype == torch.float32
    assert rel_err(out.numpy(), j_out) < RTOL


def test_blur_unet_full_width_registry_shapes():
    """The registry defaults build the full-width model: the flax scope
    names, 3×3×3 temporal convs, M = 10 VSR++ at 512² and 256², attention
    at ds 16/32/64 with 64-channel heads, and the f32 output block."""
    from flair_tpu_torch.models.registry import get_model

    m = get_model("blur_unet", dtype=torch.bfloat16)
    sd = m.state_dict()
    assert sd["in_0_0_res3d.in_conv.weight"].shape == (64, 64, 3, 3, 3)
    assert sd["in_4_0_attn.qkv.weight"].shape == (768, 256)
    assert m.in_4_0_attn.heads == 4 and m.mid_attn.heads == 8
    assert m.in_0_0_vsrpp.max_residue_magnitude == 10.0
    assert m.in_1_1_vsrpp.deform_groups == 16
    assert sd["out_conv.weight"].shape == (6, 64, 3, 3)
    assert m.out_conv.dtype == torch.float32 and m.conv_in.dtype == torch.bfloat16
    n_attn = sum(1 for k in sd if k.endswith("_attn.qkv.weight")
                 or k == "mid_attn.qkv.weight")
    n_vsrpp = len({k.split(".")[0] for k in sd if "_vsrpp." in k})
    assert (n_attn, n_vsrpp) == (16, 10)
