"""Port models (flair_tpu_torch/models) against flair_tpu.

Flax params are initialised, perturbed with seeded noise so that the
zero-initialised layers (offset_out, conv_last, the gates, the projections)
are active, and carried into the port by ``from_flax`` /
``from_flax_bicubic_unet``. Forwards agree to ≤1e-4 relative (max abs
error over max abs output) in float32.
"""

import numpy as np
import pytest
import torch

import jax

from flair_tpu.utils.checkpoint import flatten_params, unflatten_params
from flair_tpu_torch.utils.convert import from_flax, from_flax_bicubic_unet

torch.set_num_threads(1)
RTOL = 1e-4
ROOT = __import__("os").path.dirname(__import__("os").path.dirname(
    __import__("os").path.abspath(__file__)))


def perturb(flat, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return {k: (np.asarray(v) + rng.standard_normal(v.shape) * scale
                ).astype(np.float32) for k, v in flat.items()}


def rel_err(t_out, j_out):
    j = np.asarray(j_out)
    return float(np.abs(t_out.detach().numpy() - j).max() / np.abs(j).max())


def smooth_flows(seed, b, n, h, w, amp):
    rng = np.random.default_rng(seed)
    yy = np.arange(h)[:, None] / h
    xx = np.arange(w)[None, :] / w
    out = np.zeros((b, n, h, w, 2), np.float32)
    for i in range(b):
        for j in range(n):
            for c in range(2):
                ph = rng.uniform(0, 6.28)
                out[i, j, :, :, c] = amp * np.sin(2 * np.pi * (yy + 2 * xx) + ph)
    return out


def test_spynet():
    from flair_tpu.models.spynet import SPyNet as JSPyNet
    from flair_tpu_torch.models.spynet import SPyNet

    rng = np.random.default_rng(0)
    ref = rng.uniform(0, 1, (1, 32, 32, 3)).astype(np.float32)
    supp = np.roll(ref, 2, axis=2)
    jm = JSPyNet()
    flat = perturb(flatten_params(jax.jit(jm.init)(jax.random.PRNGKey(0), ref, supp)),
                   1, 0.01)
    j_out = jax.jit(jm.apply)(unflatten_params(flat), ref, supp)
    tm = SPyNet()
    tm.load_state_dict(from_flax(flat))
    t_out = tm(torch.from_numpy(ref).permute(0, 3, 1, 2),
               torch.from_numpy(supp).permute(0, 3, 1, 2))
    assert rel_err(t_out.permute(0, 2, 3, 1), j_out) < RTOL


def test_compute_flow_bidirectional():
    """Both directions' flows of a 3-frame clip in [-1, 1] (clamped to
    [0, 1] first; values past the range included), through
    ``get_model("spynet")`` (registered in both packages)."""
    from flair_tpu.models.registry import get_model as j_get_model
    from flair_tpu.models.spynet import compute_flow_bidirectional as j_flows
    from flair_tpu_torch.models.registry import get_model
    from flair_tpu_torch.models.spynet import compute_flow_bidirectional

    rng = np.random.default_rng(2)
    base = rng.uniform(-1.1, 1.1, (1, 1, 32, 32, 3)).astype(np.float32)
    lqs = np.concatenate([np.roll(base, s, axis=3) for s in (0, 1, 3)], 1)
    jm = j_get_model("spynet")
    flat = perturb(flatten_params(jax.jit(jm.init)(
        jax.random.PRNGKey(0), lqs[:, 0], lqs[:, 1])), 3, 0.01)
    j_fwd, j_bwd = jax.jit(lambda p, v: j_flows(jm, p, v))(
        unflatten_params(flat), lqs)
    tm = get_model("spynet")
    tm.load_state_dict(from_flax(flat), strict=True)
    with torch.no_grad():
        fwd, bwd = compute_flow_bidirectional(tm, torch.from_numpy(lqs))
    assert fwd.shape == bwd.shape == (1, 2, 32, 32, 2)
    assert rel_err(fwd, j_fwd) < RTOL and rel_err(bwd, j_bwd) < RTOL


def test_temporal_attention():
    from flair_tpu.models.temporal import TemporalAttention as JTA
    from flair_tpu_torch.models.temporal import TemporalAttention

    b, t, h, w, c = 2, 5, 4, 6, 64
    x = np.random.default_rng(2).standard_normal((b, t, h, w, c)).astype(
        np.float32)
    jm = JTA(c, num_frames=3, num_heads=8, num_head_channels=8)
    flat = perturb(flatten_params(jax.jit(jm.init)(jax.random.PRNGKey(1), x)), 3)
    j_out = jm.apply(unflatten_params(flat), x)
    tm = TemporalAttention(c, num_frames=3, num_heads=8, num_head_channels=8)
    tm.load_state_dict(from_flax(flat))
    xt = torch.from_numpy(x).reshape(b * t, h, w, c).permute(0, 3, 1, 2)
    t_out = tm(xt, b).permute(0, 2, 3, 1).reshape(b, t, h, w, c)
    assert rel_err(t_out, j_out) < RTOL


@pytest.mark.parametrize("c,t", [(32, 4), (64, 3)])
def test_basicvsrpp(c, t):
    """Second-order propagation with the DCN at Cin = 2C ∈ {64, 128},
    16 deform groups, offsets from a perturbed (non-zero) offset_out — so
    the offset_out channel permutation and the raw-block order are live."""
    from flair_tpu.models.vsrpp import BasicVSRPP as JV
    from flair_tpu_torch.models.vsrpp import BasicVSRPP

    b, h, w = 1, 12, 16
    hid = np.random.default_rng(4).standard_normal((b, t, h, w, c)).astype(
        np.float32)
    ff = smooth_flows(5, b, t - 1, h, w, 2.5)
    fb = smooth_flows(6, b, t - 1, h, w, 2.5)
    jm = JV(c, max_residue_magnitude=5.0, deform_groups=16,
            dcn_patch_size=None)
    flat = perturb(flatten_params(jax.jit(jm.init)(jax.random.PRNGKey(2), hid, ff, fb)),
                   7, 0.03)
    j_out = jax.jit(jm.apply)(unflatten_params(flat), hid, ff, fb)
    tm = BasicVSRPP(c, max_residue_magnitude=5.0, deform_groups=16)
    tm.load_state_dict(from_flax(flat))
    ht = torch.from_numpy(hid).reshape(b * t, h, w, c).permute(0, 3, 1, 2)
    to_t = lambda f: torch.from_numpy(f).permute(0, 1, 4, 2, 3).contiguous()  # noqa: E731
    with torch.no_grad():
        t_out = tm(ht.contiguous(memory_format=torch.channels_last), b,
                   to_t(ff), to_t(fb))
    t_out = t_out.permute(0, 2, 3, 1).reshape(b, t, h, w, c)
    assert rel_err(t_out, j_out) < RTOL


def test_bicubic_unet_goldens_config():
    """BicubicUNet at the goldens' config (tests/test_goldens.py:56-61),
    weights from goldens/x8_s64 perturbed, flows computed inside."""
    from flair_tpu.models.sr3 import BicubicUNet as JU
    from flair_tpu_torch.models.sr3 import BicubicUNet

    kw = dict(inner_channel=32, norm_groups=16, channel_mults=(1, 2),
              attn_res=(32,), vsrpp_res=(64,), image_size=64, res_blocks=1,
              num_frames=3, head_dim=8)
    flat = perturb(dict(np.load(f"{ROOT}/goldens/x8_s64/params.npz")), 8,
                   0.02)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((1, 3, 64, 64, 3)).astype(np.float32)
    low = np.clip(rng.standard_normal((1, 3, 64, 64, 3)) * 0.5, -1, 1
                  ).astype(np.float32)
    lvl = np.array([[0.3, 0.3, 0.3]], np.float32)
    j_out = jax.jit(JU(**kw).apply)(unflatten_params(flat), x, lvl, low)
    tm = BicubicUNet(**kw)
    tm.load_state_dict(from_flax_bicubic_unet(flat))
    with torch.no_grad():
        t_out = tm(*map(torch.from_numpy, (x, lvl, low)))
    assert t_out.shape == (1, 3, 64, 64, 3)
    assert rel_err(t_out, j_out) < RTOL


def test_offset_perm_matches_flair_tpu():
    from flair_tpu.models.vsrpp import _offset_perm as j_perm
    from flair_tpu_torch.models.vsrpp import _offset_perm

    for g in (2, 16):
        assert list(_offset_perm(g)) == list(j_perm(g))
