"""The port's face models against flair_tpu, in float32, weights carried
across by ``from_flax_codeformer`` / ``from_flax_parsenet`` with strict
loads.

- CodeFormer at test_face_models.py's tiny config (32², two levels) and at
  a six-level 64² config, for w ∈ {0, 1}, AdaIN on and off, and
  ``code_only``: logits and outputs within 1e-4, and the SAME argmax codes
  (the message reports the smallest top-1 / top-2 logit margin);
- VQAutoEncoder with the nearest and the Gumbel quantiser: output, loss
  and code indices;
- ParseNet with non-trivial ``batch_stats``, leaky-relu and prelu: logits
  and image within 1e-4 of the largest |value| (the logits reach ~10²),
  and the share of pixels whose class agrees, among those whose top-1 /
  top-2 margin exceeds 1e-3.

The flax parameters are perturbed by seeded noise (every leaf, so no
GroupNorm scale stays at 1 and no bias at 0) before they cross.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flair_tpu.models.codeformer import CodeFormer as JCodeFormer
from flair_tpu.models.codeformer import VQAutoEncoder as JVQ
from flair_tpu.models.parsenet import ParseNet as JParseNet
from flair_tpu.utils.checkpoint import flatten_params, unflatten_params
from flair_tpu_torch.models.codeformer import CodeFormer, VQAutoEncoder
from flair_tpu_torch.models.parsenet import ParseNet
from flair_tpu_torch.utils.convert import (
    from_flax_codeformer, from_flax_parsenet)

torch.set_num_threads(1)
ATOL = 1e-4
CF_CONFIGS = {
    "tiny": (dict(dim_embd=64, n_head=4, n_layers=2, codebook_size=32,
                  latent_size=256, connect_list=("32",), nf=32,
                  ch_mult=(1, 2)), 32),
    "six_level": (dict(dim_embd=64, n_head=4, n_layers=2, codebook_size=64,
                       latent_size=4, connect_list=("8", "16", "32"), nf=32,
                       ch_mult=(1, 2, 2, 4, 4, 8)), 64),
}


def uniform(seed, *shape):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def perturbed(variables, seed, scale):
    rng = np.random.default_rng(seed)
    return {k: (np.asarray(v) + rng.standard_normal(v.shape) * scale
                ).astype(np.float32)
            for k, v in flatten_params(variables).items()}


def load(module, state):
    module.load_state_dict(state, strict=True)
    return module.eval()


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def top2_margin(logits):
    top = np.sort(np.asarray(logits, np.float64), axis=-1)
    return top[..., -1] - top[..., -2]


@pytest.mark.parametrize("config", sorted(CF_CONFIGS))
def test_codeformer(config):
    kw, size = CF_CONFIGS[config]
    x = uniform(1, 2, size, size, 3)
    jm = JCodeFormer(**kw)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), w=1.0,
                        adain=True)
    flat = perturbed(variables, 2, 0.05)
    params = unflatten_params(flat)
    tm = load(CodeFormer(**kw), from_flax_codeformer(flat))
    with torch.no_grad():
        logits_t, lq_t = tm(nchw(x), code_only=True)
        logits_j, lq_j = jm.apply(params, jnp.asarray(x), code_only=True)
        np.testing.assert_allclose(logits_t.numpy(), logits_j, atol=ATOL)
        np.testing.assert_allclose(nhwc(lq_t), lq_j, atol=ATOL)
        margin = float(top2_margin(logits_j).min())
        codes_t = logits_t.numpy().argmax(-1)
        codes_j = np.asarray(logits_j).argmax(-1)
        assert (codes_t == codes_j).all(), (
            f"{(codes_t != codes_j).sum()} codes differ; smallest top-1/top-2 "
            f"margin {margin:.3e}")
        for w, adain in ((0.0, False), (0.0, True), (1.0, False), (1.0, True)):
            out_t, lg_t, _ = tm(nchw(x), w=w, adain=adain)
            out_j, lg_j, _ = jm.apply(params, jnp.asarray(x), w=w, adain=adain)
            assert out_t.shape == (2, 3, size, size)
            np.testing.assert_allclose(lg_t.numpy(), lg_j, atol=ATOL)
            np.testing.assert_allclose(nhwc(out_t), out_j, atol=ATOL,
                                       err_msg=f"w={w} adain={adain}")


@pytest.mark.parametrize("quantizer", ["nearest", "gumbel"])
def test_vqautoencoder(quantizer):
    kw = dict(nf=32, ch_mult=(1, 2), codebook_size=32, emb_dim=32,
              quantizer=quantizer)
    x = uniform(3, 2, 16, 16, 3)
    jm = JVQ(**kw)
    flat = perturbed(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)), 4, 0.05)
    tm = load(VQAutoEncoder(**kw, img_size=16), from_flax_codeformer(flat))
    with torch.no_grad():
        out_t, loss_t, stats_t = tm(nchw(x))
    out_j, loss_j, stats_j = jm.apply(unflatten_params(flat), jnp.asarray(x))
    np.testing.assert_allclose(nhwc(out_t), out_j, atol=ATOL)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4,
                               atol=1e-9)
    np.testing.assert_array_equal(
        stats_t["min_encoding_indices"].numpy().reshape(-1),
        np.asarray(stats_j["min_encoding_indices"]).reshape(-1))
    if quantizer == "nearest":
        np.testing.assert_allclose(float(stats_t["perplexity"]),
                                   float(stats_j["perplexity"]), rtol=1e-5)


@pytest.mark.parametrize("relu_type", ["leakyrelu", "prelu"])
def test_parsenet(relu_type):
    kw = dict(in_size=64, out_size=64, min_feat_size=16, base_ch=16,
              res_depth=2, relu_type=relu_type, ch_range=(16, 64))
    x = uniform(5, 2, 64, 64, 3)
    jm = JParseNet(**kw)
    variables = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))
    assert "batch_stats" in variables
    flat = perturbed(variables, 6, 0.05)
    rng = np.random.default_rng(7)
    for k in flat:   # running statistics far from (0, 1)
        if k.endswith("/mean"):
            flat[k] = rng.normal(0, 0.3, flat[k].shape).astype(np.float32)
        elif k.endswith("/var"):
            flat[k] = rng.uniform(0.3, 2.0, flat[k].shape).astype(np.float32)
    tm = load(ParseNet(**kw), from_flax_parsenet(flat))
    with torch.no_grad():
        mask_t, img_t = tm(nchw(x))
    mask_j, img_j = jm.apply(unflatten_params(flat), jnp.asarray(x))
    for t_out, j_out in ((mask_t, mask_j), (img_t, img_j)):
        j_out = np.asarray(j_out)
        np.testing.assert_allclose(nhwc(t_out), j_out,
                                   atol=ATOL * np.abs(j_out).max())
    clear = top2_margin(mask_j) > 1e-3
    agree = nhwc(mask_t).argmax(-1) == np.asarray(mask_j).argmax(-1)
    assert clear.mean() > 0.9 and agree[clear].mean() == 1.0, (
        clear.mean(), agree[clear].mean())


def test_converter_rejects_a_missing_key():
    """Strict loads: a flax tree without one leaf does not load."""
    kw, size = CF_CONFIGS["tiny"]
    shapes = jax.eval_shape(
        lambda k, x: JCodeFormer(**kw).init(k, x, w=1.0),
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))
    state = from_flax_codeformer(flatten_params(jax.tree_util.tree_map(
        lambda v: np.zeros(v.shape, np.float32), shapes)))
    assert "ft_layer0.self_attn.query.weight" in state
    assert state["ft_layer0.self_attn.query.weight"].shape == (64, 64)
    assert "encoder.block0.norm1.weight" in state
    state.pop("position_emb")
    with pytest.raises(RuntimeError, match="position_emb"):
        CodeFormer(**kw).load_state_dict(state, strict=True)
