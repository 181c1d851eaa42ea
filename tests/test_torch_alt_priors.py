"""The port's alternative face priors (flair_tpu_torch/models/{vqfr,
restoreformer}.py) against flair_tpu, one case for each case of
tests/test_alt_priors.py, at its configurations.

Seeded numpy variables in the flax model's shapes
(``flax_init.random_flax_params``, norm scales near 1) go into both,
carried into the port by ``from_flax`` with a strict load; the same seeded
inputs go through both in float32, the JAX side jitted. VQFR's DCN offset
convs get non-zero kernels that way (JAX starts them at zero), so its
deformable convs sample off the grid.

- Every output within 1e-4 of its largest |value|.
- The codes: the same indices in both, with the smallest top-2 margin
  (logits, or squared distances to the codebook, in float64) in the
  message. The codebook is drawn at a scale that keeps that margin above
  1e-3, asserted, so that float rounding cannot flip a code.

The ``cuda`` test runs the port on the card against its own CPU run
(``pytest --noconftest -m cuda``); it skips here.
"""

import numpy as np
import pytest
import torch

from flax_init import random_flax_params, with_norms
from flair_tpu_torch.models.restoreformer import RestoreFormer, VQVAEGAN
from flair_tpu_torch.models.vqfr import VQFRv2
from flair_tpu_torch.utils.convert import from_flax

torch.set_num_threads(1)
REL_TOL = 1e-4
MIN_MARGIN = 1e-3
VQFR_KW = dict(base_channels=32, channel_multipliers=(1, 2), num_enc_blocks=1,
               num_dec_blocks=1, code_dim=32, inpfeat_dim=8, num_code=16,
               deformable_groups=2)
RF_KW = dict(n_embed=16, embed_dim=16, ch=32, ch_mult=(1, 2),
             num_res_blocks=1, attn_resolutions=(16,), z_channels=16,
             head_size=2, ex_multi_scale_num=1)
VQVAE_KW = dict(n_embed=32, embed_dim=16, ch=32, ch_mult=(1, 2),
                num_res_blocks=1, attn_resolutions=(8,), z_channels=16)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def variables(jm, seed, x, codebook, codebook_scale):
    """Seeded flax variables with the codebook ``codebook`` redrawn at
    ``codebook_scale``."""
    flat = with_norms(random_flax_params(jm, seed, x), seed + 1)
    rng = np.random.default_rng(seed + 2)
    key = f"params/{codebook}/embedding"
    flat[key] = (codebook_scale * rng.standard_normal(flat[key].shape)
                 ).astype(np.float32)
    return flat


def top2_margin(scores):
    """Smallest gap between the best and second-best score of each row."""
    top = np.sort(np.asarray(scores, np.float64), axis=-1)
    return float((top[..., -1] - top[..., -2]).min())


def nearest_margin(z_nhwc, emb):
    """``top2_margin`` of the negated squared distances of each latent
    vector to every code."""
    flat = np.asarray(z_nhwc, np.float64).reshape(-1, emb.shape[1])
    e = np.asarray(emb, np.float64)
    d = (flat ** 2).sum(-1, keepdims=True) + (e ** 2).sum(-1) - 2 * flat @ e.T
    return top2_margin(-d)


def assert_close(t_out, j_out, name):
    j_out = np.asarray(j_out)
    assert t_out.shape == j_out.shape, name
    np.testing.assert_allclose(t_out, j_out, rtol=0,
                               atol=REL_TOL * np.abs(j_out).max(),
                               err_msg=name)


def assert_same_codes(t_idx, j_idx, margin):
    t_idx = np.asarray(t_idx).reshape(-1)
    j_idx = np.asarray(j_idx).reshape(-1)
    assert (t_idx == j_idx).all(), (
        f"{(t_idx != j_idx).sum()} codes differ; smallest top-1 / top-2 "
        f"margin {margin:.3e}")
    assert margin > MIN_MARGIN, margin


@pytest.mark.parametrize("mode", ["Predict", "Nearest"])
def test_vqfr(mode):
    """test_vqfr_forward (Predict, x in [-1, 1]) and
    test_vqfr_nearest_mode (Nearest, x in [0, 1]): every output of the
    dict, at fidelity 1 and 0.5."""
    import jax

    from flair_tpu.models.vqfr import VQFRv2 as J
    from flair_tpu.utils.checkpoint import unflatten_params

    rs = np.random.RandomState(0 if mode == "Predict" else 1)
    x = rs.rand(1, 32, 32, 3).astype(np.float32)
    if mode == "Predict":
        x = x * 2 - 1
    kw = dict(VQFR_KW, code_selection_mode=mode)
    jm = J(**kw)
    flat = variables(jm, 3, x, "quantizer", 1.0)
    params = unflatten_params(flat)
    tm = VQFRv2(**kw)
    tm.load_state_dict(from_flax(flat), strict=True)
    tm.eval()
    for ratio in (1.0, 0.5):
        j_out = jax.jit(lambda p, v: jm.apply(p, v, fidelity_ratio=ratio))(
            params, x)
        with torch.no_grad():
            t_out = tm(nchw(x), fidelity_ratio=ratio)
        assert sorted(t_out) == sorted(j_out)
        assert ("quant_logit" in t_out) == (mode == "Predict")
        for k, v in t_out.items():
            assert_close(v.numpy() if k == "quant_logit" else nhwc(v),
                         j_out[k], f"{k} at fidelity {ratio}")
    assert t_out["main_dec"].shape == (1, 3, 32, 32)
    if mode == "Predict":
        logit = np.asarray(j_out["quant_logit"])
        assert_same_codes(t_out["quant_logit"].numpy().argmax(-1),
                          logit.argmax(-1), top2_margin(logit))
    else:
        emb = flat["params/quantizer/embedding"]
        with torch.no_grad():
            _, _, t_idx = tm.quantizer(tm.encoder(nchw(x)))
        z = np.asarray(j_out["enc_feat"])
        margin = nearest_margin(z, emb)
        j_idx = -np.asarray(((z.reshape(-1, 32)[:, None] - emb) ** 2).sum(-1))
        assert_same_codes(t_idx.numpy(), j_idx.argmax(-1), margin)


def test_restoreformer():
    """test_restoreformer_forward: the decoder cross-attends to the
    encoder's features at 16² and (ex_multi_scale_num = 1) 32²; dec, the
    codebook loss, perplexity, the codes and every ``hs`` feature."""
    import jax

    from flair_tpu.models.restoreformer import RestoreFormer as J
    from flair_tpu.utils.checkpoint import unflatten_params

    x = (np.random.RandomState(2).rand(1, 32, 32, 3) * 2 - 1).astype(
        np.float32)
    jm = J(**RF_KW)
    flat = variables(jm, 4, x, "quantize", 1.0)
    dec_j, loss_j, (perp_j, idx_j), hs_j = jax.jit(jm.apply)(
        unflatten_params(flat), x)
    tm = RestoreFormer(**RF_KW, resolution=32)
    tm.load_state_dict(from_flax(flat), strict=True)
    with torch.no_grad():
        dec_t, loss_t, (perp_t, idx_t), hs_t = tm.eval()(nchw(x))
        z = nhwc(tm.quant_conv(hs_t["out"]))
    assert "mid_atten" in hs_t and sorted(hs_t) == sorted(hs_j)
    for k in hs_t:
        assert_close(nhwc(hs_t[k]), hs_j[k], f"hs[{k}]")
    assert_same_codes(idx_t.numpy(), idx_j,
                      nearest_margin(z, flat["params/quantize/embedding"]))
    assert_close(nhwc(dec_t), dec_j, "dec")
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(float(perp_t), float(perp_j), rtol=1e-5)


def test_vqvaegan():
    """test_vqvaegan_plain_variant_forward: the plain decoder (self
    attention only) at 16², on a seeded input (the JAX test feeds zeros,
    which gives one code everywhere)."""
    import jax

    from flair_tpu.models.restoreformer import VQVAEGAN as J
    from flair_tpu.utils.checkpoint import unflatten_params

    x = (np.random.RandomState(5).rand(1, 16, 16, 3) * 2 - 1).astype(
        np.float32)
    jm = J(**VQVAE_KW)
    flat = variables(jm, 6, x, "quantize", 1.0)
    dec_j, loss_j, (perp_j, idx_j) = jax.jit(jm.apply)(
        unflatten_params(flat), x)
    tm = VQVAEGAN(**VQVAE_KW, resolution=16)
    tm.load_state_dict(from_flax(flat), strict=True)
    with torch.no_grad():
        dec_t, loss_t, (perp_t, idx_t) = tm.eval()(nchw(x))
        z = nhwc(tm.quant_conv(tm.encoder(nchw(x))["out"]))
    assert dec_t.shape == (1, 3, 16, 16)
    assert_same_codes(idx_t.numpy(), idx_j,
                      nearest_margin(z, flat["params/quantize/embedding"]))
    assert_close(nhwc(dec_t), dec_j, "dec")
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(float(perp_t), float(perp_j), rtol=1e-5)


@pytest.fixture
def cuda_device():
    """The card, with TF32 off in cuDNN and in matmuls for the test and
    both flags put back after it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["vqfr", "restoreformer", "vqvaegan"])
def test_cuda_alt_priors_match_cpu(cuda_device, name):
    """Seeded random weights (0.1; VQFR's DCN offsets included), f32 with
    TF32 off: the card against the CPU, the same codes."""
    from flair_tpu_torch.models.common import random_init_

    make = {"vqfr": lambda: VQFRv2(**VQFR_KW),
            "restoreformer": lambda: RestoreFormer(**RF_KW, resolution=32),
            "vqvaegan": lambda: VQVAEGAN(**VQVAE_KW, resolution=32)}
    model = make[name]()
    random_init_(model, seed=0, scale=0.1)
    model.eval()
    x = torch.rand(1, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = model(x * 2 - 1)
        out = model.to(cuda_device)(x.to(cuda_device) * 2 - 1)
    ref_img = ref["main_dec"] if name == "vqfr" else ref[0]
    out_img = out["main_dec"] if name == "vqfr" else out[0]
    err = (out_img.cpu() - ref_img).abs().max().item()
    assert err <= REL_TOL * ref_img.abs().max().item(), err
    if name == "vqfr":
        assert torch.equal(out["quant_logit"].argmax(-1).cpu(),
                           ref["quant_logit"].argmax(-1))
    else:
        assert torch.equal(out[2][1].cpu(), ref[2][1])
