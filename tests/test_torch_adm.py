"""The rest of the ADM family against flair_tpu, float32 on the CPU:
``SuperResModel`` (registered ``superres_unet``) and ``EncoderUNetModel``
(``encoder_unet``) at small widths (model_channels 32, channel_mult (1, 2),
attention at ds 2), flax params initialised, perturbed and carried across
by ``from_flax``:

- forwards within 1e-5 abs;
- ``flax_names`` names the JAX tree exactly and ``from_flax(to_flax(...))``
  gives the state back bit for bit;
- ``pool != "adaptive"`` raises ``NotImplementedError`` on both sides;
- on the card (``-m cuda``): both forwards with seeded random weights at
  0.02, cuda (K1 / K2) against cpu within 1e-5 of the largest output. This file imports JAX only inside the
  parity tests (the card's machine has none).

The JAX ``SuperResModel`` builds its inner BlurUNet with the defaults
(``inner = BlurUNet()``; passing ``unet=`` collides with the ``unet``
scope in flax), so the test swaps in a small BlurUNet for that call. Its
params are perturbed by 0.02, not 0.05: at 0.05 the BlurUNet's VSR++ is
ill-conditioned at this size (SPyNet returns ~360 px flows on a 32² clip,
and a 1e-7 relative change of x moves the port's own output by 7.5e-5),
so two float32 implementations cannot agree to 1e-5 there; at 0.02 the
port moves by 1.1e-6 under that change and agrees with JAX to 1.1e-6.
"""

import functools

import numpy as np
import pytest
import torch

from flair_tpu_torch.models.adm import EncoderUNetModel, SuperResModel
from flair_tpu_torch.models.registry import get_model
from flair_tpu_torch.utils.convert import flax_names, from_flax, to_flax

torch.set_num_threads(1)
TOL = 1e-5
SR_PERTURB = 0.02
# 32-channel heads: the card's K2 takes D = 32 / 64
UNET_KW = dict(image_size=32, model_channels=32, num_res_blocks=1,
               attention_resolutions=(2,), rnn_resolutions=(1,),
               channel_mult=(1, 2), num_head_channels=32, temporal_frames=5)
ENC_KW = dict(image_size=32, in_channels=3, model_channels=32,
              out_channels=10, num_res_blocks=1, attention_resolutions=(2,),
              channel_mult=(1, 2), num_head_channels=32)
FRAMES = 3


def perturb(flat, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return {k: (np.asarray(v) + rng.standard_normal(v.shape) * scale
                ).astype(np.float32) for k, v in flat.items()}


def inputs(seed):
    """x (1, FRAMES, 32², 3), low_res (…, 16², 3) in [-1, 1], t (1, FRAMES)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, FRAMES, 32, 32, 3)).astype(np.float32)
    low = np.tanh(rng.standard_normal((1, FRAMES, 16, 16, 3))).astype(
        np.float32)
    return x, low, np.array([[17, 17, 17]], np.int32)


def jax_superres(monkeypatch):
    from flair_tpu.models import adm

    monkeypatch.setattr(adm, "BlurUNet", functools.partial(
        adm.BlurUNet, **UNET_KW, dcn_patch_size=None))
    return adm.SuperResModel()


def superres_pair(monkeypatch):
    """The JAX model's flat params and output, and the port's model with
    those params."""
    import jax

    from flair_tpu.utils.checkpoint import flatten_params, unflatten_params

    x, low, t = inputs(0)
    jm = jax_superres(monkeypatch)
    flat = perturb(flatten_params(jax.jit(jm.init)(
        jax.random.PRNGKey(0), x, t, low)), 1, SR_PERTURB)
    j_out = np.asarray(jax.jit(jm.apply)(unflatten_params(flat), x, t, low))
    tm = SuperResModel(**UNET_KW)
    tm.load_state_dict(from_flax(flat))
    return flat, j_out, tm.eval(), (x, low, t)


def encoder_pair():
    import jax

    from flair_tpu.models.adm import EncoderUNetModel as JEnc
    from flair_tpu.utils.checkpoint import flatten_params, unflatten_params

    x, _, t = inputs(2)
    jm = JEnc(**ENC_KW)
    flat = perturb(flatten_params(jax.jit(jm.init)(
        jax.random.PRNGKey(3), x, t)), 4)
    j_out = np.asarray(jax.jit(jm.apply)(unflatten_params(flat), x, t))
    tm = EncoderUNetModel(**ENC_KW)
    tm.load_state_dict(from_flax(flat))
    return flat, j_out, tm.eval(), (x, t)


def test_superres_model_matches_flair_tpu(monkeypatch):
    flat, j_out, tm, (x, low, t) = superres_pair(monkeypatch)
    assert all(k.startswith("params/unet/") for k in flat)
    with torch.no_grad():
        out = tm(*map(torch.from_numpy, (x, t, low)))
    assert out.shape == j_out.shape == (1, FRAMES, 32, 32, 6)
    np.testing.assert_allclose(out.numpy(), j_out, rtol=0, atol=TOL)


def test_encoder_unet_matches_flair_tpu():
    flat, j_out, tm, (x, t) = encoder_pair()
    with torch.no_grad():
        out = tm(*map(torch.from_numpy, (x, t)))
    assert out.shape == j_out.shape == (1, FRAMES, 10)
    assert np.abs(j_out).max() > 0.1        # the perturbed head is live
    np.testing.assert_allclose(out.numpy(), j_out, rtol=0, atol=TOL)


@pytest.mark.parametrize("kind", ["superres", "encoder"])
def test_flax_names_round_trip(kind, monkeypatch):
    flat, _, tm, _ = (superres_pair(monkeypatch) if kind == "superres"
                      else encoder_pair())
    names = flax_names(tm)
    assert sorted(names.values()) == sorted(flat)
    state = tm.state_dict()
    back = to_flax(state, names)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)
    again = from_flax(back)
    assert again.keys() == state.keys()
    for k, v in state.items():
        assert torch.equal(again[k], v), k


def test_encoder_pool_other_than_adaptive_raises():
    import jax

    from flair_tpu.models.adm import EncoderUNetModel as JEnc

    x, _, t = inputs(2)
    with pytest.raises(NotImplementedError):
        JEnc(**ENC_KW, pool="spatial").init(jax.random.PRNGKey(0), x, t)
    with pytest.raises(NotImplementedError):
        EncoderUNetModel(**ENC_KW, pool="spatial")


def test_registry_builds_both():
    sr = get_model("superres_unet", **UNET_KW)
    assert isinstance(sr, SuperResModel) and sr.unet.image_size == 32
    enc = get_model("encoder_unet", **ENC_KW)
    assert isinstance(enc, EncoderUNetModel)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    return torch.device("cuda")


def cuda_vs_cpu(model, args, device):
    """max abs gap of ``model`` on cuda (TF32 off) against cpu over the
    largest |cpu output|, and the kernel launches of the cuda call."""
    from flair_tpu_torch.ops.attention import flash_attention
    from flair_tpu_torch.ops.dcn import deform_conv2d_raw

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    saved = deform_conv2d_raw.launches, flash_attention.launches
    with torch.no_grad():
        out_c = model(*map(torch.from_numpy, args))
        model.to(device)
        out_g = model(*(torch.from_numpy(a).to(device) for a in args))
    launched = (deform_conv2d_raw.launches - saved[0],
                flash_attention.launches - saved[1])
    torch.backends.cudnn.allow_tf32 = True
    return (float((out_g.cpu() - out_c).abs().max() / out_c.abs().max()),
            launched)


@pytest.mark.cuda
def test_cuda_superres_matches_cpu(cuda_device):
    tm = SuperResModel(**UNET_KW)
    tm.random_init(seed=0, scale=0.02)
    x, low, t = inputs(0)
    err, launched = cuda_vs_cpu(tm.eval(), (x, t, low), cuda_device)
    assert err <= TOL and launched[0] > 0 and launched[1] > 0, (err, launched)


@pytest.mark.cuda
def test_cuda_encoder_unet_matches_cpu(cuda_device):
    tm = EncoderUNetModel(**ENC_KW)
    tm.random_init(seed=1, scale=0.02)
    x, _, t = inputs(2)
    err, launched = cuda_vs_cpu(tm.eval(), (x, t), cuda_device)
    assert err <= TOL and launched[1] > 0, (err, launched)
