"""The port's DAVSRNet (flair_tpu_torch/models/davsr.py) against flair_tpu.

Seeded numpy variables in the flax model's shapes
(``flax_init.random_flax_params``: the zero-initialised offset_out and
conv_last of its BasicVSR++ included, so every alignment deforms) go into
both, carried into the port by ``from_flax``; the same seeded clip goes
through both, float32, the JAX side jitted.

The JAX ``BasicVSRPP`` defaults to the patch DCN (``dcn_patch_size="auto"``
→ a 16-pixel patch that drops samples whose residue passes 6 px, which
M = 10 allows; flair_tpu/models/vsrpp.py:263-266, 362-373), and
``DAVSRNet`` cannot pass ``None`` through. So the full-forward test makes
the JAX run exact with pytest's ``monkeypatch`` on
``flair_tpu.models.vsrpp._auto_patch_size``, for that test only; nothing in
the JAX package is edited.

The ``cuda`` test runs the port on the card (K1 at every alignment)
against its own CPU run (``pytest --noconftest -m cuda``); it skips here.
"""

import functools

import numpy as np
import pytest
import torch

from flax_init import random_flax_params
from flair_tpu_torch.models import davsr
from flair_tpu_torch.models.registry import get_model
from flair_tpu_torch.utils.convert import from_flax

torch.set_num_threads(1)
SMALL = dict(n_iter=2, h_nc=8, mid_channels=32, num_blocks=1, sf=(2, 2, 2),
             deform_groups=2)


def moving_clip(seed, t, h, w, shift=1.5):
    """(1, t, h, w, 3) in [0.05, 0.95]: a smooth seeded pattern moving
    ``shift`` pixels a frame."""
    rng = np.random.default_rng(seed)
    ph = rng.uniform(0, 6.28, 3)
    fr = rng.uniform(0.15, 0.4, (3, 2))
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    frames = [np.stack([np.sin(fr[c, 0] * yy + fr[c, 1] * (xx - i * shift)
                               + ph[c]) for c in range(3)], -1)
              for i in range(t)]
    return (0.5 + 0.45 * np.stack(frames)[None]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def small_pair():
    """The small flax DAVSRNet with seeded variables, the port's, and the
    clip: 2 frames at 32² → 4 at 64²."""
    from flair_tpu.models.davsr import DAVSRNet as J
    from flair_tpu.utils.checkpoint import unflatten_params

    jm = J(**SMALL)
    x = moving_clip(0, 2, 32, 32)
    flat = random_flax_params(jm, 1, x)
    tm = get_model("davsr", **SMALL).eval()
    tm.load_state_dict(from_flax(flat), strict=True)
    return jm, unflatten_params(flat), tm, x


def test_data_prox_3d_matches_flair_tpu():
    """The FFT prox alone on the ×4 kernel's (25²) OTFs (2 → 4 frames,
    16² → 32²), with the host helpers it takes: ``load_ker_x4`` (the
    port's own asset), ``ps2ot`` and ``upsample3d``. Within 1e-5 of the
    largest output."""
    import jax.numpy as jnp

    from flair_tpu.models import davsr as jdavsr

    np.testing.assert_array_equal(davsr.load_ker_x4(), jdavsr.load_ker_x4())
    sf, shape = (2, 2, 2), (4, 32, 32)
    psf = np.repeat(davsr.load_ker_x4()[None], 2, axis=0) / 2
    fb_np = davsr.ps2ot(psf, shape)
    np.testing.assert_array_equal(fb_np, jdavsr.ps2ot(psf, shape))
    fb = fb_np.astype(np.complex64)
    fbc = np.conj(fb)
    f2b = (np.abs(fb_np) ** 2).astype(np.complex64)
    rng = np.random.default_rng(0)
    y = rng.uniform(0, 1, (1, 2, 16, 16, 3)).astype(np.float32)
    x = rng.uniform(0, 1, (1, 4, 32, 32, 3)).astype(np.float32)
    alpha = np.full((1, 1, 1, 1, 1), 0.37, np.complex64)

    jsty = jdavsr.upsample3d(jnp.asarray(y), sf)
    jfbfy = fbc * jnp.fft.fftn(jnp.moveaxis(jsty, -1, 1).astype(
        jnp.complex64), axes=(2, 3, 4))
    ref = np.asarray(jdavsr.data_prox_3d(jnp.asarray(x), fb, fbc, f2b, jfbfy,
                                         jnp.asarray(alpha), sf))
    sty = davsr.upsample3d(torch.from_numpy(y), sf)
    np.testing.assert_array_equal(sty.numpy(), np.asarray(jsty))
    fbt, fbct, f2bt = map(torch.from_numpy, (fb, fbc, f2b))
    fbfy = fbct * torch.fft.fftn(sty.movedim(-1, 1).to(torch.complex64),
                                 dim=(2, 3, 4))
    out = davsr.data_prox_3d(torch.from_numpy(x), fbt, fbct, f2bt, fbfy,
                             torch.from_numpy(alpha), sf)
    assert out.shape == x.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_davsr_first_prox_matches_flair_tpu():
    """``return_after_first_prox``: the OTFs, the SuperSloMo temporal
    initialiser (one intermediate frame a gap, one replicate pad), the
    align-corners upsample, HyPaNet and the first prox."""
    import jax

    jm, params, tm, x = small_pair()
    ref = np.asarray(jax.jit(functools.partial(
        jm.apply, return_after_first_prox=True))(params, x))
    with torch.no_grad():
        out = tm(torch.from_numpy(x), return_after_first_prox=True)
    assert out.shape == (1, 4, 64, 64, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


def test_davsr_matches_flair_tpu(monkeypatch):
    """The whole forward, two unfolding iterations through one shared
    regularizer (SPyNet, BasicVSR++ with 2 deform groups: 2 branches × 3
    frames × 2 iterations = 12 DCN calls), the JAX DCN made exact."""
    import jax

    import flair_tpu.models.vsrpp as jvsrpp

    monkeypatch.setattr(jvsrpp, "_auto_patch_size", lambda ps, mrm: None)
    jm, params, tm, x = small_pair()
    ref = np.asarray(jax.jit(jm.apply)(params, x))
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    assert out.shape == (1, 4, 64, 64, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_davsr_matches_cpu(cuda_device):
    """The small DAVSRNet, seeded random weights at 0.02, f32 with TF32
    off: K1 (f32, 2 groups) at each of its 12 alignments, cuFFT, cuDNN and
    grid_sample on the card against the CPU, within 1e-4 of the largest
    output."""
    from flair_tpu_torch.models.common import random_init_
    from flair_tpu_torch.ops.dcn import deform_conv2d_raw

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tm = get_model("davsr", **SMALL).eval()
    random_init_(tm, seed=0, scale=0.02)
    x = torch.from_numpy(moving_clip(2, 2, 32, 32))
    with torch.no_grad():
        ref = tm(x)
        saved = deform_conv2d_raw.launches
        out = tm.to(cuda_device)(x.to(cuda_device))
        launched = deform_conv2d_raw.launches - saved
    torch.backends.cudnn.allow_tf32 = True
    err = (out.cpu() - ref).abs().max().item()
    assert launched == 12 and err <= 1e-4 * ref.abs().max().item(), (
        launched, err)
