"""The port's SuperSloMo (flair_tpu_torch/models/superslomo.py) against
flair_tpu.

Seeded numpy variables in the flax model's shapes
(``flax_init.random_flax_params``) go into both, carried into the port by
``from_flax``; the same seeded numpy inputs go through both, float32. The
JAX side runs op by op (no jit), at the smallest size the 6-level UNet
takes (32²).

The ``cuda`` test runs the port on the card against its own CPU run
(``pytest --noconftest -m cuda``); it skips here.
"""

import numpy as np
import pytest
import torch

from flax_init import random_flax_params
from flair_tpu_torch.models.registry import get_model
from flair_tpu_torch.models.superslomo import SuperSloMo, _back_warp
from flair_tpu_torch.utils.convert import from_flax

torch.set_num_threads(1)
TOL = 1e-5      # max abs error, outputs in [-1, 1]


def frames(seed, b, h, w):
    return np.random.default_rng(seed).uniform(-1, 1, (b, h, w, 3)).astype(
        np.float32)


def test_back_warp_matches_flair_tpu():
    """The reference's own normalisation (2(x/W − 0.5), align_corners
    False, zero padding), flows of up to 12 px carrying samples past every
    border."""
    import jax.numpy as jnp

    from flair_tpu.models.superslomo import _back_warp as j_back_warp

    rng = np.random.default_rng(0)
    img = rng.standard_normal((2, 9, 13, 3)).astype(np.float32)
    flow = (rng.uniform(-12, 12, (2, 9, 13, 2))).astype(np.float32)
    ref = np.asarray(j_back_warp(jnp.asarray(img), jnp.asarray(flow)))
    out = _back_warp(torch.from_numpy(img).permute(0, 3, 1, 2),
                     torch.from_numpy(flow).permute(0, 3, 1, 2))
    assert (ref == 0).any()          # some samples left the image
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, rtol=0,
                               atol=TOL)


def test_superslomo_matches_flair_tpu():
    """SuperSloMo(factor=3) at 32²: both intermediate frames and both
    flows."""
    import jax.numpy as jnp

    from flair_tpu.models.superslomo import SuperSloMo as J
    from flair_tpu.utils.checkpoint import unflatten_params

    f0, f1 = frames(1, 1, 32, 32), frames(2, 1, 32, 32)
    jm = J(factor=3)
    flat = random_flax_params(jm, 3, f0, f1)
    j_out, j01, j10 = jm.apply(unflatten_params(flat), jnp.asarray(f0),
                               jnp.asarray(f1), return_flow=True)
    tm = get_model("superslomo", factor=3)
    tm.load_state_dict(from_flax(flat), strict=True)
    with torch.no_grad():
        out, f01, f10 = tm(torch.from_numpy(f0), torch.from_numpy(f1),
                           return_flow=True)
    assert out.shape == (1, 2, 32, 32, 3)
    for t, j in ((out, j_out), (f01, j01), (f10, j10)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=TOL)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_superslomo_matches_cpu(cuda_device):
    """Seeded random weights, f32 with TF32 off: cuDNN and grid_sample on
    the card against the CPU."""
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    tm = SuperSloMo(factor=3).eval()
    f0, f1 = (torch.from_numpy(frames(s, 1, 32, 32)) for s in (4, 5))
    with torch.no_grad():
        ref = tm(f0, f1)
        out = tm.to(cuda_device)(f0.to(cuda_device), f1.to(cuda_device))
    torch.backends.cudnn.allow_tf32 = True
    assert (out.cpu() - ref).abs().max().item() <= TOL
