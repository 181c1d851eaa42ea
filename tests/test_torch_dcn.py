"""Port DCN (flair_tpu_torch/ops/{deform,dcn}.py) against flair_tpu.

- The plain raw DCN against flair_tpu's ``_materialize_raw`` +
  ``modulated_deform_conv2d`` (f32, ≤1e-4 abs), with flows that cross the
  image border.
- The plain raw DCN against the Pallas tile kernel in interpret mode on an
  input with no tile escapes (the kernel computes in bf16: ≤2e-2 mean
  relative error, the bound ``tests/test_ops.py`` holds it to).
- The CUDA kernel against the plain version (skips without a card).
- The wrapper's input checks, which run on every device.

JAX and flair_tpu are imported inside the parity tests, so the CUDA case
also runs on a GPU machine that has no JAX.
"""

import numpy as np
import pytest
import torch

from flair_tpu_torch.ops.dcn import deform_conv2d_raw
from flair_tpu_torch.ops.deform import deform_conv2d_raw_plain, materialize_raw

torch.set_num_threads(1)

MRM = 5.0


def make_raw_inputs(seed, b, h, w, cin, cout, g=16, amp=3.0, res_scale=1.0):
    """Seeded numpy inputs of the raw DCN: smooth flows of ``amp`` pixels
    (large enough to carry border samples outside the image), pre-tanh
    residues and mask logits in (group, tap) order, HWIO weights."""
    rng = np.random.default_rng(seed)
    a = 2
    x = rng.standard_normal((b, h, w, cin), dtype=np.float32)
    yy = np.arange(h, dtype=np.float32)[None, :, None, None] / h
    xx = np.arange(w, dtype=np.float32)[None, None, :, None] / w
    ph = rng.uniform(0, 6.28, (1, 1, 1, a)).astype(np.float32)
    flow_y = (amp * np.sin(2 * np.pi * (yy + xx) + ph)
              * np.ones((b, h, w, a), np.float32)).astype(np.float32)
    flow_x = (amp * np.cos(2 * np.pi * (yy - xx) + ph)
              * np.ones((b, h, w, a), np.float32)).astype(np.float32)
    res_y = (rng.standard_normal((b, h, w, g * 9)) * res_scale).astype(np.float32)
    res_x = (rng.standard_normal((b, h, w, g * 9)) * res_scale).astype(np.float32)
    mlog = rng.standard_normal((b, h, w, g * 9)).astype(np.float32)
    wgt = (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal((cout,)) * 0.1).astype(np.float32)
    return x, res_y, res_x, mlog, flow_y, flow_x, wgt, bias


def to_torch_args(arrs):
    x, ry, rx, ml, fy, fx, wgt, bias = (torch.from_numpy(a) for a in arrs)
    return x, ry, rx, ml, fy, fx, wgt.permute(3, 2, 0, 1).contiguous(), bias


@pytest.mark.parametrize("cin", [64, 128, 256])
def test_plain_raw_dcn_matches_flair_tpu_exact(cin):
    import jax.numpy as jnp
    from flair_tpu.ops.dcn_pallas import _materialize_raw
    from flair_tpu.ops.deform import modulated_deform_conv2d

    arrs = make_raw_inputs(cin, 2, 10, 12, cin, cin // 2)
    x, ry, rx, ml, fy, fx, wgt, bias = arrs
    off, mask = _materialize_raw(*(jnp.asarray(a) for a in (ry, rx, ml, fy, fx)),
                                 MRM)
    # the flows carry some samples fully outside the image
    assert float(jnp.abs(off).max()) > 3.0
    ref = np.asarray(modulated_deform_conv2d(
        jnp.asarray(x), off, mask, jnp.asarray(wgt), jnp.asarray(bias),
        padding=1))
    out = deform_conv2d_raw(*to_torch_args(arrs), MRM).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_materialize_raw_matches_flair_tpu():
    import jax.numpy as jnp
    from flair_tpu.ops.dcn_pallas import _materialize_raw

    arrs = make_raw_inputs(7, 1, 4, 6, 64, 32)
    _, ry, rx, ml, fy, fx, _, _ = arrs
    off_j, m_j = _materialize_raw(
        *(jnp.asarray(a) for a in (ry, rx, ml, fy, fx)), MRM)
    off_t, m_t = materialize_raw(
        *(torch.from_numpy(a) for a in (ry, rx, ml, fy, fx)), MRM)
    np.testing.assert_allclose(off_t.numpy(), np.asarray(off_j), atol=1e-6)
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), atol=1e-6)


def test_plain_raw_dcn_matches_pallas_tile_kernel_without_escapes():
    import jax.numpy as jnp
    from flair_tpu.ops.dcn_pallas import (
        _materialize_raw, deform_conv2d_tile, tile_escape_fraction)

    h, w, cin = 16, 32, 128
    arrs = make_raw_inputs(3, 1, h, w, cin, cin // 2, amp=1.5, res_scale=0.3)
    x, ry, rx, ml, fy, fx, wgt, bias = arrs
    jr = [jnp.asarray(a) for a in (ry, rx, ml, fy, fx)]
    off, _ = _materialize_raw(*jr, MRM)
    anchor = jnp.stack([jr[3], jr[4]], axis=-1)
    assert float(tile_escape_fraction(
        anchor, off, tile=(2, 4), patch=(16, 32))) == 0.0
    ref = np.asarray(deform_conv2d_tile(
        jnp.asarray(x), (jr[3], jr[4]), None, jnp.asarray(wgt),
        jnp.asarray(bias), raw=tuple(jr), raw_mrm=MRM, tile=(2, 4),
        patch=(16, 32), ntb=8, interpret=True)).astype(np.float32)
    out = deform_conv2d_raw(*to_torch_args(arrs), MRM).numpy()
    err = np.mean(np.abs(out - ref)) / np.mean(np.abs(ref))
    assert err < 0.02, err


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain(cuda_device, dtype):
    """The hand-written kernel against its plain twin on the card, relative
    to the largest output: f32 to float-reassociation error (1e-5), bf16 to
    the rounding of the sampled values and of the output (1e-2)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    arrs = make_raw_inputs(11, 1, 40, 72, 128, 64)
    x, ry, rx, ml, fy, fx, wgt, bias = (
        t.to(cuda_device) for t in to_torch_args(arrs))
    x, ry, rx, ml = (t.to(dtype) for t in (x, ry, rx, ml))
    before = deform_conv2d_raw.launches
    out = deform_conv2d_raw(x, ry, rx, ml, fy, fx, wgt, bias, MRM)
    torch.cuda.synchronize()
    assert deform_conv2d_raw.launches == before + 1
    ref = deform_conv2d_raw_plain(x.float(), ry.float(), rx.float(),
                                  ml.float(), fy, fx, wgt, bias, MRM)
    err = (out.float() - ref).abs().max().item() / ref.abs().max().item()
    assert err < (1e-5 if dtype == torch.float32 else 1e-2), err


@pytest.mark.parametrize("fault", ["nchw_raw_view", "cout", "flow_dtype"])
def test_wrapper_rejects_what_the_kernel_does_not_take(fault):
    """The wrapper checks its inputs on every device, so a CPU run fails
    where the card would: raw blocks that are not pixel-strided NHWC views,
    a Cout the kernel has no instance for, flows that are not float32."""
    x, ry, rx, ml, fy, fx, wgt, bias = to_torch_args(
        make_raw_inputs(5, 1, 6, 8, 64, 32))
    if fault == "nchw_raw_view":
        # NCHW-contiguous conv outputs seen through an NHWC permute
        ry, rx, ml = (t.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
                      for t in (ry, rx, ml))
    elif fault == "cout":
        wgt, bias = torch.cat([wgt, wgt[:8]]), torch.cat([bias, bias[:8]])
    else:
        fy = fy.double()
    with pytest.raises((ValueError, TypeError)):
        deform_conv2d_raw(x, ry, rx, ml, fy, fx, wgt, bias, MRM)
