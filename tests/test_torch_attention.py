"""The flash-attention wrapper (flair_tpu_torch.ops.attention) against
flair_tpu.

On the CPU ``flash_attention`` runs its plain twin; it must agree with the
JAX package's ``flash_attention`` and ``dot_product_attention`` to ≤1e-5
absolute in float32, with q, k, v given the way the attention blocks give
them: strided views of one packed ``qkv`` with the per-head (q, k, v)
interleave. The kernel itself (``csrc/flash_attn.cu``) is held against the
twin on the card by the ``cuda``-marked case, which skips here. JAX and
flair_tpu are imported inside the parity tests, so the CUDA case also runs
on a GPU machine that has no JAX.
"""

import numpy as np
import pytest
import torch

from flair_tpu_torch.ops.attention import (
    dot_product_attention, flash_attention)

torch.set_num_threads(1)
ATOL = 1e-5


def packed_qkv(seed, n, s, heads, d, scale=1.0):
    """(N, S, heads·3·D) packed projections, as the qkv Dense emits them."""
    return (np.random.default_rng(seed).standard_normal((n, s, heads * 3 * d))
            * scale).astype(np.float32)


def split(qkv, heads, d):
    """The attention blocks' head split: views of the packed tensor."""
    n, s, _ = qkv.shape
    return qkv.reshape(n, s, heads, 3, d).unbind(dim=3)


@pytest.mark.parametrize("n,s,heads,d", [
    (2, 64, 2, 32), (1, 100, 1, 64), (3, 37, 4, 8)])
def test_flash_attention_cpu_matches_flair_tpu(n, s, heads, d):
    import jax.numpy as jnp
    from flair_tpu.ops import attention as ja

    qkv = packed_qkv(n + s, n, s, heads, d)
    q, k, v = split(torch.from_numpy(qkv), heads, d)
    assert q.stride() == (s * 3 * heads * d, 3 * heads * d, 3 * d, 1)
    before = flash_attention.launches
    out = flash_attention(q, k, v).numpy()
    assert flash_attention.launches == before      # the CPU runs the twin
    jq, jk, jv = (jnp.asarray(qkv.reshape(n, s, heads, 3, d)[..., i, :])
                  for i in range(3))
    assert out.shape == (n, s, heads, d)
    np.testing.assert_allclose(out, np.asarray(ja.flash_attention(jq, jk, jv)),
                               atol=ATOL)
    np.testing.assert_allclose(
        out, np.asarray(ja.dot_product_attention(jq, jk, jv)), atol=ATOL)


def test_flash_attention_explicit_scale():
    import jax.numpy as jnp
    from flair_tpu.ops import attention as ja

    qkv = packed_qkv(3, 1, 48, 2, 32)
    q, k, v = split(torch.from_numpy(qkv), 2, 32)
    jq, jk, jv = (jnp.asarray(qkv.reshape(1, 48, 2, 3, 32)[..., i, :])
                  for i in range(3))
    np.testing.assert_allclose(
        flash_attention(q, k, v, scale=0.05).numpy(),
        np.asarray(ja.dot_product_attention(jq, jk, jv, 0.05)), atol=ATOL)


@pytest.mark.parametrize("fault", ["shape", "stride", "dtype"])
def test_flash_attention_rejects_mismatched_inputs(fault):
    q, k, v = split(torch.from_numpy(packed_qkv(4, 1, 16, 2, 32)), 2, 32)
    if fault == "shape":
        k = k[:, :8]
    elif fault == "stride":
        k = k.contiguous()
    else:
        v = v.double()
    with pytest.raises(ValueError):
        flash_attention(q, k, v)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    return torch.device("cuda")


def ramp_v(qkv, heads, d):
    """``qkv`` with every head's V set to a ramp that is not symmetric in
    (key, d): 2·key/(S-1) - 1 + d/(2D) + h/10."""
    n, s, _ = qkv.shape
    out = qkv.reshape(n, s, heads, 3, d).copy()
    key = np.arange(s).reshape(s, 1, 1) / max(s - 1, 1)
    out[..., 2, :] = (2 * key - 1 + np.arange(d) / (2 * d)
                      + np.arange(heads).reshape(1, heads, 1) / 10)
    return out.reshape(n, s, heads * 3 * d)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,s,heads,d,ramp", [
    (torch.bfloat16, 1024, 4, 64, False), (torch.bfloat16, 100, 8, 64, False),
    (torch.bfloat16, 64, 4, 32, False), (torch.float32, 256, 8, 64, False),
    (torch.float32, 37, 2, 32, False)]
    + [(torch.bfloat16, s, 4, 64, True) for s in (1, 63, 65, 127, 129, 1000)]
    + [(torch.bfloat16, s, 4, 32, True) for s in (50, 200, 1000)])
def test_cuda_kernel_matches_plain(cuda_device, dtype, s, heads, d, ramp):
    """The kernel against its twin on the card, on views of a packed qkv,
    relative to the largest output: f32 to reassociation error (1e-5), bf16
    to the rounding of P to bf16 before P·V and of the output (2e-2). The
    ramp cases cover each query tile (16 / 64 / 128 rows for S ≤ 64 / ≤ 256
    / above) with a ragged last key tile, and hold the transposed read of V
    to a V whose rows and columns differ."""
    torch.backends.cuda.matmul.allow_tf32 = False
    qkv = packed_qkv(7, 2, s, heads, d, 2.0)
    if ramp:
        qkv = ramp_v(qkv, heads, d)
    q, k, v = split(torch.from_numpy(qkv).to(cuda_device, dtype), heads, d)
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = dot_product_attention(q.float(), k.float(), v.float())
    err = (out.float() - ref).abs().max().item() / ref.abs().max().item()
    assert err < (1e-5 if dtype == torch.float32 else 2e-2), err


@pytest.mark.cuda
def test_cuda_kernel_rejects_nonpositive_scale(cuda_device):
    """The bf16 kernel takes the row max of unscaled scores, so the wrapper
    raises for a scale that is not positive instead of launching it."""
    qkv = torch.from_numpy(packed_qkv(4, 1, 16, 2, 32)).to(
        cuda_device, torch.bfloat16)
    q, k, v = split(qkv, 2, 32)
    before = flash_attention.launches
    with pytest.raises(ValueError):
        flash_attention(q, k, v, scale=-0.1)
    assert flash_attention.launches == before


@pytest.mark.parametrize("n,s,heads,d,scale", [
    (2, 64, 2, 32, None), (1, 100, 1, 64, None), (3, 37, 4, 8, 0.05)])
def test_flash_attention_backward_matches_jax_vjp(n, s, heads, d, scale):
    """The autograd Function's backward (the plain twin's float32 VJP)
    against ``jax.vjp`` of ``flair_tpu.ops.attention.dot_product_attention``
    on the same q, k, v (views of one packed qkv, so the three gradients
    land in it) and cotangent; f32, within 1e-5 absolute."""
    import jax
    import jax.numpy as jnp
    from flair_tpu.ops import attention as ja

    qkv = packed_qkv(s + d, n, s, heads, d)
    cot = np.random.default_rng(s).standard_normal(
        (n, s, heads, d)).astype(np.float32)
    packed = torch.from_numpy(qkv).requires_grad_(True)
    out = flash_attention(*split(packed, heads, d), scale=scale)
    (g_packed,) = torch.autograd.grad(out, packed, torch.from_numpy(cot))
    jq, jk, jv = (jnp.asarray(qkv.reshape(n, s, heads, 3, d)[..., i, :])
                  for i in range(3))
    _, vjp = jax.vjp(lambda a, b, c: ja.dot_product_attention(a, b, c, scale),
                     jq, jk, jv)
    ref = np.stack([np.asarray(g) for g in vjp(jnp.asarray(cot))], axis=3)
    np.testing.assert_allclose(
        g_packed.numpy().reshape(n, s, heads, 3, d), ref, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_backward_matches_plain_autograd(cuda_device, dtype):
    """On the card at S = 256 (the BlurUNet's middle attention shape): the
    Function's gradients (kernel forward, plain float32 backward) against
    the plain twin's autograd on float32 copies, through one packed qkv;
    f32 within 1e-5 and bf16 within 1e-2 of the largest entry. The backward
    launches nothing."""
    torch.backends.cuda.matmul.allow_tf32 = False
    qkv = torch.from_numpy(packed_qkv(8, 10, 256, 8, 64)).to(cuda_device, dtype)
    packed = qkv.clone().requires_grad_(True)
    before = flash_attention.launches
    out = flash_attention(*split(packed, 8, 64))
    cot = torch.randn(out.shape, device=cuda_device, dtype=out.dtype)
    (g,) = torch.autograd.grad(out, packed, cot)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref_packed = qkv.float().requires_grad_(True)
    ref_out = dot_product_attention(*split(ref_packed, 8, 64))
    (r,) = torch.autograd.grad(ref_out, ref_packed, cot.float())
    err = (g.float() - r).abs().max().item() / r.abs().max().item()
    assert err < (1e-5 if dtype == torch.float32 else 1e-2), err
