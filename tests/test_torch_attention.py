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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,s,heads,d", [
    (torch.bfloat16, 1024, 4, 64), (torch.bfloat16, 100, 8, 64),
    (torch.bfloat16, 64, 4, 32), (torch.float32, 256, 8, 64),
    (torch.float32, 37, 2, 32)])
def test_cuda_kernel_matches_plain(cuda_device, dtype, s, heads, d):
    """The kernel against its twin on the card, on views of a packed qkv,
    relative to the largest output: f32 to reassociation error (1e-5), bf16
    to the rounding of P to bf16 before P·V and of the output (2e-2)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    qkv = torch.from_numpy(packed_qkv(7, 2, s, heads, d, 2.0)).to(
        cuda_device, dtype)
    q, k, v = split(qkv, heads, d)
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = dot_product_attention(q.float(), k.float(), v.float())
    err = (out.float() - ref).abs().max().item() / ref.abs().max().item()
    assert err < (1e-5 if dtype == torch.float32 else 2e-2), err
