"""The port's exported leftovers against flair_tpu: ``ops/shuffle``
(pixel shuffle / unshuffle), ``operators/svd_ops.SuperResolution`` (the
patch-average SR operator with DDRM's Λ-operators) and ``utils/locking``.

- ``pixel_shuffle`` / ``pixel_unshuffle``: exactly the JAX package's
  result, and ``torch.pixel_shuffle``'s on the NCHW view.
- ``SuperResolution``: V, Vt, U, Ut, A, At, A_pinv, Lambda and
  Lambda_noise within 1e-6 of the JAX class, float32, on square and
  rectangular images, in both Λ regimes (σ_t below and above a·σ_y/σ).
- ``acquire_tpu_lock``: a second process gets None while the first holds
  the lock, and takes it once the first has exited.

The ``cuda`` test runs ``SuperResolution`` on the card against its CPU
run (``pytest --noconftest -m cuda``); it skips here.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from flair_tpu_torch.operators import SuperResolution
from flair_tpu_torch.ops import pixel_shuffle, pixel_unshuffle

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-6


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("shape,r", [((2, 3, 4, 5, 12), 2), ((1, 2, 2, 27), 3),
                                     ((3, 5, 4), 2)])
def test_pixel_shuffle_matches_flair_tpu_and_torch(shape, r):
    import jax.numpy as jnp

    from flair_tpu.ops.shuffle import pixel_shuffle as j_shuffle
    from flair_tpu.ops.shuffle import pixel_unshuffle as j_unshuffle

    x = rand(0, *shape)
    y = pixel_shuffle(torch.from_numpy(x), r)
    np.testing.assert_array_equal(y.numpy(), np.asarray(j_shuffle(
        jnp.asarray(x), r)))
    *lead, h, w, c = shape
    ref = torch.pixel_shuffle(torch.from_numpy(x).reshape(-1, h, w, c)
                              .permute(0, 3, 1, 2), r).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(y.reshape(ref.shape).numpy(), ref.numpy())
    back = pixel_unshuffle(y, r)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(back.numpy(), np.asarray(j_unshuffle(
        jnp.asarray(np.asarray(y)), r)))


SR_CASES = {"square_x4": (3, 16, 4), "rect_x2": (2, (8, 12), 2)}


@pytest.mark.parametrize("case", sorted(SR_CASES))
def test_super_resolution_matches_flair_tpu(case):
    import jax.numpy as jnp

    from flair_tpu.operators.svd_ops import SuperResolution as J

    c, dim, r = SR_CASES[case]
    h, w = dim if isinstance(dim, tuple) else (dim, dim)
    op_t = SuperResolution(c, dim, r, device="cpu")
    op_j = J(c, dim, r)
    x = rand(1, 2, h * w * c)
    y = rand(2, 2, h * w * c // r ** 2)
    eps = rand(3, 2, h * w * c)

    def both(name, *args, **kw):
        t = getattr(op_t, name)(*(torch.from_numpy(a) if isinstance(
            a, np.ndarray) else a for a in args), **kw)
        j = getattr(op_j, name)(*(jnp.asarray(a) if isinstance(
            a, np.ndarray) else a for a in args), **kw)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=ATOL, err_msg=name)
        return t

    for name in ("V", "Vt", "A", "A_pinv"):
        both(name, x if name != "A_pinv" else y)
    for name in ("U", "Ut", "At"):
        both(name, y)
    np.testing.assert_allclose(op_t.singulars().numpy(),
                               np.asarray(op_j.singulars()), atol=ATOL)
    # V is orthogonal: Vt undoes it
    np.testing.assert_allclose(op_t.V(op_t.Vt(torch.from_numpy(x))).numpy(),
                               x, atol=1e-5)
    # σ = 1/r: σ_t = 0.05 is below a·σ_y/σ, σ_t = 0.9 above it
    for sigma_t in (0.05, 0.9):
        for a, sigma_y in ((1.0, 0.1), (0.0, 0.1)):
            both("Lambda", x, a, sigma_y, sigma_t, 0.85)
            both("Lambda_noise", x, a, sigma_y, sigma_t, 0.85, eps)


def test_super_resolution_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SuperResolution(3, 16, 4)


HOLD = textwrap.dedent("""
    import sys
    from flair_tpu_torch.utils.locking import acquire_tpu_lock
    held = acquire_tpu_lock(0, sys.argv[1])
    print("held" if held is not None else "busy", flush=True)
    sys.stdin.readline()
""")
TRY = textwrap.dedent("""
    import sys
    from flair_tpu_torch.utils.locking import acquire_tpu_lock
    print("held" if acquire_tpu_lock(0, sys.argv[1]) is not None
          else "busy")
""")


def test_lock_is_exclusive_across_processes(tmp_path):
    from flair_tpu_torch.utils.locking import tpu_lock_needed

    path = str(tmp_path / "card.lock")
    holder = subprocess.Popen([sys.executable, "-c", HOLD, path], cwd=ROOT,
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                              text=True)
    try:
        assert holder.stdout.readline().strip() == "held"
        second = subprocess.run([sys.executable, "-c", TRY, path], cwd=ROOT,
                                capture_output=True, text=True, timeout=120)
        assert second.stdout.strip() == "busy", second.stderr
    finally:
        holder.communicate("\n", timeout=60)
    third = subprocess.run([sys.executable, "-c", TRY, path], cwd=ROOT,
                           capture_output=True, text=True, timeout=120)
    assert third.stdout.strip() == "held", third.stderr
    assert tpu_lock_needed() == torch.cuda.is_available()


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
def test_cuda_super_resolution_matches_cpu(cuda_device):
    op_c = SuperResolution(3, 64, 4, device="cpu")
    op_g = SuperResolution(3, 64, 4)
    x = torch.from_numpy(rand(4, 2, 64 * 64 * 3))
    eps = torch.from_numpy(rand(5, 2, 64 * 64 * 3))
    for name, args in (("A", (x,)), ("Vt", (x,)),
                       ("Lambda", (x, 1.0, 0.1, 0.9, 0.85)),
                       ("Lambda_noise", (x, 1.0, 0.1, 0.05, 0.85, eps))):
        ref = getattr(op_c, name)(*args)
        out = getattr(op_g, name)(*(a.to(cuda_device) if torch.is_tensor(a)
                                    else a for a in args))
        assert (out.cpu() - ref).abs().max().item() <= 1e-5, name
