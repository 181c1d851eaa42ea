"""MATLAB imresize, the DCT family and the uniform quantization codec of the
port (``flair_tpu_torch.ops``) against ``flair_tpu.ops``, float32 on the CPU.

- ``matlab_resize_matrix`` equal to JAX's in float64, bit for bit, for every
  kernel and both antialias settings at down- and upscales;
  ``matlab_resize`` within 1e-5 at scales 0.25 / 0.5 / 0.75 / 1.5 / 2.0
  (box upscaling, where the reference resizer raises, follows JAX);
- ``dct`` / ``idct`` / ``dct_2d`` / ``idct_2d`` / ``dct_3d`` / ``idct_3d``
  with ``norm`` None and ``"ortho"``, ``dct1`` / ``idct1``: within 1e-5
  of JAX (relative to the largest output), and each inverse undoes its
  transform;
- ``quantization_encode`` / ``_decode`` equal to JAX exactly, negatives and
  values just outside [-1, 1] included (``x.int()`` truncates toward
  zero; ``qf`` is forced to 32).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flair_tpu_torch.ops import dct as tdct
from flair_tpu_torch.ops import jpeg as tjpeg
from flair_tpu_torch.ops.matlab_resize import (matlab_resize,
                                               matlab_resize_matrix)

torch.set_num_threads(1)
KERNELS = ("cubic", "lanczos2", "lanczos3", "box", "linear")
SCALES = (0.25, 0.5, 0.75, 1.5, 2.0)


@pytest.mark.parametrize("antialias", [True, False])
@pytest.mark.parametrize("kernel", KERNELS)
def test_matlab_resize_matrix_equals_flair_tpu(kernel, antialias):
    from flair_tpu.ops.matlab_resize import matlab_resize_matrix as j_matrix

    for n_in, n_out in ((16, 4), (16, 8), (16, 12), (16, 24), (16, 32),
                        (7, 3), (5, 13)):
        mine = matlab_resize_matrix(n_in, n_out, kernel, antialias)
        ref = j_matrix(n_in, n_out, kernel, antialias)
        assert mine.dtype == np.float64 and mine.shape == (n_out, n_in)
        np.testing.assert_array_equal(mine, ref)


@pytest.mark.parametrize("antialias", [True, False])
@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("kernel", KERNELS)
def test_matlab_resize_matches_flair_tpu(kernel, scale, antialias):
    from flair_tpu.ops.matlab_resize import matlab_resize as j_resize

    x = np.random.default_rng(0).uniform(0, 1, (2, 16, 16, 3)).astype(
        np.float32)
    out = (int(round(16 * scale)), int(round(16 * scale)))
    ref = np.asarray(j_resize(jnp.asarray(x), out, kernel, antialias))
    got = matlab_resize(torch.from_numpy(x), out, kernel, antialias)
    assert got.shape == ref.shape == (2,) + out + (3,)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


DCT_FNS = ("dct", "idct", "dct_2d", "idct_2d", "dct_3d", "idct_3d")
INVERSE = {"dct": "idct", "dct_2d": "idct_2d", "dct_3d": "idct_3d",
           "dct1": "idct1"}


def dct_input(name):
    """(2, 5, 6, 8) for the 3-D forms, (3, 6, 8) for 2-D, (4, 8) for 1-D:
    the transformed axes differ in length, so a swapped axis shows."""
    shape = {"3d": (2, 5, 6, 8), "2d": (3, 6, 8)}.get(name[-2:], (4, 8))
    return np.random.default_rng(1).standard_normal(shape).astype(
        np.float32)


def assert_close(got, ref, tol=1e-5):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("norm", [None, "ortho"])
@pytest.mark.parametrize("name", DCT_FNS)
def test_dct_family_matches_flair_tpu(name, norm):
    from flair_tpu.ops import dct as jdct

    x = dct_input(name)
    got = getattr(tdct, name)(torch.from_numpy(x), norm)
    assert_close(got, getattr(jdct, name)(jnp.asarray(x), norm))


@pytest.mark.parametrize("name", ["dct1", "idct1"])
def test_dct1_matches_flair_tpu(name):
    from flair_tpu.ops import dct as jdct

    x = dct_input(name)
    assert_close(getattr(tdct, name)(torch.from_numpy(x)),
                 getattr(jdct, name)(jnp.asarray(x)))


@pytest.mark.parametrize("norm", [None, "ortho"])
@pytest.mark.parametrize("name", ["dct", "dct_2d", "dct_3d", "dct1"])
def test_dct_round_trips(name, norm):
    x = torch.from_numpy(dct_input(name))
    fwd, inv = getattr(tdct, name), getattr(tdct, INVERSE[name])
    if name == "dct1":
        back = inv(fwd(x))
    else:
        back = inv(fwd(x, norm), norm)
    assert_close(back, x.numpy())


def test_quantization_codec_equals_flair_tpu():
    from flair_tpu.ops.jpeg import quantization_decode as j_dec
    from flair_tpu.ops.jpeg import quantization_encode as j_enc

    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (2, 3, 16, 16, 3)).astype(np.float32)
    # the edges, and values just outside: -1.002 maps to -0.255, which the
    # int32 cast truncates to 0 (a floor would give -1, then -1 // 32 = -1)
    x[0, 0, 0, :4, 0] = [-1.0, 1.0, -1.002, 1.02]
    for qf in (32, 10, 90):
        ref = np.asarray(j_enc(jnp.asarray(x), qf))
        got = tjpeg.quantization_encode(torch.from_numpy(x), qf)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), ref)
    assert float(got[0, 0, 0, 2, 0]) == -1.0
    xt = torch.from_numpy(x)
    assert tjpeg.quantization_decode(xt, 32) is xt
    np.testing.assert_array_equal(np.asarray(j_dec(jnp.asarray(x))), x)
