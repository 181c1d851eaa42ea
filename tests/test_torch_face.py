"""The port's face fusion against flair_tpu, in float32.

- ``gaussian_blur`` (C = 1 and 4 at 64², ≤1e-6) and its size guard;
- ``warp_affine`` (bicubic and bilinear, C = 3 and 4; identity, the
  bench's matrix, a 20° rotation and a matrix that maps half the output
  off the image; 64² → 64² and → 48×80; ≤1e-5, borders and corners
  included), the batched inverse and the host geometry;
- ``make_face_fn_p`` with deterministic stub appliers written identically
  for both packages: (T,2,3) and (B,T,2,3) matrices, ``aligned``, and no
  ParseNet (≤1e-5);
- ``p_sample``'s face hook in and out of the face window, both update
  rules, and the update with and without ``face_args`` (≤1e-6).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flair_tpu import diffusion as jd
from flair_tpu.face import helper as jhelper
from flair_tpu.ops.blur import gaussian_blur as j_blur
from flair_tpu.ops.warp import warp_affine as j_warp_affine
from flair_tpu_torch import diffusion as td
from flair_tpu_torch.face import helper as thelper
from flair_tpu_torch.ops.blur import gaussian_blur as t_blur
from flair_tpu_torch.ops.warp import (
    invert_affine_batch, inverse_affine_matrix, warp_affine as t_warp_affine)

torch.set_num_threads(1)
TH = np.deg2rad(20.0)
MATRICES = {
    "identity": [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
    "bench": [[1.1, 0.08, 12.0], [-0.08, 1.1, -9.0]],
    "rot20": [[np.cos(TH), -np.sin(TH), 10.0], [np.sin(TH), np.cos(TH), -5.0]],
    "half_off": [[1.0, 0.0, 32.0], [0.0, 1.0, 0.0]],
}


def uniform(seed, *shape, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


@pytest.mark.parametrize("c", [1, 4])
def test_gaussian_blur(c):
    x = uniform(0, 2, 64, 64, c)
    for ksize, sigma in ((101, 26.0), (7, 0.0)):
        out = t_blur(torch.from_numpy(x), ksize, sigma).numpy()
        ref = np.asarray(j_blur(jnp.asarray(x), ksize, sigma))
        np.testing.assert_allclose(out, ref, atol=1e-6)


def test_gaussian_blur_rejects_small_images():
    with pytest.raises(ValueError, match="above 50"):
        t_blur(torch.zeros(1, 50, 64, 1), 101, 26.0)


@pytest.mark.parametrize("c", [3, 4])
@pytest.mark.parametrize("mode", ["bicubic", "bilinear"])
@pytest.mark.parametrize("out_hw", [(64, 64), (48, 80)])
def test_warp_affine(c, mode, out_hw):
    img = uniform(1, 2, 64, 64, c)
    for name, m in MATRICES.items():
        mats = np.stack([np.asarray(m, np.float32),
                         np.asarray(MATRICES["bench"], np.float32)])
        out = t_warp_affine(torch.from_numpy(img), torch.from_numpy(mats),
                            out_hw, mode=mode, border_value=0.25).numpy()
        ref = np.asarray(j_warp_affine(jnp.asarray(img), jnp.asarray(mats),
                                       out_hw, mode=mode, border_value=0.25))
        assert out.shape == ref.shape == (2, *out_hw, c)
        np.testing.assert_allclose(out, ref, atol=1e-5, err_msg=name)
        if name == "half_off":   # the left half samples outside the image
            assert np.all(out[0, :, :31] == 0.25)


def test_affine_inverses():
    mats = np.stack([np.asarray(m, np.float32) for m in MATRICES.values()])
    np.testing.assert_allclose(
        invert_affine_batch(torch.from_numpy(mats)).numpy(),
        np.asarray(jhelper._invert_batch(jnp.asarray(mats))), atol=1e-6)
    from flair_tpu.ops.warp import inverse_affine_matrix as j_inverse
    for m in MATRICES.values():
        np.testing.assert_array_equal(inverse_affine_matrix(np.asarray(m)),
                                      j_inverse(np.asarray(m)))


class StubDetector:
    """Two faces a frame (the second larger) and one frame with none."""

    def detect_faces(self, bgr):
        h, w = bgr.shape[:2]
        if bgr.mean() < 60:
            return np.zeros((0, 15))
        rng = np.random.default_rng(int(bgr.sum()) % 1000)
        dets = []
        for size in (0.2, 0.5):
            box = [0.1 * w, 0.1 * h, (0.1 + size) * w, (0.1 + size) * h, 0.99]
            marks = (np.asarray(thelper.FFHQ_TEMPLATE_512) / 512 * size * w
                     + 0.1 * w + rng.normal(0, 0.5, (5, 2)))
            dets.append(np.concatenate([box, marks.reshape(-1)]))
        return np.asarray(dets)


def test_host_geometry():
    np.testing.assert_array_equal(thelper.FFHQ_TEMPLATE_512,
                                  jhelper.FFHQ_TEMPLATE_512)
    np.testing.assert_array_equal(thelper.MASK_COLORMAP, jhelper.MASK_COLORMAP)
    np.testing.assert_array_equal(thelper._GRAY_BORDER, jhelper._GRAY_BORDER)
    rng = np.random.default_rng(2)
    src = rng.uniform(100, 400, (5, 2))
    np.testing.assert_array_equal(
        thelper.estimate_similarity_transform(src, thelper.FFHQ_TEMPLATE_512),
        jhelper.estimate_similarity_transform(src, jhelper.FFHQ_TEMPLATE_512))
    boxes = np.array([[-10, 5, 40, 60, 0.9], [20, 20, 90, 70, 0.8],
                      [0, 0, 200, 10, 0.7]])
    for h, w in ((64, 64), (50, 120)):
        assert (thelper.get_largest_face(boxes, h, w)
                == jhelper.get_largest_face(boxes, h, w))
    frames = uniform(3, 3, 64, 64, 3, lo=0.3, hi=1.0)
    frames[1] *= 0.2   # too dark: the stub finds no face
    for keep in (True, False):
        mt = thelper.FaceRestoreHelper(StubDetector(), face_size=64)
        mj = jhelper.FaceRestoreHelper(StubDetector(), face_size=64)
        a = mt.get_affine_matrices(frames, only_keep_largest=keep)
        b = mj.get_affine_matrices(frames, only_keep_largest=keep)
        assert a[1] is None and b[1] is None
        for u, v in zip(a[::2], b[::2]):
            np.testing.assert_array_equal(u, v)
    assert thelper.FaceRestoreHelper(None).get_affine_matrices(
        frames[:1]) == [None]


def stub_codeformer(f):
    """Overshoots [-1, 1], so both clamps of the paste matter."""
    return 1.3 * f + 0.1 * f * f - 0.05


def stub_parsenet(xp):
    """Classes by position, so no argmax sits at a tie: face (class 5)
    inside a centred disc, hair (17) in a band above, background
    elsewhere."""
    def fn(f):
        n, h, w, _ = f.shape
        yy = xp.arange(h)[:, None] / h - 0.5
        xx = xp.arange(w)[None, :] / w - 0.5
        cls = xp.where(yy * yy + xx * xx < 0.09, 5,
                       xp.where((yy > -0.45) & (yy < -0.35), 17, 0))
        onehot = xp.eye(19)[cls]
        return xp.broadcast_to(onehot, (n, h, w, 19)) + 0.0 * f[..., :1]
    return fn


@pytest.mark.parametrize("case", ["tiled", "per_clip", "aligned", "no_parse"])
def test_make_face_fn_p(case):
    b, t, s = 2, 2, 64
    x0 = uniform(4, b, t, s, s, 3)
    xt = uniform(5, b, t, s, s, 3)
    base = np.stack([np.asarray(MATRICES["bench"], np.float32),
                     np.asarray(MATRICES["rot20"], np.float32)])
    mats = base if case == "tiled" else np.stack([base, base[::-1] * 0.97])
    kw = dict(face_size=s, aligned=case == "aligned")
    fn_t = thelper.make_face_fn_p(
        stub_codeformer, None if case == "no_parse" else stub_parsenet(torch),
        **kw)
    fn_j = jhelper.make_face_fn_p(
        stub_codeformer, None if case == "no_parse" else stub_parsenet(jnp),
        **kw)
    out = fn_t(*map(torch.from_numpy, (x0, xt, mats))).numpy()
    ref = np.asarray(fn_j(*map(jnp.asarray, (x0, xt, mats))))
    assert out.shape == ref.shape == x0.shape
    np.testing.assert_allclose(out, ref, atol=1e-5)
    assert not np.allclose(out, x0, atol=1e-3)   # the face was pasted
    if case == "tiled":   # make_face_fn binds the same matrices
        fixed = thelper.make_face_fn(mats, stub_codeformer,
                                     stub_parsenet(torch), face_size=s)
        np.testing.assert_array_equal(
            fixed(torch.from_numpy(x0), torch.from_numpy(xt)).numpy(), out)


def face_stub(xp):
    return lambda x0, xt: 1.4 * x0 - 0.3 * xp.tanh(xt)


@pytest.mark.parametrize("rule", ["ddpm", "ddim"])
@pytest.mark.parametrize("in_window", [True, False])
def test_p_sample_face_hook(rule, in_window):
    dt = td.make_task_diffusion("x8_bicubic", "ddim25", device="cpu")
    dj = jd.make_task_diffusion("x8_bicubic", "ddim25")
    shape = (1, 3, 4, 5, 3)
    x, mo, z, pv = (uniform(s, *shape) for s in (6, 7, 8, 9))
    mask = np.zeros((1, 3, 1, 1, 1), bool)
    mask[:, :1] = True
    kw = dict(gamma_t=0.7, rho=0.35, eta=0.8, rule=rule, w_t=0.6,
              in_face_window=in_window)
    s_t, x0_t = td.p_sample(
        dt, torch.from_numpy(mo), torch.from_numpy(x), 7, torch.from_numpy(z),
        restore_fn=lambda v: 0.1 * v, face_fn=face_stub(torch),
        pin_mask=torch.from_numpy(mask), pin_values=torch.from_numpy(pv), **kw)
    s_j, x0_j = jd.p_sample(
        dj, jnp.asarray(mo), jnp.asarray(x), jnp.asarray(7, jnp.int32),
        jnp.asarray(z), restore_fn=lambda v: 0.1 * v, face_fn=face_stub(jnp),
        pin_mask=jnp.asarray(mask), pin_values=jnp.asarray(pv), **kw)
    np.testing.assert_allclose(x0_t.numpy(), np.asarray(x0_j), atol=1e-6)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-6)


@pytest.mark.parametrize("with_face", [True, False])
def test_guided_update_face_window(monkeypatch, with_face):
    """Every step of a 10-step schedule through ``make_guided_update`` with
    the face tables (w = 0.7, τ = 3): the face is fused only for
    τ ≤ t ≤ start, ``face_args`` reach it, and ``face_args=None`` turns it
    off."""
    dt = td.make_task_diffusion("x8_bicubic", "10", device="cpu")
    dj = jd.make_task_diffusion("x8_bicubic", "10")
    kw = dict(w=0.7, tau=3, rho=0.35, use_aux=True)

    def face(xp):
        return lambda x0, xt, gain: face_stub(xp)(x0 * gain, xt)

    up_t = td.make_guided_update(dt, td.GuidanceConfig(**kw),
                                 face_fn=face(torch))
    up_j = jd.make_guided_update(dj, jd.GuidanceConfig(**kw),
                                 face_fn=face(jnp))
    shape = (1, 2, 4, 4, 3)
    noise = {}
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=None, dtype=jnp.float32:
                        jnp.asarray(noise["z"], dtype))
    x = uniform(10, *shape)
    for t in range(dt.num_timesteps - 1, -1, -1):
        mo, noise["z"] = uniform(20 + t, *shape), uniform(40 + t, *shape)
        s_t = up_t(torch.from_numpy(x), torch.from_numpy(mo), t,
                   torch.from_numpy(noise["z"]),
                   face_args=(torch.tensor(0.9),) if with_face else None)
        s_j, _ = up_j(jnp.asarray(x), jnp.asarray(mo),
                      jnp.asarray(t, jnp.int32), jax.random.PRNGKey(0), None,
                      None, (), (jnp.asarray(0.9),) if with_face else None)
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-6)
        x = s_t.numpy()
