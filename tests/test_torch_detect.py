"""The port's face detection and alignment against flair_tpu, in float32.

- ResNet18 / ResNet50 (every stage's output) and RetinaFace with either
  body at 64², weights carried across from flax by ``from_flax`` (every
  leaf perturbed by seeded noise, running statistics too): loc and landms
  within 1e-4, conf within 1e-5;
- the host code: ``prior_boxes``, ``decode_boxes``, ``decode_landms`` and
  ``nms`` equal;
- ``detect_faces`` of both detectors with the network replaced by one
  fixed output in which 20 overlapping anchors pass 0.8: the same
  detections within 1e-4 px;
- ``face.align`` (reference points, ``cp2tform``, ``warp_and_crop_face``)
  and ``face.misc`` (all but ``load_file_from_url``).
"""

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flair_tpu.face import align as jalign
from flair_tpu.face import misc as jmisc
from flair_tpu.models import resnet as jresnet
from flair_tpu.models import retinaface as jrf
from flair_tpu.utils.checkpoint import flatten_params
from flair_tpu_torch.face import align as talign
from flair_tpu_torch.face import misc as tmisc
from flair_tpu_torch.models import resnet as tresnet
from flair_tpu_torch.models import retinaface as trf
from flair_tpu_torch.utils.convert import from_flax

torch.set_num_threads(1)


def perturbed_variables(module, x, seed):
    """flax variables of ``module`` at input ``x``, flattened, every leaf
    v perturbed to v·(1 + 0.1·n) + 0.02·n' (running variances kept
    positive), so no BatchNorm is the identity."""
    flat = flatten_params(jax.jit(module.init)(jax.random.PRNGKey(seed), x))
    rng = np.random.default_rng(seed)

    def perturb(k, v):
        v = (v * (1 + 0.1 * rng.standard_normal(v.shape))
             + 0.02 * rng.standard_normal(v.shape))
        return (np.abs(v) + 0.1 if k.endswith("/var") else v).astype(
            np.float32)

    return {k: perturb(k, v) for k, v in flat.items()}


def unflat(flat):
    from flair_tpu.utils.checkpoint import unflatten_params
    return unflatten_params(flat)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def image(seed, size=64):
    return np.random.default_rng(seed).uniform(
        -1, 1, (1, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("depth", ["resnet18", "resnet50"])
def test_resnet_matches_flax(depth):
    x = image(0)
    jm = getattr(jresnet, depth)()
    flat = perturbed_variables(jm, jnp.asarray(x), 1)
    ref = jax.jit(jm.apply)(unflat(flat), jnp.asarray(x))
    tm = getattr(tresnet, depth)()
    tm.load_state_dict(from_flax(flat), strict=True)
    with torch.no_grad():
        outs = tm.eval()(nchw(x))
    assert len(outs) == len(ref) == 4
    for o, r in zip(outs, ref):
        r = np.asarray(r).transpose(0, 3, 1, 2)
        assert o.shape == r.shape
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(o.numpy() / scale, r / scale, atol=1e-5)


@pytest.fixture(scope="module", params=["mobile0.25", "resnet50"])
def retinaface_pair(request):
    network = request.param
    x = image(2)
    jm = jrf.RetinaFace(network=network)
    flat = perturbed_variables(jm, jnp.asarray(x), 3)
    tm = trf.RetinaFace(network=network)
    tm.load_state_dict(from_flax(flat), strict=True)
    return network, jm, unflat(flat), tm.eval(), x


def test_retinaface_matches_flax(retinaface_pair):
    network, jm, params, tm, x = retinaface_pair
    ref = jax.jit(jm.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        out = tm(nchw(x))
    n = 2 * (8 * 8 + 4 * 4 + 2 * 2)
    for o, r, k, tol in zip(out, ref, (4, 2, 10), (1e-4, 1e-5, 1e-4)):
        r = np.asarray(r)
        assert o.shape == r.shape == (1, n, k)
        np.testing.assert_allclose(o.numpy(), r, atol=tol)


def test_retinaface_network_of_detector(retinaface_pair):
    """``RetinaFaceDetector.network`` normalises as the JAX detector does
    and runs the model on its device."""
    network, jm, params, tm, x = retinaface_pair
    bgr = np.random.default_rng(4).uniform(0, 255, (64, 64, 3))
    det = trf.RetinaFaceDetector(tm)
    jdet = jrf.RetinaFaceDetector(jm, params, network=network)
    xin = (bgr.astype(np.float32) - np.array([104.0, 117.0, 123.0]))[None]
    ours = det.network(xin.astype(np.float32))
    ref = jdet._fwd(params, jnp.asarray(xin))
    for o, r in zip(ours, ref):
        r = np.asarray(r)
        # a ±128 input: outputs far from unit scale, compared relatively
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(o / scale, r / scale, atol=1e-5)


def test_fpn_rejects_sizes_the_jax_fpn_cannot_take():
    tm = trf.RetinaFace(network="mobile0.25").eval()
    with pytest.raises(ValueError, match="does not divide"):
        with torch.no_grad():
            tm(torch.zeros(1, 3, 72, 72))


@pytest.mark.parametrize("hw", [(64, 64), (50, 90)])
def test_host_decode_and_nms(hw):
    for cfg_t, cfg_j in ((trf.CFG_RESNET50, jrf.CFG_RESNET50),
                         (trf.CFG_MOBILENET, jrf.CFG_MOBILENET)):
        assert cfg_t == cfg_j
        pt, pj = trf.prior_boxes(cfg_t, hw), jrf.prior_boxes(cfg_j, hw)
        np.testing.assert_array_equal(pt, pj)
    rng = np.random.default_rng(5)
    loc = rng.normal(0, 0.5, (len(pt), 4)).astype(np.float32)
    lm = rng.normal(0, 0.5, (len(pt), 10)).astype(np.float32)
    np.testing.assert_array_equal(trf.decode_boxes(loc, pt, [0.1, 0.2]),
                                  jrf.decode_boxes(loc, pj, [0.1, 0.2]))
    np.testing.assert_array_equal(trf.decode_landms(lm, pt, [0.1, 0.2]),
                                  jrf.decode_landms(lm, pj, [0.1, 0.2]))
    dets = np.concatenate([rng.uniform(0, 40, (60, 2)),
                           rng.uniform(40, 80, (60, 2)),
                           rng.uniform(0, 1, (60, 1))], 1).astype(np.float32)
    for th in (0.1, 0.4, 0.7):
        assert trf.nms(dets, th) == jrf.nms(dets, th)


def fixed_network_output(n, seed=6, passing=20):
    """(loc, conf, landms) for n anchors: ``passing`` anchors near one
    another score in (0.8, 1), the rest 0.3."""
    rng = np.random.default_rng(seed)
    loc = rng.normal(0, 0.3, (1, n, 4)).astype(np.float32)
    landms = rng.normal(0, 0.3, (1, n, 10)).astype(np.float32)
    score = np.full(n, 0.3, np.float32)
    idx = rng.choice(np.arange(n // 4, n // 2), passing, replace=False)
    score[idx] = rng.uniform(0.81, 0.99, passing)
    conf = np.stack([1 - score, score], -1)[None].astype(np.float32)
    return loc, conf, landms


@pytest.mark.parametrize("network", ["resnet50", "mobile0.25"])
def test_detect_faces_with_fixed_network_output(network):
    h, w = 64, 96
    n = len(trf.prior_boxes(trf.CFG_RESNET50, (h, w)))
    fixed = fixed_network_output(n)
    bgr = np.random.default_rng(7).uniform(0, 255, (h, w, 3))
    det = trf.RetinaFaceDetector(trf.RetinaFace(network=network))
    det.network = lambda x: fixed
    jdet = jrf.RetinaFaceDetector(None, None, network=network)
    jdet._fwd = lambda p, x: fixed
    for conf_th, nms_th in ((0.8, 0.4), (0.5, 0.2)):
        ours = det.detect_faces(bgr, conf_th, nms_th)
        ref = jdet.detect_faces(bgr, conf_th, nms_th)
        assert ours.shape == ref.shape and ours.shape[1] == 15
        assert 1 < len(ours) < 20       # NMS merged some of the 20
        np.testing.assert_allclose(ours, ref, atol=1e-4)


# ---------------------------------------------------------------- align ---


@pytest.mark.parametrize("kw", [
    {}, {"default_square": True},
    {"output_size": (112, 112), "default_square": True},
    {"output_size": (96, 112)},
    {"inner_padding_factor": 0.25, "outer_padding": (4, 4),
     "output_size": (128, 148)},
    {"inner_padding_factor": 0.1}])
def test_reference_facial_points(kw):
    np.testing.assert_array_equal(talign.get_reference_facial_points(**kw),
                                  jalign.get_reference_facial_points(**kw))


def test_reference_facial_points_errors():
    for kw in ({"output_size": (64, 64)},
               {"inner_padding_factor": 2.0, "output_size": (200, 200)}):
        with pytest.raises(ValueError):
            jalign.get_reference_facial_points(**kw)
        with pytest.raises(ValueError):
            talign.get_reference_facial_points(**kw)


@pytest.mark.parametrize("reflect", [False, True])
def test_cp2tform(reflect):
    rng = np.random.default_rng(8)
    src = rng.uniform(20, 100, (5, 2))
    dst = jalign.get_reference_facial_points(default_square=True)
    if reflect:
        dst = dst * np.array([-1.0, 1.0]) + np.array([112.0, 0.0])
    for refl in (True, False):
        np.testing.assert_array_equal(talign.cp2tform(src, dst, refl),
                                      jalign.cp2tform(src, dst, refl))


@pytest.mark.parametrize("align_type", ["similarity", "affine"])
def test_warp_and_crop_face(align_type):
    rng = np.random.default_rng(9)
    img = rng.uniform(0, 255, (96, 80, 3)).astype(np.float32)
    pts = jalign.get_reference_facial_points(default_square=True) * 0.6 + 8
    pts = pts + rng.normal(0, 1.0, pts.shape)
    ours, t_tfm = talign.warp_and_crop_face(img, pts, crop_size=(112, 112),
                                            align_type=align_type,
                                            device="cpu")
    ref, j_tfm = jalign.warp_and_crop_face(img, pts, crop_size=(112, 112),
                                           align_type=align_type)
    np.testing.assert_array_equal(t_tfm, j_tfm)
    assert ours.shape == ref.shape == (112, 112, 3)
    # pixels of 0..255: float32 coordinates agree to ~1e-5 of the range
    np.testing.assert_allclose(ours / 255.0, ref / 255.0, atol=1e-5)
    # a CPU tensor stays on the CPU; numpy goes to cuda unless asked
    on_tensor, _ = talign.warp_and_crop_face(
        torch.from_numpy(img), pts, crop_size=(112, 112),
        align_type=align_type)
    np.testing.assert_array_equal(on_tensor, ours)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            talign.warp_and_crop_face(img, pts, crop_size=(112, 112),
                                      align_type=align_type)


# ----------------------------------------------------------------- misc ---


def test_misc_array_helpers():
    rng = np.random.default_rng(10)
    bgr = rng.integers(0, 256, (12, 9, 3)).astype(np.uint8)
    for kw in ({}, {"bgr2rgb": False}, {"float32": False}):
        np.testing.assert_array_equal(tmisc.img2tensor(bgr, **kw),
                                      jmisc.img2tensor(bgr, **kw))
    for a, b in zip(tmisc.img2tensor([bgr, bgr.astype(np.float64)]),
                    jmisc.img2tensor([bgr, bgr.astype(np.float64)])):
        np.testing.assert_array_equal(a, b)
    chw = rng.uniform(-1.2, 1.2, (3, 12, 9)).astype(np.float32)
    for kw in ({}, {"rgb2bgr": False}, {"min_max": (-1, 1)}):
        np.testing.assert_array_equal(tmisc.tensor2img(chw, **kw),
                                      jmisc.tensor2img(chw, **kw))
    grey = np.repeat(bgr[..., :1], 3, -1)
    for img in (bgr, grey, bgr[..., 0]):
        assert tmisc.is_gray(img) == jmisc.is_gray(img)
    for oc in (1, 3):
        np.testing.assert_array_equal(tmisc.rgb2gray(bgr, oc),
                                      jmisc.rgb2gray(bgr, oc))
        np.testing.assert_array_equal(tmisc.bgr2gray(bgr, oc),
                                      jmisc.bgr2gray(bgr, oc))
    c = rng.normal(0, 2, (2, 4, 6, 5))
    s = rng.normal(1, 3, (2, 4, 7, 3))
    for u, v in zip(tmisc.calc_mean_std(c), jmisc.calc_mean_std(c)):
        np.testing.assert_array_equal(u, v)
    np.testing.assert_array_equal(tmisc.adain_npy(c, s),
                                  jmisc.adain_npy(c, s))


def test_misc_scandir_and_imwrite(tmp_path):
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (10, 14, 3)).astype(np.uint8)
    ours, ref = tmp_path / "a" / "b" / "x.png", tmp_path / "r" / "x.png"
    assert tmisc.imwrite(img, str(ours))
    assert jmisc.imwrite(img, str(ref))
    np.testing.assert_array_equal(cv2.imread(str(ours), cv2.IMREAD_COLOR),
                                  cv2.imread(str(ref), cv2.IMREAD_COLOR))
    tmisc.imwrite(img[..., 0], str(tmp_path / "a" / "g.png"))
    jmisc.imwrite(img[..., 0], str(tmp_path / "r" / "g.png"))
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "a" / "g.png"), cv2.IMREAD_COLOR),
        cv2.imread(str(tmp_path / "r" / "g.png"), cv2.IMREAD_COLOR))
    with pytest.raises(ValueError, match="PNG"):
        tmisc.imwrite(img, str(tmp_path / "x.jpg"))
    (tmp_path / "a" / ".hidden.png").write_bytes(b"")
    for kw in ({}, {"suffix": ".png"}, {"recursive": True},
               {"recursive": True, "full_path": True, "suffix": (".png",)}):
        assert (sorted(tmisc.scandir(str(tmp_path), **kw))
                == sorted(jmisc.scandir(str(tmp_path), **kw)))
    with pytest.raises(TypeError):
        list(tmisc.scandir(str(tmp_path), suffix=3))
