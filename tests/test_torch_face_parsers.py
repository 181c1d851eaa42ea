"""The port's BiSeNet parser and YOLOv5-face detectors
(flair_tpu_torch/models/{bisenet,yolov5face}.py) against flair_tpu, at the
configurations of tests/test_face_models.py::test_bisenet_shapes and
tests/test_davsr_yolo.py (YOLOv5Face at width 8, the yolov5n-face graph
through YOLOv5FromConfig).

Seeded numpy variables in the flax model's shapes
(``flax_init.random_flax_params``, norm scales near 1, BatchNorm running
statistics away from (0, 1)) go into both, carried into the port by
``from_flax`` with a strict load; the same seeded inputs go through both
in float32, the JAX side jitted. Every map within 1e-5 of its largest
|value|; ``decode_predictions`` gives the same detections from the JAX
maps in both packages, and from the port's own maps. The bundled configs
equal the JAX package's, and ``load_yolo_yaml`` reads a YAML dump of them
back.

The ``cuda`` test runs the port on the card against its own CPU run
(``pytest --noconftest -m cuda``); it skips here.
"""

import os

import numpy as np
import pytest
import torch

from flax_init import random_flax_params, with_norms
from flair_tpu_torch.models import yolov5face as ty
from flair_tpu_torch.models.bisenet import BiSeNet
from flair_tpu_torch.utils.convert import from_flax

torch.set_num_threads(1)
REL_TOL = 1e-5
SMALL_YOLO = dict(width=8, depth=(1, 1, 1, 1))


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def carried(jm, seed, x):
    """Flat flax variables and the port's state_dict of them."""
    flat = with_norms(random_flax_params(jm, seed, x), seed + 1)
    return flat, from_flax(flat)


def assert_close(t_out, j_out, name):
    j_out = np.asarray(j_out)
    assert t_out.shape == j_out.shape, name
    np.testing.assert_allclose(t_out, j_out, rtol=0,
                               atol=REL_TOL * np.abs(j_out).max(),
                               err_msg=name)


def test_bisenet():
    """test_bisenet_shapes: three 19-class maps at 64² (the nearest ×2
    crops and the align-corners upsample included)."""
    import jax

    from flair_tpu.models.bisenet import BiSeNet as J
    from flair_tpu.utils.checkpoint import unflatten_params

    x = np.random.RandomState(7).rand(1, 64, 64, 3).astype(np.float32)
    jm = J(num_class=19)
    flat, state = carried(jm, 0, x)
    j_outs = jax.jit(jm.apply)(unflatten_params(flat), x)
    tm = BiSeNet(num_class=19)
    tm.load_state_dict(state, strict=True)
    with torch.no_grad():
        t_outs = tm.eval()(nchw(x))
    assert len(t_outs) == 3
    for name, t, j in zip(("out", "out16", "out32"), t_outs, j_outs):
        assert t.shape == (1, 19, 64, 64)
        assert_close(nhwc(t), j, name)


def test_bisenet_odd_size():
    """A 40×56 input: feat16 and feat8 are odd-sized, so the ×2 repeats
    are cropped."""
    import jax

    from flair_tpu.models.bisenet import BiSeNet as J
    from flair_tpu.utils.checkpoint import unflatten_params

    x = np.random.RandomState(8).rand(1, 40, 56, 3).astype(np.float32)
    jm = J(num_class=5)
    flat, state = carried(jm, 2, x)
    j_outs = jax.jit(jm.apply)(unflatten_params(flat), x)
    tm = BiSeNet(num_class=5)
    tm.load_state_dict(state, strict=True)
    with torch.no_grad():
        t_outs = tm.eval()(nchw(x))
    for name, t, j in zip(("out", "out16", "out32"), t_outs, j_outs):
        assert_close(nhwc(t), j, name)


def assert_same_detections(t_maps, j_maps):
    """``decode_predictions`` of both packages on the JAX maps: equal; of
    the port's maps: the same boxes to float rounding."""
    from flair_tpu.models.yolov5face import decode_predictions as j_decode

    j_maps = [np.asarray(m) for m in j_maps]
    ref = j_decode(j_maps, conf_thres=0.0)
    np.testing.assert_array_equal(ty.decode_predictions(j_maps,
                                                        conf_thres=0.0), ref)
    ours = ty.decode_predictions([nhwc(m) for m in t_maps], conf_thres=0.0)
    assert ours.ndim == 2 and ours.shape[1] == 16 and len(ours) > 0
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-3)


def test_yolov5face_forward_and_decode():
    """test_yolov5face_forward_and_decode: YOLOv5Face at width 8 on a 64²
    image, its three raw maps, and the host decode + NMS."""
    import jax

    from flair_tpu.models.yolov5face import YOLOv5Face as J
    from flair_tpu.utils.checkpoint import unflatten_params

    x = np.random.RandomState(2).rand(1, 64, 64, 3).astype(np.float32)
    jm = J(**SMALL_YOLO)
    flat, state = carried(jm, 4, x)
    j_maps = jax.jit(jm.apply)(unflatten_params(flat), x)
    tm = ty.YOLOv5Face(**SMALL_YOLO)
    tm.load_state_dict(state, strict=True)
    with torch.no_grad():
        t_maps = tm.eval()(nchw(x))
    assert len(t_maps) == 3 and t_maps[0].shape == (1, 48, 8, 8)
    for i, (t, j) in enumerate(zip(t_maps, j_maps)):
        assert_close(nhwc(t), j, f"level {i}")
    assert_same_detections(t_maps, j_maps)


def test_yolov5n_from_config():
    """test_yolov5_yaml_model_family: the yolov5n-face graph (StemBlock,
    ShuffleV2Blocks at strides 1 and 2, the channel shuffle, C3 head)
    through the interpreter, on a 64² image."""
    import jax

    from flair_tpu.models.yolov5face import YOLOv5FromConfig as J
    from flair_tpu.utils.checkpoint import unflatten_params

    x = np.random.RandomState(3).rand(1, 64, 64, 3).astype(np.float32)
    jm = J(ty.YOLOV5N_FACE_CFG)
    flat, state = carried(jm, 6, x)
    j_maps = jax.jit(jm.apply)(unflatten_params(flat), x)
    tm = ty.YOLOv5FromConfig(ty.YOLOV5N_FACE_CFG)
    tm.load_state_dict(state, strict=True)
    with torch.no_grad():
        t_maps = tm.eval()(nchw(x))
    assert [tuple(m.shape) for m in t_maps] == [
        (1, 48, 8, 8), (1, 48, 4, 4), (1, 48, 2, 2)]
    for i, (t, j) in enumerate(zip(t_maps, j_maps)):
        assert_close(nhwc(t), j, f"level {i}")
    assert_same_detections(t_maps, j_maps)


def test_bundled_configs_and_yaml(tmp_path):
    """The port's bundled configs, anchors and strides equal the JAX
    package's; ``load_yolo_yaml`` reads a YAML dump of each back (Detect's
    ['nc', 'anchors'] placeholders resolved), and importing the module
    needs no pyyaml."""
    import subprocess
    import sys

    yaml = pytest.importorskip("yaml")
    from flair_tpu.models import yolov5face as jy

    assert ty.YOLOV5L_FACE_CFG == jy.YOLOV5L_FACE_CFG
    assert ty.YOLOV5N_FACE_CFG == jy.YOLOV5N_FACE_CFG
    np.testing.assert_array_equal(ty.ANCHORS, jy.ANCHORS)
    assert ty.STRIDES == jy.STRIDES
    for cfg in (ty.YOLOV5L_FACE_CFG, ty.YOLOV5N_FACE_CFG):
        raw = {k: ([list(a) for a in v] if k == "anchors" else v)
               for k, v in cfg.items()}
        raw["head"] = [r if r[2] != "Detect" else r[:3] + [["nc", "anchors"]]
                       for r in raw["head"]]
        path = tmp_path / "model.yaml"
        path.write_text(yaml.safe_dump(raw))
        assert ty.load_yolo_yaml(str(path)) == cfg
        assert ty.load_yolo_yaml(str(path)) == jy.load_yolo_yaml(str(path))
    code = ("import sys\nsys.modules['yaml'] = None\n"
            "import flair_tpu_torch.models.yolov5face as m\n"
            "m.YOLOv5FromConfig(m.YOLOV5N_FACE_CFG)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


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
@pytest.mark.parametrize("name", ["bisenet", "yolov5face", "yolov5n"])
def test_cuda_face_parsers_match_cpu(cuda_device, name):
    """The constructors' seeded weights (kernels N(0, 1/fan_in)), f32 with
    TF32 off: the card against the CPU, every map within 1e-5 of its
    largest |value|."""
    make = {"bisenet": lambda: BiSeNet(),
            "yolov5face": lambda: ty.YOLOv5Face(**SMALL_YOLO),
            "yolov5n": lambda: ty.YOLOv5FromConfig(ty.YOLOV5N_FACE_CFG)}
    torch.manual_seed(0)
    model = make[name]().eval()
    x = torch.rand(1, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = model(x)
        out = model.to(cuda_device)(x.to(cuda_device))
    for o, r in zip(out, ref):
        err = (o.cpu() - r).abs().max().item()
        assert err <= REL_TOL * r.abs().max().item(), err
