"""Small configurations of the two cells for the CPU tests: the goldens'
x8 and gaussian model sizes at 64² output, four ddim steps, float32 (the
program's plain path on the CPU), and the cells' own limits; and the x8
configuration with the face prior on, its networks the tiny ones of
``flairbench/reference/tiny_face.py``, registered here as program models
(the CodeFormer also as a bf16 program) and named as their own
reference."""

import json
import os

from flair_tpu_torch.models.registry import register_model

from flairbench.reference.nn import Layer, round_bf16
from flairbench.reference.tiny_face import TinyCodeFormer, TinyParseNet

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIGS = os.path.join(os.path.dirname(HERE), "configs")


def cell_limits(name):
    with open(os.path.join(CONFIGS, name + ".json")) as f:
        return json.load(f)["limits"]


X8 = {"task": "x8_bicubic", "input_size": 8, "output_size": 64,
      "steps": "ddim4", "dtype": "float32", "model": "bicubic_unet",
      "wrapper": "wrap_bicubic_model", "reference": "sr3.BicubicUNet",
      "model_kwargs": dict(inner_channel=32, norm_groups=16,
                           channel_mults=[1, 2], attn_res=[32],
                           vsrpp_res=[64], image_size=64, res_blocks=1,
                           num_frames=3, head_dim=8),
      "limits": cell_limits("flair_bicubic_unet")}
BLUR = {"task": "gaussian", "input_size": 16, "output_size": 64,
        "steps": "ddim4", "dtype": "float32", "model": "blur_unet",
        "wrapper": "wrap_blur_model", "reference": "adm.BlurUNet",
        "model_kwargs": dict(image_size=64, in_channels=6, model_channels=32,
                             out_channels=6, num_res_blocks=1,
                             attention_resolutions=[2], rnn_resolutions=[1],
                             channel_mult=[1, 2], num_heads=1,
                             num_head_channels=8, use_scale_shift_norm=True,
                             temporal_frames=5),
        "limits": cell_limits("flair_blur_unet")}
# two windows and a tail: window 4, overlap 2
TRAFFIC = {"clips": 1, "frames": 12, "shift": 1.0, "window": 4,
           "overlap": 2, "warmup_calls": 2}
SEED = 2 ** 31 + 12345



class ProgramTinyCodeFormer(TinyCodeFormer):
    """The tiny CodeFormer as the program runs it: the reference's class,
    apart so that a test can plant a fault in the program alone."""


class BF16TinyCodeFormer(ProgramTinyCodeFormer):
    """The tiny CodeFormer computing as a bf16 program: every product's
    operands rounded to bfloat16, its code logits too."""

    def __init__(self, **kw):
        super().__init__(**kw)
        for m in self.modules():
            if isinstance(m, Layer):
                m.rounding = round_bf16

    def forward(self, x, w=0.0, adain=False, codes=None):
        return super().forward(round_bf16(x), w, adain, codes)


register_model("bench_tiny_codeformer")(ProgramTinyCodeFormer)
register_model("bench_tiny_codeformer_bf16")(BF16TinyCodeFormer)
register_model("bench_tiny_parsenet")(TinyParseNet)
# the x8 face prior at 64²: the chip's frame → face matrix with its
# translation scaled to the size; the crop and the step held to the
# step's limit, the networks' numbers to limits between the bf16 tiny
# CodeFormer's readings and the control's
X8_FACE = dict(
    X8, face_prior=True,
    face={"codeformer": {"model": "bench_tiny_codeformer",
                         "kwargs": {"width": 8, "codes": 16},
                         "wrapper": "wrap_codeformer",
                         "reference": "tiny_face.TinyCodeFormer",
                         "record": {"codes": "idx_pred"}},
          "parsenet": {"model": "bench_tiny_parsenet",
                       "kwargs": {"width": 8, "background": 1.0},
                       "wrapper": "wrap_parsenet",
                       "reference": "tiny_face.TinyParseNet"},
          "matrix": [[1.1, 0.08, 1.5], [-0.08, 1.1, -1.125]]},
    limits=dict(X8["limits"], face=3e-4, codes=1e-2, restored=1e-2,
                parse=1e-2))
