"""Port ops (flair_tpu_torch/ops) against flair_tpu on seeded numpy inputs.

Embeddings, norms, separable resizes, warps and attention, each held to
≤1e-5 absolute error in float32.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flair_tpu.ops import attention as j_attn
from flair_tpu.ops import embed as j_embed
from flair_tpu.ops import norms as j_norms
from flair_tpu.ops import resize as j_resize
from flair_tpu.ops import warp as j_warp
from flair_tpu_torch.ops import attention as t_attn
from flair_tpu_torch.ops import embed as t_embed
from flair_tpu_torch.ops import norms as t_norms
from flair_tpu_torch.ops import resize as t_resize
from flair_tpu_torch.ops import warp as t_warp

torch.set_num_threads(1)
ATOL = 1e-5


def rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def close(t_out, j_out, atol=ATOL):
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("dim", [32, 33])
def test_embeddings(dim):
    lvl = np.random.default_rng(0).uniform(0, 1, 7).astype(np.float32)
    ts = np.array([0, 1, 5, 17, 999, 3.5], np.float32)
    close(t_embed.sr3_noise_embedding(torch.from_numpy(lvl), dim),
          j_embed.sr3_noise_embedding(jnp.asarray(lvl), dim))
    close(t_embed.timestep_embedding(torch.from_numpy(ts), dim),
          j_embed.timestep_embedding(jnp.asarray(ts), dim))


def test_group_norm_joint_over_frames():
    x = rand(1, 2, 3, 5, 6, 16, scale=3.0) + 1.0
    wgt, bias = rand(2, 16), rand(3, 16)
    close(t_norms.group_norm(torch.from_numpy(x), 4, torch.from_numpy(wgt),
                             torch.from_numpy(bias)),
          j_norms.group_norm(jnp.asarray(x), 4, jnp.asarray(wgt),
                             jnp.asarray(bias)))


@pytest.mark.parametrize("win,mode", [(3, "replicate"), (5, "replicate"),
                                      (3, "zeros")])
def test_shift_window_group_norm(win, mode):
    x = rand(4, 2, 6, 4, 5, 8, scale=2.0)
    wgt, bias = rand(5, 8), rand(6, 8)
    close(t_norms.shift_window_group_norm(
        torch.from_numpy(x), 2, win, torch.from_numpy(wgt),
        torch.from_numpy(bias), padding_mode=mode),
        j_norms.shift_window_group_norm(
            jnp.asarray(x), 2, win, jnp.asarray(wgt), jnp.asarray(bias),
            padding_mode=mode))


@pytest.mark.parametrize("name", ["resize_bicubic", "resize_bilinear",
                                  "resize_area", "resize_bilinear_aa"])
@pytest.mark.parametrize("out_hw", [(16, 24), (5, 7)])
def test_separable_resizes(name, out_hw):
    x = rand(7, 2, 3, 8, 12, 3)
    close(getattr(t_resize, name)(torch.from_numpy(x), out_hw),
          getattr(j_resize, name)(jnp.asarray(x), out_hw))


def test_resize_matrix_nearest():
    np.testing.assert_array_equal(t_resize.resize_matrix(13, 5, "nearest"),
                                  j_resize.resize_matrix(13, 5, "nearest"))


def test_grid_sample_zeros_align_corners():
    img = rand(8, 2, 9, 11, 4)
    grid = np.random.default_rng(9).uniform(-1.3, 1.3, (2, 6, 7, 2)).astype(
        np.float32)
    out = t_warp.grid_sample(torch.from_numpy(img).permute(0, 3, 1, 2),
                             torch.from_numpy(grid))
    close(out.permute(0, 2, 3, 1),
          j_warp.grid_sample(jnp.asarray(img), jnp.asarray(grid)))


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_flow_warp(padding_mode):
    img = rand(10, 2, 12, 10, 64)
    flow = rand(11, 2, 12, 10, 2, scale=3.0)   # carries samples off-image
    out = t_warp.flow_warp(torch.from_numpy(img).permute(0, 3, 1, 2),
                           torch.from_numpy(flow).permute(0, 3, 1, 2),
                           padding_mode=padding_mode)
    close(out.permute(0, 2, 3, 1),
          j_warp.flow_warp(jnp.asarray(img), jnp.asarray(flow),
                           padding_mode=padding_mode))


def test_dot_product_attention():
    q, k, v = (rand(s, 2, 10, 3, 8) for s in (12, 13, 14))
    close(t_attn.dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                       scale=0.3),
          j_attn.dot_product_attention(*map(jnp.asarray, (q, k, v)),
                                       scale=0.3))


@pytest.mark.parametrize("t,f", [(5, 3), (4, 7)])
def test_temporal_window_attention(t, f):
    q, k, v = (rand(s, 2, t, 3, 4, 16) for s in (15, 16, 17))
    k_pos = rand(18, f - 1, 16)
    close(t_attn.temporal_window_attention(
        *map(torch.from_numpy, (q, k, v, k_pos)), f, 4),
        j_attn.temporal_window_attention(
            *map(jnp.asarray, (q, k, v, k_pos)), f, 4))
