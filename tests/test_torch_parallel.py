"""Port multi-device layer (flair_tpu_torch.parallel) against
flair_tpu.parallel, float32 on the CPU, on one world of 4 gloo ranks.

The ranks are spawned once for the module (``parallel.LocalWorld``,
``file://`` rendezvous under tmp_path, 60 s group timeout, each call
joined within WORLD_TIMEOUT, a rank's exception failing the test); their
functions live in tests/torch_parallel_cases.py, which imports no JAX.
Each case holds the port against the JAX package on the same seeded numpy
inputs (JAX on its 8-device CPU mesh from tests/conftest.py), as
tests/test_parallel.py holds JAX against itself:

1. ``halo_exchange_frames`` (n = 4, replicate) against JAX's under
   shard_map, in both layouts, equal (exact copies); the zero edge against
   zero padding; a block shorter than the halo raises. ``frame_sharded``
   of a 3-frame mean on a (2, 2) mesh against JAX's on (2, 4): 1e-6.
2. ``group_norm(group=)`` against JAX ``group_norm(axis_name=)`` under
   shard_map: 1e-5.
3. ``Conv3d`` and ``ResBlock(dims=3)`` under a frame group against the
   unsharded port: forward, input and parameter gradients to 1e-5
   relative; ``shift_window_norm`` raises under a group.
4. ``frame_sharded_temporal_attention`` on a (2, 2) mesh against JAX's on
   (2, 4) and unsharded: 1e-5.
5. Mesh shapes, coordinates and groups; wrong sizes raise.
6. Data-parallel gradients (4 ranks, the first rank's weights broadcast)
   against ``jax.grad`` on one device: 1e-5.
7. The guided sampler on a (2, 2) mesh with a frame-coupled stub denoiser
   against JAX's ``guided_sample_loop`` unsharded (the same per-step
   noise): 1e-5.
"""

import numpy as np
import pytest
import torch

import torch_parallel_cases as cases

torch.set_num_threads(1)
WORLD = 4
WORLD_TIMEOUT = 300.0


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from flair_tpu_torch.parallel import LocalWorld

    init = tmp_path_factory.mktemp("world") / "init"
    with LocalWorld(WORLD, str(init), threads=1,
                    timeout=WORLD_TIMEOUT) as w:
        yield w


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def jax_halo(x, halo):
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from flair_tpu.parallel import make_mesh
    from flair_tpu.parallel.halo import halo_exchange_frames

    mesh = make_mesh(WORLD, axes=("frame",), shape=(WORLD,))
    fn = shard_map(lambda v: halo_exchange_frames(v, halo, "frame"),
                   mesh=mesh, in_specs=P(None, "frame"),
                   out_specs=P(None, "frame"))
    out = np.asarray(fn(jnp.asarray(x)))
    b, t = x.shape[:2]
    return out.reshape((b, WORLD, t // WORLD + 2 * halo) + x.shape[2:])


@pytest.mark.parametrize("layout", ["btc", "nchw"])
def test_halo_exchange_matches_flair_tpu(world, layout):
    x = rand(0, 2, 8, 3, 3, 5)
    for halo in (1, 2):
        want = jax_halo(x, halo)
        got = world.run(cases.halo_blocks, x, halo, "replicate", layout)
        for r in range(WORLD):
            np.testing.assert_array_equal(got[r], want[:, r])


def test_halo_exchange_zero_edge_and_short_block(world):
    x = rand(1, 1, 8, 2, 2, 3)
    halo = 2
    padded = np.concatenate([np.zeros_like(x[:, :halo]), x,
                             np.zeros_like(x[:, :halo])], 1)
    got = world.run(cases.halo_blocks, x, halo, "zero", "nchw")
    for r in range(WORLD):
        np.testing.assert_array_equal(got[r],
                                      padded[:, 2 * r:2 * r + 2 + 2 * halo])
    short = world.run(cases.halo_blocks, x, 3, "replicate", "btc")
    assert all(s.startswith("ValueError") and "3-frame halo" in s
               for s in short), short
    bad = world.run(cases.halo_blocks, x, 1, "reflect", "btc")
    assert all(s.startswith("ValueError: unknown edge") for s in bad), bad


def test_frame_sharded_matches_flair_tpu(world):
    import jax.numpy as jnp

    from flair_tpu.parallel import frame_sharded, make_mesh

    def mean3(v):
        p = jnp.concatenate([v[:, :1], v, v[:, -1:]], 1)
        return (p[:, :-2] + p[:, 1:-1] + p[:, 2:]) / 3

    x = rand(2, 2, 8, 3, 3, 4)
    mesh = make_mesh(8, axes=("data", "frame"), shape=(2, 4))
    with mesh:
        want = np.asarray(frame_sharded(mean3, mesh, halo=1)(jnp.asarray(x)))
    np.testing.assert_allclose(want, np.asarray(mean3(jnp.asarray(x))),
                               rtol=0, atol=1e-6)
    for got in world.run(cases.frame_sharded_mean3, x, (2, 2)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_group_norm_matches_flair_tpu(world):
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from flair_tpu.ops.norms import group_norm
    from flair_tpu.parallel import make_mesh

    x = rand(3, 2, 8, 4, 4, 16) * 2 + 0.5
    weight, bias = 1 + 0.1 * rand(4, 16), 0.1 * rand(5, 16)
    mesh = make_mesh(WORLD, axes=("frame",), shape=(WORLD,))
    fn = shard_map(lambda v: group_norm(v, 4, jnp.asarray(weight),
                                        jnp.asarray(bias), axis_name="frame"),
                   mesh=mesh, in_specs=P(None, "frame"),
                   out_specs=P(None, "frame"))
    want = np.asarray(fn(jnp.asarray(x)))
    got = np.concatenate(world.run(cases.group_norm_blocks, x, 4, weight,
                                   bias), 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["conv3d", "resblock3d"])
def test_temporal_modules_match_unsharded(world, kind):
    for err in world.run(cases.temporal_module_errors, kind, 0, 2, 8, 16, 4):
        assert max(err.values()) < 1e-5, err


def test_shift_window_norm_is_not_frame_shardable(world):
    assert world.run(cases.shift_window_norm_raises) == [
        "shift_window_norm is not frame-shardable"] * WORLD


def test_frame_sharded_temporal_attention_matches_flair_tpu(world):
    """As tests/test_parallel.py:77-105: the JAX module's variables (the
    zero-init projection made live) carried into the port by ``from_flax``;
    the port on a (data 2 × frame 2) mesh, 4 frames a rank, 2-frame halo."""
    import jax

    from flair_tpu.models.temporal import TemporalAttention
    from flair_tpu.parallel import (frame_sharded_temporal_attention,
                                    make_mesh)
    from flair_tpu.utils.checkpoint import flatten_params
    from flair_tpu_torch.utils.convert import from_flax

    b, t, h, w, c = 2, 8, 4, 4, 16
    x = rand(6, b, t, h, w, c)
    attn = TemporalAttention(c, num_frames=5, num_heads=2)
    params = attn.init(jax.random.PRNGKey(1), x)
    params = jax.tree_util.tree_map(
        lambda p: p + 0.05 * np.random.RandomState(0).standard_normal(
            p.shape).astype(np.float32), params)
    ref = np.asarray(attn.apply(params, x))
    mesh = make_mesh(8, axes=("data", "frame"), shape=(2, 4))
    with mesh:
        jsharded = np.asarray(frame_sharded_temporal_attention(
            attn, params, mesh)(x))
    state = {k: v.numpy() for k, v in from_flax(
        {"params/" + k: np.asarray(v) for k, v in
         flatten_params(params["params"]).items()}).items()}
    for got, reset in world.run(cases.temporal_attention_whole, state, x,
                                (2, 2), c, 5, 2):
        assert reset
        np.testing.assert_allclose(got, jsharded, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_mesh_shapes(world):
    """As tests/test_parallel.py:68-74, for a world of 4."""
    facts = world.run(cases.mesh_facts)
    coords = {"None": [(r, 0) for r in range(4)],
              "(1, 4)": [(0, r) for r in range(4)],
              "(2, 2)": [(r // 2, r % 2) for r in range(4)],
              "(4, 1)": [(r, 0) for r in range(4)]}
    shapes = {"None": (4, 1), "(1, 4)": (1, 4), "(2, 2)": (2, 2),
              "(4, 1)": (4, 1)}
    for r, f in enumerate(facts):
        for key, shape in shapes.items():
            assert f[key]["shape"] == shape
            assert f[key]["names"] == ("data", "frame")
            assert f[key]["coords"] == coords[key][r]
        # (2, 2): the data group is the column, the frame group the row
        assert f["(2, 2)"]["groups"] == ((r % 2, r % 2 + 2),
                                         (r // 2 * 2, r // 2 * 2 + 1))
        assert all(e is not None and "mesh" in e for e in f["errors"]), f


def test_data_parallel_grad_matches_single_device(world):
    """As tests/test_parallel.py:45-65: mean((x @ w)²) with x's rows over
    4 data ranks; the ranks start from different w and take the first
    rank's (``replicate_params``)."""
    import jax
    import jax.numpy as jnp

    ws = [rand(10 + r, 8, 4) for r in range(WORLD)]
    x = rand(1, 16, 8)
    want = np.asarray(jax.grad(lambda w: jnp.mean((jnp.asarray(x) @ w) ** 2))(
        jnp.asarray(ws[0])))
    for g, w in world.run(cases.data_parallel_grad, ws, x):
        np.testing.assert_array_equal(w, ws[0])
        np.testing.assert_allclose(g, want, rtol=0, atol=1e-5)


def test_guided_sampler_under_mesh_matches_flair_tpu(monkeypatch, world):
    """As tests/test_parallel.py:108-160: x8, 3 steps, SRConv consistency,
    the first frame pinned, a stub denoiser that rolls the frame axis. JAX
    unsharded with every step's noise patched to one array z; the port on
    a (data 2 × frame 2) mesh with the same z cut to each rank's block."""
    import jax
    import jax.numpy as jnp

    from flair_tpu.diffusion import (GuidanceConfig, guided_sample_loop,
                                     make_task_diffusion)
    from flair_tpu.operators.factory import get_operator, make_restore_fn

    d = make_task_diffusion("x8_bicubic", "3")
    b, t, s = 2, 4, 16
    op = get_operator("x8_bicubic", s)
    x0 = np.random.default_rng(0).uniform(-1, 1, (b, t, s, s, 3)).astype(
        np.float32)
    lr = np.asarray(op.A(jnp.asarray(x0).reshape(b * t, -1)))
    restore = make_restore_fn("x8_bicubic", op, jnp.asarray(lr).reshape(
        b * t, s // 8, s // 8, 3))

    def restore_fn(v):
        return restore(v.reshape((-1,) + v.shape[2:])).reshape(v.shape)

    def model_fn(x, tt):
        return 0.1 * x + 0.05 * jnp.roll(x, 1, axis=1)

    noise, z = rand(1, b, t, s, s, 3), rand(2, b, t, s, s, 3)
    pin_values = rand(3, b, t, s, s, 3) * 0.5
    pin_mask = jnp.zeros((b, t, 1, 1, 1), bool).at[:, :1].set(True)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=None, dtype=jnp.float32:
                        jnp.asarray(z, dtype))
    want = np.asarray(jax.jit(lambda nz: guided_sample_loop(
        d, model_fn, nz, jax.random.PRNGKey(2),
        GuidanceConfig(use_aux=False, w=0.85, rho=0.85),
        restore_fn=restore_fn, pin_mask=pin_mask,
        pin_values=jnp.asarray(pin_values)))(jnp.asarray(noise)))
    monkeypatch.undo()
    for got in world.run(cases.guided_sampler_whole, noise,
                         lr.reshape(b, t, -1), z, pin_values, (2, 2)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
