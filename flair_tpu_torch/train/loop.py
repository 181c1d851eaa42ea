"""The training step: loss, gradients, clipping, AdamW, EMA.

Counterpart of ``flair_tpu/train/loop.py`` (reference train_util.py:37-365):
- bf16 compute with float32 parameters, as the JAX package trains (no loss
  scaling): the trunk casts its float32 parameters at use;
- microbatches accumulate ``grad / n_micro`` in order, as the JAX scan
  does (the reference's DDP ``no_sync``, train_util.py:255-278);
- one float32 EMA stream per rate (``ops.ema``);
- the optimizer follows optax's rules, not ``torch.optim``'s: the global
  norm clip scales by ``max_norm / norm`` only when ``norm >= max_norm``
  (no epsilon), the linear anneal reads the update count before it is
  incremented, AdamW takes b1 0.9, b2 0.999 and eps 1e-8 outside the
  square root, and decoupled decay ``lr · wd · p``.

A step updates the parameters (the model's own tensors), the optimizer
moments and the EMA streams in place. Randomness (t, noise) comes from an
explicit ``torch.Generator``, or is injected.

Under a mesh (``make_train_step(mesh=)``, every rank calling with its
``parallel.shard_batch`` slice of the same global batch) the step is data-
and frame-parallel: t and the noise are drawn for the global batch on every
rank and cut, each rank's loss is its mean over its share divided by the
mesh size (so the ranks' losses sum to the global loss and the collectives'
adjoints are exact), and the gradients are summed over the mesh, flattened
into one buffer, before the norm, the clip and AdamW; with a ``frame`` axis
the model runs under its frame group and SPyNet reads the whole clip's
``rnn_input`` (default ``low_res_input``), gathered over the frame axis.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..diffusion import Diffusion, training_losses
from ..diffusion.resample import uniform_sample
from ..ops.ema import ema_update
from ..parallel import (all_gather_frames, all_reduce_mean, axis_size,
                        set_frame_group, shard, sum_over_mesh_)

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Flags mirrored from the reference argparse surface
    (script_util.py:14-62, train_util.py:37-99)."""

    lr: float = 1e-4
    weight_decay: float = 0.0
    ema_rates: Sequence[float] = (0.9999,)
    microbatch: int = -1          # clips per microbatch; -1 = whole batch
    grad_clip: float = 0.0
    lr_anneal_steps: int = 0


@dataclasses.dataclass
class AdamState:
    """optax ``ScaleByAdamState``: the update count and both moments."""

    count: int
    mu: Params
    nu: Params


@dataclasses.dataclass
class TrainState:
    step: int
    params: Params                     # the model's own float32 parameters
    opt_state: AdamState
    ema_params: tuple                  # one float32 Params per EMA rate


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of every element's square (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


class AdamW:
    """``optax.chain([clip_by_global_norm(c)], adamw(lr | linear_schedule(lr,
    0, N), weight_decay=wd))`` as ``make_optimizer`` builds it, updating in
    place."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg

    def init(self, params: Params) -> AdamState:
        return AdamState(
            count=0,
            mu={k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()},
            nu={k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()})

    def _lr(self, count: int) -> float:
        """The step size at update ``count`` (float32 arithmetic, as optax's
        ``linear_schedule`` computes it)."""
        cfg = self.cfg
        if cfg.lr_anneal_steps <= 0:
            return cfg.lr
        n = cfg.lr_anneal_steps
        frac = np.float32(1) - np.float32(min(max(count, 0), n)) / np.float32(n)
        return float(np.float32(cfg.lr) * frac + np.float32(0.0))

    @torch.no_grad()
    def update_(self, params: Params, grads: Params, state: AdamState) -> None:
        """One update of ``params`` and ``state`` in place from ``grads``."""
        cfg = self.cfg
        scale = None
        if cfg.grad_clip > 0:
            g_norm = global_norm(grads.values())
            if not bool(g_norm < cfg.grad_clip):
                scale = g_norm
        count = state.count + 1
        bc1 = float(1 - np.float32(self.b1) ** np.float32(count))
        bc2 = float(1 - np.float32(self.b2) ** np.float32(count))
        step = -self._lr(state.count)
        for k, p in params.items():
            g = grads[k]
            if scale is not None:
                g = (g / scale) * cfg.grad_clip
            mu, nu = state.mu[k], state.nu[k]
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            u = u + cfg.weight_decay * p
            p.add_(u * step)
        state.count = count


def make_optimizer(cfg: TrainConfig) -> AdamW:
    """The optimizer of ``cfg`` (``flair_tpu.train.loop.make_optimizer``)."""
    return AdamW(cfg)


def create_train_state(params: Params, cfg: TrainConfig) -> TrainState:
    """A step-0 state for ``params`` (the model's own parameters, float32):
    zero moments and one float32 copy per EMA rate."""
    return TrainState(
        step=0, params=params, opt_state=make_optimizer(cfg).init(params),
        ema_params=tuple({k: p.detach().float().clone()
                          for k, p in params.items()}
                         for _ in cfg.ema_rates))


def _split(v, n: int):
    return v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:])).unbind(0)


def make_train_step(d: Diffusion, apply_fn: Callable, cfg: TrainConfig,
                    mesh=None):
    """The training step ``step(state, batch, generator=None, *, t=None,
    noise=None) → (state, metrics)``.

    ``apply_fn(params, x_t, ts, batch)`` is the denoiser; ``batch`` holds at
    least ``x_start`` (B, T, H, W, C) and the extras ``apply_fn`` reads.
    ``t`` (B,) is drawn uniformly from ``generator`` and shared by a clip's
    frames (train_util.py:252-253), then the noise; either can be given
    instead. Metrics: ``loss``, ``grad_norm`` (before clipping),
    ``param_norm`` (after the update), ``loss_each`` (B,), ``t`` and
    ``grads`` (each parameter's gradient; None where it did not reach the
    loss, which then updates as a zero gradient, as JAX's would be).

    ``mesh``: a ``parallel.make_mesh`` mesh with ``data`` and / or
    ``frame`` axes; ``batch`` is then this rank's ``shard_batch`` slice,
    ``t`` and ``noise`` (when given) and the metrics are global, and
    ``apply_fn.model`` is the module whose frame group is set. Microbatches
    split the rank's slice, and the global noise is drawn once before the
    split."""
    tx = make_optimizer(cfg)
    names = () if mesh is None else mesh.mesh_dim_names
    frame_group = mesh.get_group("frame") if "frame" in names else None
    if frame_group is not None and not hasattr(apply_fn, "model"):
        raise ValueError("frame-parallel training needs apply_fn.model")
    # the cuts of a (B, T, ...) tensor, as parallel.batch_sharding makes
    data = [(0, "data")] if "data" in names else []
    frames = [(1, "frame")] if frame_group is not None else []

    def one_micro(params, micro, t, noise, generator):
        x = micro["x_start"]
        b, tw = x.shape[0], x.shape[1]

        def model_fn(x_t, t_b):
            return apply_fn(params, x_t, t_b[:, None].expand(b, tw), micro)

        with torch.enable_grad():
            terms = training_losses(d, model_fn, x, t, generator, noise=noise)
            loss = terms["loss"].mean()
            if mesh is not None:
                loss = loss / mesh.size()
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
        return loss.detach(), terms["loss"].detach(), grads

    def train_step(state: TrainState, batch: dict,
                   generator: Optional[torch.Generator] = None, *,
                   t=None, noise=None):
        if mesh is None:
            return step(state, batch, generator, t, noise)
        x = batch["x_start"]
        global_shape = list(x.shape)
        for dim, axis in data + frames:
            global_shape[dim] *= axis_size(mesh, axis)
        if t is None:
            t, _ = uniform_sample(generator, global_shape[0], d.num_timesteps,
                                  device=x.device)
        if noise is None:
            noise = torch.randn(global_shape, generator=generator,
                                dtype=x.dtype, device=x.device)
        t_global = t
        t, noise = shard(t, mesh, data), shard(noise, mesh, data + frames)
        if frame_group is not None:
            src = batch.get("rnn_input", batch.get("low_res_input"))
            if src is not None:
                batch = dict(batch,
                             rnn_input=all_gather_frames(src, frame_group, 1))
        model = None if frame_group is None else apply_fn.model
        if model is not None:
            set_frame_group(model, frame_group)
        try:
            state, metrics = step(state, batch, generator, t, noise)
        finally:
            if model is not None:
                set_frame_group(model, None)
        metrics["t"] = t_global
        return state, metrics

    def reduce_over_mesh(loss, loss_each, dense):
        """The global loss, (B,) losses and gradients from this rank's."""
        sum_over_mesh_(list(dense.values()) + [loss], mesh)
        with torch.no_grad():
            if frame_group is not None:
                loss_each = all_reduce_mean(loss_each, frame_group)
            if "data" in names:
                loss_each = all_gather_frames(loss_each,
                                              mesh.get_group("data"), 0)
        return loss, loss_each

    def step(state, batch, generator, t, noise):
        b = batch["x_start"].shape[0]
        if t is None:
            t, _ = uniform_sample(generator, b, d.num_timesteps,
                                  device=batch["x_start"].device)
        params = state.params
        if cfg.microbatch in (-1, 0) or cfg.microbatch >= b:
            loss, loss_each, grads = one_micro(params, batch, t, noise,
                                               generator)
        else:
            n_micro = b // cfg.microbatch
            micros = [dict(zip(batch, vals)) for vals in
                      zip(*(_split(v, n_micro) for v in batch.values()))]
            noises = (_split(noise, n_micro) if noise is not None
                      else [None] * n_micro)
            loss = 0.0
            acc = [torch.zeros_like(p) for p in params.values()]
            used = [False] * len(acc)
            each = []
            for micro, t_i, n_i in zip(micros, _split(t, n_micro), noises):
                l_i, e_i, g_i = one_micro(params, micro, t_i, n_i, generator)
                loss = loss + l_i / n_micro
                each.append(e_i)
                for i, g in enumerate(g_i):
                    if g is not None:
                        acc[i] = acc[i] + g / n_micro
                        used[i] = True
            grads = [a if u else None for a, u in zip(acc, used)]
            loss_each = torch.cat(each)
        grads = dict(zip(params, grads))
        dense = {k: torch.zeros_like(p) if grads[k] is None else grads[k]
                 for k, p in params.items()}
        if mesh is not None:
            loss, loss_each = reduce_over_mesh(loss, loss_each, dense)
            grads = {k: None if g is None else dense[k]
                     for k, g in grads.items()}
        grad_norm = global_norm(dense.values())
        tx.update_(params, dense, state.opt_state)
        for ema, rate in zip(state.ema_params, cfg.ema_rates):
            ema_update(ema, params, rate)
        state.step += 1
        metrics = {"loss": loss, "grad_norm": grad_norm,
                   "param_norm": global_norm(p.detach() for p in
                                             params.values()),
                   "loss_each": loss_each, "t": t, "grads": grads}
        return state, metrics

    return train_step
