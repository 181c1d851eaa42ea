"""The host training loop: data, skip-frame interpolation, quartile
logging, save and resume.

Counterpart of ``flair_tpu/train/runner.py`` (reference TrainLoop host side,
train_util.py:183-334):
- ``run_loop`` draws from the data iterator and runs the step, and honours
  ``DIFFUSION_TRAINING_TEST`` (train_util.py:199-200, the CI escape hatch);
- with ``skip > 1`` the low-res conditioning of temporally decimated clips
  is densified by a frame interpolator before the step, merged round-robin
  (train_util.py:231-250);
- losses are logged as means and per timestep quartile
  (train_util.py:359-365);
- each save writes ``state_{step:06d}`` (``utils.checkpoint.save_pytree``):
  the model and each EMA stream under flat flax names (``model.npz``,
  ``ema_<i>.npz``: ``utils.checkpoint.load_params`` and the CLI's
  ``--checkpoint`` read them) and ``train_state.npz`` (step, update count,
  generator state, the AdamW moments); a new runner resumes from the
  latest one, so a resumed run repeats a straight one.

``TrainRunner(mesh=)`` (JAX stores the mesh and never reads it,
runner.py:98,108) trains data- and frame-parallel: the first rank's
parameters are broadcast at construction, each batch is cut by
``parallel.shard_batch``, the step sums the gradients over the mesh, and
only the mesh's first rank logs and writes checkpoints (the others wait at
a barrier after a save); every rank resumes from the same files.
"""

from __future__ import annotations

import os
import re
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ..parallel import (is_first_rank, mesh_barrier, replicate_params,
                        shard_batch)
from ..utils import convert
from ..utils import logging as logger
from ..utils.checkpoint import load_pytree, save_pytree
from ..utils.device import resolve_device
from .loop import TrainConfig, create_train_state, make_train_step


def interpolate_skipped_frames(interpolate: Callable, low_res: torch.Tensor,
                               skip: int) -> torch.Tensor:
    """Densify (B, N, H, W, 3) conditioning: between each adjacent pair,
    ``skip - 1`` frames from ``interpolate(f0, f1, skip)`` ((B·(N-1), H, W,
    3) each → (B·(N-1), skip-1, H, W, 3)), merged round-robin
    (train_util.py:231-250): f_0, mid_0…, f_1, mid_1…, …, f_{N-1}."""
    b, n = low_res.shape[0], low_res.shape[1]
    f0 = low_res[:, :-1].reshape((b * (n - 1),) + tuple(low_res.shape[2:]))
    f1 = low_res[:, 1:].reshape((b * (n - 1),) + tuple(low_res.shape[2:]))
    mid = interpolate(f0, f1, skip)
    mid = mid.reshape((b, n - 1) + tuple(mid.shape[1:]))
    pieces = []
    for i in range(n - 1):
        pieces.append(low_res[:, i:i + 1])
        pieces.append(mid[:, i])
    pieces.append(low_res[:, n - 1:])
    return torch.cat(pieces, dim=1)


def log_loss_quartiles(num_timesteps: int, t: np.ndarray,
                       loss_each: np.ndarray, key: str = "loss") -> None:
    """logkv_mean of the loss and of its per-timestep-quartile buckets
    (train_util.py:359-365)."""
    logger.logkv_mean(key, float(np.mean(loss_each)))
    for ti, li in zip(np.asarray(t).ravel(), np.asarray(loss_each).ravel()):
        quartile = int(4 * int(ti) / num_timesteps)
        logger.logkv_mean(f"{key}_q{quartile}", float(li))


def find_resume_checkpoint(ckpt_dir: str) -> tuple[Optional[str], int]:
    """The latest ``state_{step:06d}`` directory and its step
    (train_util.py:322-334 filename-parse semantics)."""
    if not os.path.isdir(ckpt_dir):
        return None, 0
    best = (None, 0)
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"state_(\d{6,})", name)
        if m and int(m.group(1)) >= best[1]:
            best = (os.path.join(ckpt_dir, name), int(m.group(1)))
    return best


class TrainRunner:
    """Host loop around the training step.

    ``model``: the module being trained (moved to ``device``; its own
    parameters are updated); ``apply_fn(params, x_t, ts, batch)`` its
    denoiser, e.g. ``pipeline.wrappers.wrap_bicubic_train``; ``diffusion``
    on ``device``. ``data`` yields dicts with at least ``x_start``
    (B, T, H, W, C) in [-1, 1], numpy or torch. ``interpolate(f0, f1, skip)``
    densifies ``low_res_input`` when ``skip > 1``. ``device`` defaults to
    cuda and raises without a card (``device="cpu"`` runs on the CPU).
    ``mesh``: a ``parallel.make_mesh`` mesh; every rank builds the runner
    with the same arguments and passes the same whole batches."""

    def __init__(self, diffusion, apply_fn: Callable, cfg: TrainConfig,
                 model: torch.nn.Module, *,
                 ckpt_dir: str = "./checkpoints_out", log_interval: int = 10,
                 save_interval: int = 10000, skip: int = 1,
                 interpolate: Optional[Callable] = None,
                 generator: Optional[torch.Generator] = None, device=None,
                 mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.first = mesh is None or is_first_rank(mesh)
        self.d = diffusion
        self.cfg = cfg
        self.ckpt_dir = ckpt_dir
        self.log_interval = log_interval
        self.save_interval = save_interval
        self.skip = skip
        self.interpolate = interpolate
        self.generator = (torch.Generator(self.device).manual_seed(0)
                          if generator is None else generator)
        model.to(self.device)
        if mesh is not None:
            replicate_params(mesh, model)
        self.names = convert.flax_names(model)
        self.state = create_train_state(dict(model.named_parameters()), cfg)
        resume_path, self.resume_step = find_resume_checkpoint(ckpt_dir)
        if resume_path is not None:
            if self.first:
                logger.log(f"resuming from {resume_path} "
                           f"(step {self.resume_step})")
            self._restore(load_pytree(resume_path))
        self.train_step = make_train_step(diffusion, apply_fn, cfg, mesh=mesh)
        self.step = 0

    def _prepare(self, batch) -> dict:
        batch = {k: torch.as_tensor(v, device=self.device)
                 for k, v in batch.items()}
        if self.skip > 1 and "low_res_input" in batch:
            if self.interpolate is None:
                raise ValueError("skip > 1 requires a frame interpolator")
            batch["low_res_input"] = interpolate_skipped_frames(
                self.interpolate, batch["low_res_input"], self.skip)
        return batch if self.mesh is None else shard_batch(self.mesh, batch)

    def run_step(self, batch) -> dict:
        """One step; returns the host metrics (``grads`` stays on the
        device)."""
        self.state, metrics = self.train_step(self.state,
                                              self._prepare(batch),
                                              self.generator)
        host = {k: v.detach().cpu().numpy() for k, v in metrics.items()
                if k != "grads"}
        host["grads"] = metrics["grads"]
        if self.first:
            log_loss_quartiles(self.d.num_timesteps, host["t"],
                               host["loss_each"])
            logger.logkv("step", self.step + self.resume_step)
            logger.logkv_mean("grad_norm", float(host["grad_norm"]))
            logger.logkv_mean("param_norm", float(host["param_norm"]))
        self.step += 1
        return host

    def _tree(self) -> dict:
        st, opt = self.state, self.state.opt_state
        flat = lambda v: convert.to_flax(v, self.names)  # noqa: E731
        train = {"step": np.int64(st.step), "count": np.int64(opt.count),
                 "generator": self.generator.get_state().numpy()}
        train.update({f"mu/{k}": v for k, v in flat(opt.mu).items()})
        train.update({f"nu/{k}": v for k, v in flat(opt.nu).items()})
        tree = {"model": flat(st.params), "train_state": train}
        for i, ema in enumerate(st.ema_params):
            tree[f"ema_{i}"] = flat(ema)
        return tree

    @torch.no_grad()
    def _restore(self, tree: dict) -> None:
        st, opt = self.state, self.state.opt_state
        train = tree["train_state"]

        def load(dst, flat):
            src = convert.from_flax(flat)
            for k, v in dst.items():
                v.copy_(src[k])

        load(st.params, tree["model"])
        load(opt.mu, {k[3:]: v for k, v in train.items()
                      if k.startswith("mu/")})
        load(opt.nu, {k[3:]: v for k, v in train.items()
                      if k.startswith("nu/")})
        for i, ema in enumerate(st.ema_params):
            load(ema, tree[f"ema_{i}"])
        st.step = int(train["step"])
        opt.count = int(train["count"])
        self.generator.set_state(torch.from_numpy(train["generator"]))

    def save(self) -> str:
        step = self.step + self.resume_step
        path = os.path.join(self.ckpt_dir, f"state_{step:06d}")
        if self.first:
            logger.log(f"saving model at step {step}...")
            save_pytree(path, self._tree())
        if self.mesh is not None:
            mesh_barrier(self.mesh)
        return path

    def run_loop(self, data: Iterator[dict], max_steps: int = 0) -> None:
        """Train until lr_anneal_steps or max_steps; save on cadence
        (train_util.py:183-207)."""
        while True:
            total = self.step + self.resume_step
            if self.cfg.lr_anneal_steps and total >= self.cfg.lr_anneal_steps:
                break
            if max_steps and self.step >= max_steps:
                break
            self.run_step(next(data))
            if self.step % self.log_interval == 0 and self.first:
                logger.dumpkvs()
            if self.step % self.save_interval == 0 and self.step != 0:
                self.save()
                if os.environ.get("DIFFUSION_TRAINING_TEST", ""):
                    return
        if (self.step - 1) % self.save_interval != 0:
            self.save()
