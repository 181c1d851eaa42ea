"""Timestep samplers for training: uniform, and importance sampling by each
timestep's second loss moment.

Counterpart of ``flair_tpu/diffusion/resample.py`` (reference
guided_diffusion/resample.py:8-154). Draws come from an explicit
``torch.Generator``. The history update takes the whole batch's (t, loss)
pairs, already gathered across ranks (the reference all-gathers them,
resample.py:83-104).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


def uniform_sample(generator: torch.Generator, batch: int, num_timesteps: int,
                   device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """UniformSampler.sample (resample.py:23-62): t ~ U[0, T) as int64, and
    weights of 1."""
    dev = generator.device if device is None else device
    t = torch.randint(0, num_timesteps, (batch,), generator=generator,
                      device=dev)
    return t, torch.ones((batch,), dtype=torch.float32, device=dev)


@dataclasses.dataclass(frozen=True)
class LossAwareState:
    """Ring buffer of the last losses seen at each timestep
    (resample.py:108-154)."""

    loss_history: torch.Tensor  # (T, history_per_term) float32
    loss_counts: torch.Tensor   # (T,) int32

    @staticmethod
    def create(num_timesteps: int, history_per_term: int = 10,
               device=None) -> "LossAwareState":
        return LossAwareState(
            loss_history=torch.zeros((num_timesteps, history_per_term),
                                     dtype=torch.float32, device=device),
            loss_counts=torch.zeros((num_timesteps,), dtype=torch.int32,
                                    device=device))


def loss_aware_weights(state: LossAwareState,
                       uniform_prob: float = 0.001) -> torch.Tensor:
    """Sampling probabilities ∝ sqrt(E[loss²]) once every timestep's history
    is full, uniform before (resample.py:126-140)."""
    t, history_per_term = state.loss_history.shape
    warmed = bool((state.loss_counts == history_per_term).all())
    if not warmed:
        return torch.full((t,), 1.0 / t, dtype=torch.float32,
                          device=state.loss_history.device)
    weights = torch.sqrt(torch.mean(state.loss_history ** 2, dim=-1))
    weights = weights / torch.clamp(torch.sum(weights), min=1e-12)
    return weights * (1 - uniform_prob) + uniform_prob / t


def loss_aware_sample(generator: torch.Generator, state: LossAwareState,
                      batch: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """t drawn with ``loss_aware_weights`` (with replacement) and its
    importance weight 1 / (T·p[t]) (resample.py:44-62)."""
    p = loss_aware_weights(state)
    t = torch.multinomial(p, batch, replacement=True, generator=generator)
    weights = 1.0 / (p.shape[0] * p[t])
    return t, weights.float()


def update_with_losses(state: LossAwareState, ts, losses) -> LossAwareState:
    """The batch's (t, loss) pairs written into the ring buffer in batch
    order, as the reference's loop and the JAX scan write them: a timestep
    that appears twice in one batch takes both losses, one after the other.
    A full row drops its oldest loss (resample.py:142-154)."""
    hist = state.loss_history.clone()
    counts = state.loss_counts.clone()
    n = hist.shape[1]
    for t, loss in zip(torch.as_tensor(ts).tolist(),
                       torch.as_tensor(losses).tolist()):
        c = int(counts[t])
        if c == n:
            hist[t] = torch.cat([hist[t, 1:], hist.new_tensor([loss])])
        else:
            hist[t, c] = loss
        counts[t] = min(c + 1, n)
    return LossAwareState(loss_history=hist, loss_counts=counts)
