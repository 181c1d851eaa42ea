"""What the benchmark makes from ``--seed``: the weights, the degraded clip
and the diffusion noise. Both sides of a comparison draw them here, so the
program and the reference receive the same numbers and the reference takes
nothing that the program made.
"""

from __future__ import annotations

import math

import numpy as np
import torch

WEIGHTS, CLIP, NOISE, FACE_WEIGHTS = 1, 2, 3, 4
# the face prior's networks; each draws its weights from the draw of
# FACE_WEIGHTS at its place here
FACE_NETS = ("codeformer", "parsenet")


def stream(seed: int, tag: int, index: int = 0) -> int:
    """A generator seed for draw ``index`` of stream ``tag`` of a run."""
    return (seed * 1_000_003 + tag * 1_000_000_007 + index) % (2 ** 63)


def weight_scale(name: str, shape) -> tuple[float, float]:
    """(mean, std) of a parameter's draw: kernels N(0, 1/fan_in), norm
    scales N(1, 0.1²), biases N(0, 0.02²). A trained network keeps its
    activations at unit scale; these draws do too, so every layer shapes
    the output and the comparison sees them all.

    BasicVSR++'s offset heads (``offset_out``) take a tenth of that: a
    trained one starts at zero and learns residues that correct the flow
    by a pixel or two. At the full scale every residue saturates at the
    ±M pixels of M·tanh, and the propagation turns chaotic: in the
    gaussian model a 1e-6 change of x grew to 14 % of eps (float32, 64²),
    each VSR++ site multiplying it by about five; at a tenth it stays
    2e-6."""
    if len(shape) >= 2:
        std = 1.0 / math.sqrt(math.prod(shape[1:]))
        return 0.0, std * (0.1 if "offset_out" in name else 1.0)
    if name.endswith("weight"):
        return 1.0, 0.1
    return 0.0, 0.02


def fill_weights(model: torch.nn.Module, seed: int, device,
                 tag: int = WEIGHTS, index: int = 0) -> None:
    """Draw every parameter of ``model`` in one call on ``device`` from
    draw ``index`` of stream ``tag`` (the denoiser's by default; each face
    network has a draw of ``FACE_WEIGHTS``), in the order of the sorted
    parameter names, and make the parameters views of that one float32
    buffer (a model built on ``meta`` gets them too)."""
    params = sorted(model.named_parameters())
    total = sum(p.numel() for _, p in params)
    gen = torch.Generator(device=device).manual_seed(stream(seed, tag, index))
    flat = torch.randn(total, generator=gen, device=device)
    off = 0
    with torch.no_grad():
        for name, p in params:
            mean, std = weight_scale(name, p.shape)
            v = flat[off:off + p.numel()].view(p.shape)
            v.mul_(std).add_(mean)
            owner, _, leaf = name.rpartition(".")
            setattr(model.get_submodule(owner), leaf,
                    torch.nn.Parameter(v, requires_grad=p.requires_grad))
            off += p.numel()


def moving_clip(seed: int, clips: int, frames: int, size: int,
                shift: float) -> np.ndarray:
    """(clips, frames, size, size, 3) float32 in [0.05, 0.95]: per clip and
    channel a sinusoidal pattern moving ``shift`` pixels a frame, its
    phases and frequencies drawn from the seed."""
    gen = torch.Generator().manual_seed(stream(seed, CLIP))
    ph = torch.rand(clips, 1, 1, 1, 3, generator=gen) * 6.28
    fr = 0.1 + 0.3 * torch.rand(2, clips, 1, 1, 1, 3, generator=gen)
    yy = torch.arange(size, dtype=torch.float32).view(1, 1, size, 1, 1)
    xx = torch.arange(size, dtype=torch.float32).view(1, 1, 1, size, 1)
    t = torch.arange(frames, dtype=torch.float32).view(1, frames, 1, 1, 1)
    v = torch.sin(fr[0] * yy + fr[1] * (xx - shift * t) + ph)
    return (0.5 + 0.45 * v).numpy()


class Noise:
    """The diffusion noise as a ``noise_fn(shape)``: draw i comes from its
    own generator, so the reference can draw any of them again."""

    def __init__(self, seed: int, device):
        self.seed, self.device, self.draws = seed, torch.device(device), 0

    def draw(self, shape, index: int) -> torch.Tensor:
        gen = torch.Generator(device=self.device).manual_seed(
            stream(self.seed, NOISE, index))
        return torch.randn(tuple(shape), generator=gen, device=self.device)

    def __call__(self, shape) -> torch.Tensor:
        self.draws += 1
        return self.draw(shape, self.draws - 1)
