"""flair_tpu_torch: the PyTorch / CUDA port of flair_tpu for NVIDIA Hopper.

Same sub-package layout and module names as ``flair_tpu`` so every module
has an obvious counterpart:

- ``flair_tpu_torch.ops``        — primitives (embeddings, norms, resizes,
                                   warps, blur, DCT/JPEG, EMA, patch
                                   tiling), and the deformable conv
                                   and flash attention, whose CUDA kernels
                                   live in ``csrc/``.
- ``flair_tpu_torch.operators``  — degradation operators (x8/x16 SVD SRConv,
                                   gaussian/jpeg PseudoSR).
- ``flair_tpu_torch.models``     — BicubicUNet, BlurUNet, SPyNet, BasicVSR++,
                                   blocks, CodeFormer, ParseNet, RetinaFace
                                   and its ResNet body.
- ``flair_tpu_torch.face``       — face prior: host alignment geometry,
                                   on-device crop / mask / paste, 5-point
                                   alignment, facelib helpers.
- ``flair_tpu_torch.diffusion``  — schedules, respacing, guided sampler,
                                   training losses, timestep samplers.
- ``flair_tpu_torch.train``      — the training step (AdamW by optax's
                                   rules, EMA streams) and the host loop
                                   with save / resume.
- ``flair_tpu_torch.pipeline``   — windowed video restoration driver.
- ``flair_tpu_torch.utils``      — weight conversion (flax and upstream
                                   torch names), checkpoints, configs,
                                   logging, PNG I/O, devices, kernel builds.
- ``flair_tpu_torch.cli``        — the entry point: ``python -m
                                   flair_tpu_torch.cli <task> ...``.

The package imports torch, numpy and the standard library only (no cv2,
no PIL). Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; they never fall back to the CPU.
Public functions take the JAX package's host layout ((T, h, w, 3) clips in
[0, 1]); inside, activations are NCHW tensors with (B·T) folded, in
``torch.channels_last`` memory format.
"""

__version__ = "0.1.0"
