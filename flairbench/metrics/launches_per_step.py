"""Kernel launches in the window per denoiser call (memory copies and
sets not counted)."""


def read(t):
    return sum(c for _, c in t["kernels"].values()) / t["steps"]
