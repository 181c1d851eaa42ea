"""The whole step's share (%) of the card's 989 TFLOP/s bf16 peak: the
reference's FLOPs of the window's denoiser calls and of each started
window's flows, over the window's seconds."""

from flairbench.roofline import PEAK_BF16


def read(t):
    flops = t["steps"] * t["flops_call"] + t["windows"] * t["flops_window"]
    return 100.0 * flops / t["window_s"] / PEAK_BF16
