"""Windowed video restoration driver and denoiser wrappers."""
