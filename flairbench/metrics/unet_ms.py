"""Mean CUDA-event ms of one wrapped denoiser call (``model_apply``)."""


def read(t):
    v = t["unet_ms"]
    return sum(v) / len(v) if v else None
