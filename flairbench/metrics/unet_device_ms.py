"""Device ms of one denoiser call: the kernels launched inside the
program's ``denoiser`` spans (``join.span_metrics``) over the calls."""


def read(t):
    return t.get("spans", {}).get("unet_device_ms")
