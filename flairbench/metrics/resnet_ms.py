"""Device ms a denoiser call of the kernels launched inside the
program's ``resnet`` spans: the 2-D resnet blocks."""


def read(t):
    return t.get("spans", {}).get("resnet_ms")
