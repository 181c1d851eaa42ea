"""Device ms a denoiser call of the kernels launched inside the
program's ``temporal`` spans: temporal attention, its gates and the 3-D
resnet blocks."""


def read(t):
    return t.get("spans", {}).get("temporal_ms")
