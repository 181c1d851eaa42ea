"""Device ms a denoiser call of the kernels launched inside the
program's ``attention`` spans: spatial attention with its K2 launches
(none in a model without it, and then no reading)."""


def read(t):
    return t.get("spans", {}).get("attention_ms")
