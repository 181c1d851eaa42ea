"""Device ms a denoiser call of the kernels launched inside the
program's ``vsrpp`` spans: BasicVSR++ with its K1 launches."""


def read(t):
    return t.get("spans", {}).get("vsrpp_ms")
