"""Device ms of one window's preparation: the kernels launched inside the
program's ``prep`` spans over their count."""


def read(t):
    return t.get("spans", {}).get("prep_device_ms")
