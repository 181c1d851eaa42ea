"""Device ms of one guided update: the kernels launched inside the
program's ``update`` spans over their count."""


def read(t):
    return t.get("spans", {}).get("update_device_ms")
