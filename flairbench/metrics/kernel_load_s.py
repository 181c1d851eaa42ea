"""Host seconds of the set-up's outermost ``kernels.load`` spans: nvcc
where a library is missing, then ``ctypes.CDLL`` (``utils/build.load``)."""


def read(t):
    return t.get("spans", {}).get("kernel_load_s")
