"""K1's share (%) of its roofline: the least time of every DCN site's
work in the window's calls (bytes at 3.35 TB/s or FLOPs at 989 TFLOP/s,
from the reference's DCN shapes) over the device time of K1's kernels."""


def read(t):
    sec = sum(s for n, (s, _) in t["kernels"].items() if "dcn_raw" in n.lower())
    if not sec or not t["k1_bound_ms"]:
        return None
    return 100.0 * t["k1_bound_ms"] * t["steps"] / 1e3 / sec
