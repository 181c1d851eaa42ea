"""K2's share (%) of its roofline: the least time of every spatial
attention site's work in the window's calls over the device time of K2's
kernels."""


def read(t):
    sec = sum(s for n, (s, _) in t["kernels"].items()
              if "flash_fwd" in n.lower())
    if not sec or not t["k2_bound_ms"]:
        return None
    return 100.0 * t["k2_bound_ms"] * t["steps"] / 1e3 / sec
