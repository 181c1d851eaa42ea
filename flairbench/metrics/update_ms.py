"""Mean device-timeline ms from the end of a denoiser call to the start
of the next call of the same window: the guided update (x0, the
consistency operator, pinning, the DDIM step) and the host time around
it."""


def read(t):
    v = t["update_ms"]
    return sum(v) / len(v) if v else None
