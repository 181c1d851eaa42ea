"""Share (%) of the traced window in which no operation ran on the
device: 1 − (union of device operations ÷ window)."""


def read(t):
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
