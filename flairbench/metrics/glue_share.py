"""Share (%) of the window's kernel time in memory-bound glue: the
elementwise, cat / copy and pad / layout classes of kernel names."""

from flairbench.roofline import GLUE


def read(t):
    total = sum(t["classes"].values())
    if not total:
        return None
    return 100.0 * sum(t["classes"].get(c, 0.0) for c in GLUE) / total
