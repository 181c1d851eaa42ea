"""Mean device-timeline ms of a window's preparation inside
``restore_video``: from the window's start, or from the previous window's
last denoiser call, to the window's first call (init, SPyNet flows,
stitching, the noise draw)."""


def read(t):
    v = t["prep_ms"]
    return sum(v) / len(v) if v else None
