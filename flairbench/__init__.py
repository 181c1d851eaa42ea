"""The benchmark of ``flair_tpu_torch``: ``python3 -m flairbench.run``."""
