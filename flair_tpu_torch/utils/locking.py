"""Cooperative single-card lock.

Counterpart of ``flair_tpu/utils/locking.py``, with its names and its
semantics: an exclusive ``flock`` on a file local to the repo, so that
independent measurement runs on one card take turns instead of sharing
it. ``flock`` is released when the holder's file closes, SIGKILL included,
so a killed run never leaves the lock held.
"""

from __future__ import annotations

import errno
import fcntl
import os
import time
from typing import IO, Optional

import torch

_DEFAULT_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".gpu_lock")

# module-level reference: a hold for the process's lifetime survives GC
_held: Optional[IO[bytes]] = None


def acquire_tpu_lock(timeout_s: float = 0.0,
                     path: str | None = None) -> Optional[IO[bytes]]:
    """Take the exclusive card lock and hold it for the process's lifetime.

    Returns the open file (kept module-global; the lock drops when the
    process exits), or None if the lock stayed busy for ``timeout_s``
    seconds; 0 means one non-blocking attempt."""
    global _held
    if _held is not None:
        return _held
    f = open(path or _DEFAULT_PATH, "a+b")  # noqa: SIM115 - held for life
    deadline = time.time() + timeout_s
    while True:
        try:
            fcntl.flock(f.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
            try:
                f.seek(0)
                f.truncate()
                f.write(f"{os.getpid()} {time.strftime('%FT%T')}\n".encode())
                f.flush()
            except OSError:
                pass
            _held = f
            return f
        except OSError as e:
            if e.errno not in (errno.EAGAIN, errno.EACCES):
                f.close()
                raise
            if time.time() >= deadline:
                f.close()
                return None
            time.sleep(min(10.0, max(0.5, deadline - time.time())))


def tpu_lock_needed() -> bool:
    """The lock matters only when this process would run on the card: when
    ``utils.device.resolve_device(None)`` would choose CUDA."""
    return torch.cuda.is_available()
