"""A world of ranks on this host, for tests and the measurement script.

``LocalWorld(n, init_file)`` spawns ``n`` processes (``spawn``: the parent
may hold CUDA or threads), joins them into one ``torch.distributed`` world
(``file://`` rendezvous, ``GROUP_TIMEOUT``), and runs module-level
functions on every rank: ``world.run(fn, *args)`` returns each rank's
result, in rank order, and raises if any rank raised, died or did not
answer within ``timeout`` seconds (``submit`` then ``collect`` lets the
caller work meanwhile). Under NCCL rank r uses card
r % device_count; gloo ranks use whatever device their functions name
(several may share ``cuda:0``). A rank unpickles its functions by module
path, so they live at module level in modules the ranks can import (spawn
gives them the parent's ``sys.path``). Users on several hosts or cards
start their ranks with ``torchrun`` instead.
"""

from __future__ import annotations

import multiprocessing
import traceback

import torch
import torch.distributed as dist

from .mesh import GROUP_TIMEOUT


def _rank_main(rank, n, backend, init_file, threads, conn):
    if threads:
        torch.set_num_threads(threads)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    try:
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                rank=rank, world_size=n,
                                timeout=GROUP_TIMEOUT)
        conn.send(("ok", None))
        while True:
            msg = conn.recv()
            if msg is None:
                break
            fn, args, kwargs = msg
            try:
                conn.send(("ok", fn(*args, **kwargs)))
            except BaseException:  # reported to the caller, who raises
                conn.send(("err", traceback.format_exc()))
    except BaseException:
        conn.send(("err", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        conn.close()


class LocalWorld:
    def __init__(self, n: int, init_file: str, *, backend: str = "gloo",
                 threads: int = 0, timeout: float = 600.0):
        """``init_file``: a path no other world uses (it must not exist);
        ``threads``: torch threads a rank (0: torch's default)."""
        ctx = multiprocessing.get_context("spawn")
        self.timeout = timeout
        self.procs, self.conns = [], []
        try:
            for r in range(n):
                mine, theirs = ctx.Pipe()
                p = ctx.Process(target=_rank_main, daemon=True, args=(
                    r, n, backend, init_file, threads, theirs))
                p.start()
                theirs.close()
                self.procs.append(p)
                self.conns.append(mine)
            self._collect("start")
        except BaseException:
            self.close()
            raise

    def _collect(self, what):
        results, errors = [], []
        for r, conn in enumerate(self.conns):
            if not conn.poll(self.timeout):
                errors.append(f"rank {r}: no answer in {self.timeout} s")
                results.append(None)
                continue
            try:
                status, value = conn.recv()
            except EOFError:
                status, value = "err", "the process ended"
            if status != "ok":
                errors.append(f"rank {r}: {value}")
            results.append(value if status == "ok" else None)
        if errors:
            raise RuntimeError(f"{what} failed on {len(errors)} rank(s):\n"
                               + "\n".join(errors))
        return results

    def submit(self, fn, *args, **kwargs) -> None:
        """Start ``fn(*args, **kwargs)`` on every rank; ``collect`` waits."""
        for conn in self.conns:
            conn.send((fn, args, kwargs))
        self._pending = getattr(fn, "__name__", "run")

    def collect(self) -> list:
        """The results of the submitted call, in rank order."""
        return self._collect(self._pending)

    def run(self, fn, *args, **kwargs) -> list:
        """``fn(*args, **kwargs)`` on every rank; their results."""
        self.submit(fn, *args, **kwargs)
        return self.collect()

    def close(self) -> None:
        for conn in self.conns:
            try:
                conn.send(None)
            except (BrokenPipeError, OSError):
                pass
        for p in self.procs:
            p.join(30)
            if p.is_alive():
                p.terminate()
                p.join(10)
        for conn in self.conns:
            conn.close()
        self.procs, self.conns = [], []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
