"""KV logger with human / JSON / CSV / TensorBoard sinks.

Counterpart of ``flair_tpu/utils/logging.py`` (the reference
guided_diffusion/logger.py:26-495, OpenAI-baselines style): ``logkv`` /
``logkv_mean`` accumulate, ``dumpkvs`` fans out to the configured writers.
Under ``torch.distributed`` rank 0 writes the default sinks and other ranks
their own log file; gradients are already averaged inside the step.
"""

from __future__ import annotations

import csv
import datetime
import json
import os
import os.path as osp
import sys
import tempfile
from collections import defaultdict
from typing import Any, Dict, Optional

DEBUG = 10
INFO = 20
WARN = 30
ERROR = 40
DISABLED = 50


class KVWriter:
    def writekvs(self, kvs: Dict[str, Any]) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class SeqWriter:
    def writeseq(self, seq) -> None:
        raise NotImplementedError


class HumanOutputFormat(KVWriter, SeqWriter):
    """Boxed human-readable table (logger.py:36-95)."""

    def __init__(self, filename_or_file):
        if isinstance(filename_or_file, str):
            self.file = open(filename_or_file, "wt")
            self.own_file = True
        else:
            self.file = filename_or_file
            self.own_file = False

    def writekvs(self, kvs):
        key2str = {}
        for key, val in sorted(kvs.items()):
            valstr = f"{val:<8.3g}" if hasattr(val, "__float__") else str(val)
            key2str[self._truncate(key)] = self._truncate(valstr)
        if not key2str:
            print("WARNING: tried to write empty key-value dict")
            return
        keywidth = max(map(len, key2str.keys()))
        valwidth = max(map(len, key2str.values()))
        dashes = "-" * (keywidth + valwidth + 7)
        lines = [dashes]
        for key, val in sorted(key2str.items(), key=lambda kv: kv[0].lower()):
            lines.append(
                f"| {key}{' ' * (keywidth - len(key))} | "
                f"{val}{' ' * (valwidth - len(val))} |"
            )
        lines.append(dashes)
        self.file.write("\n".join(lines) + "\n")
        self.file.flush()

    @staticmethod
    def _truncate(s: str) -> str:
        maxlen = 30
        return s[: maxlen - 3] + "..." if len(s) > maxlen else s

    def writeseq(self, seq):
        self.file.write(" ".join(map(str, seq)) + "\n")
        self.file.flush()

    def close(self):
        if self.own_file:
            self.file.close()


class JSONOutputFormat(KVWriter):
    """JSON-lines sink (logger.py:98-112)."""

    def __init__(self, filename):
        self.file = open(filename, "wt")

    def writekvs(self, kvs):
        out = {
            k: (float(v) if hasattr(v, "dtype") or hasattr(v, "__float__") else v)
            for k, v in kvs.items()
        }
        self.file.write(json.dumps(out) + "\n")
        self.file.flush()

    def close(self):
        self.file.close()


class CSVOutputFormat(KVWriter):
    """CSV with dynamic column migration (logger.py:115-157)."""

    def __init__(self, filename):
        self.filename = filename
        self.file = open(filename, "w+t", newline="")
        self.keys: list[str] = []

    def writekvs(self, kvs):
        extra = sorted(set(kvs.keys()) - set(self.keys))
        if extra:
            self.keys += extra
            self.file.seek(0)
            lines = self.file.readlines()
            self.file.seek(0)
            self.file.truncate()
            w = csv.writer(self.file)
            w.writerow(self.keys)
            for line in lines[1:]:
                self.file.write(line[:-1] + "," * len(extra) + "\n")
        w = csv.writer(self.file)
        w.writerow([kvs.get(k, "") for k in self.keys])
        self.file.flush()

    def close(self):
        self.file.close()


class TensorBoardOutputFormat(KVWriter):
    """TensorBoard events through ``torch.utils.tensorboard``
    (logger.py:160-186), imported when the sink is made; it raises if the
    ``tensorboard`` package is missing."""

    def __init__(self, logdir):
        from torch.utils.tensorboard import SummaryWriter

        self.writer = SummaryWriter(logdir)
        self.step = 0

    def writekvs(self, kvs):
        step = int(kvs.get("step", self.step))
        for k, v in kvs.items():
            try:
                self.writer.add_scalar(k, float(v), step)
            except (TypeError, ValueError):
                pass
        self.step = step + 1

    def close(self):
        self.writer.close()


def make_output_format(fmt: str, ev_dir: str, log_suffix: str = "") -> KVWriter:
    os.makedirs(ev_dir, exist_ok=True)
    if fmt == "stdout":
        return HumanOutputFormat(sys.stdout)
    if fmt == "log":
        return HumanOutputFormat(osp.join(ev_dir, f"log{log_suffix}.txt"))
    if fmt == "json":
        return JSONOutputFormat(osp.join(ev_dir, f"progress{log_suffix}.json"))
    if fmt == "csv":
        return CSVOutputFormat(osp.join(ev_dir, f"progress{log_suffix}.csv"))
    if fmt == "tensorboard":
        return TensorBoardOutputFormat(osp.join(ev_dir, f"tb{log_suffix}"))
    raise ValueError(f"Unknown format specified: {fmt}")


class Logger:
    DEFAULT: Optional["Logger"] = None
    CURRENT: Optional["Logger"] = None

    def __init__(self, dir: Optional[str], output_formats):
        self.name2val: Dict[str, float] = defaultdict(float)
        self.name2cnt: Dict[str, int] = defaultdict(int)
        self.level = INFO
        self.dir = dir
        self.output_formats = output_formats

    def logkv(self, key, val):
        self.name2val[key] = val

    def logkv_mean(self, key, val):
        oldval, cnt = self.name2val[key], self.name2cnt[key]
        self.name2val[key] = oldval * cnt / (cnt + 1) + val / (cnt + 1)
        self.name2cnt[key] = cnt + 1

    def dumpkvs(self):
        out = self.name2val.copy()
        for fmt in self.output_formats:
            if isinstance(fmt, KVWriter):
                fmt.writekvs(self.name2val)
        self.name2val.clear()
        self.name2cnt.clear()
        return out

    def log(self, *args, level=INFO):
        if self.level <= level:
            for fmt in self.output_formats:
                if isinstance(fmt, SeqWriter):
                    fmt.writeseq(map(str, args))

    def set_level(self, level):
        self.level = level

    def get_dir(self):
        return self.dir

    def close(self):
        for fmt in self.output_formats:
            fmt.close()


def _rank() -> int:
    """The ``torch.distributed`` rank once it is initialised, else 0."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def configure(dir: Optional[str] = None, format_strs=None, log_suffix=""):
    """(logger.py:442-470). Env: FLAIR_LOGDIR / FLAIR_LOG_FORMAT; the default
    directory is a new one under the temporary directory."""
    if dir is None:
        dir = os.getenv("FLAIR_LOGDIR") or osp.join(
            tempfile.gettempdir(),
            datetime.datetime.now().strftime("flair-%Y-%m-%d-%H-%M-%S-%f"),
        )
    os.makedirs(dir, exist_ok=True)

    rank = _rank()
    if format_strs is None:
        if rank == 0:
            format_strs = os.getenv(
                "FLAIR_LOG_FORMAT", "stdout,log,csv"
            ).split(",")
        else:
            format_strs = os.getenv("FLAIR_LOG_FORMAT_MPI", "log").split(",")
            log_suffix = log_suffix or f"-rank{rank:03d}"
    format_strs = [f for f in format_strs if f]
    output_formats = [make_output_format(f, dir, log_suffix) for f in format_strs]
    Logger.CURRENT = Logger(dir=dir, output_formats=output_formats)
    if output_formats:
        log(f"Logging to {dir}")


def get_current() -> Logger:
    if Logger.CURRENT is None:
        configure()
    return Logger.CURRENT


def logkv(key, val):
    get_current().logkv(key, val)


def logkv_mean(key, val):
    get_current().logkv_mean(key, val)


def logkvs(d):
    for k, v in d.items():
        logkv(k, v)


def dumpkvs():
    return get_current().dumpkvs()


def log(*args, level=INFO):
    get_current().log(*args, level=level)


def set_level(level):
    get_current().set_level(level)


def get_dir():
    return get_current().get_dir()

