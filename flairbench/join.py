"""The join of a traced window's kernels to the program's host spans
(``flair_tpu_torch.utils.spans``), by launch.

The host runs up to ~60 ms ahead of the device (the launch queue holds
~1 K launches), so a kernel that runs while a span is open may have been
launched from the span before; overlap in time cannot assign it. Each
device operation carries the correlation id of the CUDA runtime or driver
call that launched it, and that call's host stamp falls inside one
innermost span: the kernel is that span's. Span stamps and the profiler's
are both Unix-epoch nanoseconds.

    python3 -m flairbench.join --workload x8_window --seed 7 --seconds 51 \\
        [--spans 0]

runs one traced window of a cell as ``flairbench.run --trace 1`` does,
with the program's spans recorded from before the model is built
(``--spans 0``: not recorded, to measure what recording costs), prints the
span table and the join's checks on standard error and one JSON line on
standard output. It does not compare the window's outputs with the
reference; ``flairbench.run`` does.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from .roofline import GLUE, kernel_class  # noqa: E402

NO_SPAN = "(no span)"
# sub-layers of the denoiser: their device time per call is read beside
# the denoiser's own
SUBLAYERS = ("resnet", "temporal", "vsrpp", "attention")


def events_of(prof):
    """Device operations of a finished profiler as (name, start_ns, end_ns,
    correlation id), and the host stamp of the earliest host event of each
    correlation id: the runtime or driver call that launched it."""
    from torch._C._autograd import DeviceType
    ops, launches = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                ops.append((e.name(), e.start_ns(), e.end_ns(),
                            e.correlation_id()))
        else:
            c, t = e.correlation_id(), e.start_ns()
            if c and t < launches.get(c, t + 1):
                launches[c] = t
    return ops, launches


def split(records, t0_ns):
    """The set-up's records (entered before ``t0_ns``) and the window's,
    their parents re-indexed (a parent in the set-up becomes -1)."""
    k = next((i for i, r in enumerate(records) if r[2] >= t0_ns),
             len(records))
    return records[:k], [(n, p - k if p >= k else -1, a, b)
                         for n, p, a, b in records[k:]]


def setup_seconds(records):
    """Host seconds of the set-up's ``model.build``, ``kernels.load`` and
    warm-up ``window`` spans (outermost of each name; a build of the
    kernels happens inside the warm-up)."""
    out = {"model.build": 0.0, "kernels.load": 0.0, "window": 0.0}
    for n, p, a, b in records:
        if n in out and not _under(records, p, n):
            out[n] += (b - a) / 1e9
    return out


def _under(records, i, name):
    """Whether record ``i`` or an ancestor of it is named ``name``."""
    while i >= 0:
        if records[i][0] == name:
            return True
        i = records[i][1]
    return False


def attribute(kernels, launches, records):
    """Each kernel to the innermost span open at its launch's host stamp.

    ``kernels``: the window's device operations as ``events_of`` gives
    them (memory copies and sets make idle gaps but are not kernels);
    ``launches``: host stamp by correlation id; ``records``: the window's
    spans. Returns, by span name (``NO_SPAN`` for kernels launched outside
    every span, or with no launch event): ``n`` instances (outermost of
    their name), inclusive ``device_s`` / ``launches``, ``self_s`` /
    ``self_launches``, ``kernels`` (self seconds and launches by kernel
    name) and ``idle_s``, the device idle time in gaps between operations
    whose host-clock midpoint lies inside that innermost span; and
    ``coverage``, the share of kernel time launched inside some span."""
    starts = [r[2] for r in records]

    def innermost(t):
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and records[i][3] < t:
            i = records[i][1]
        return i

    nrec = len(records)
    # by record index; index nrec holds what no span launched
    self_s, idle = [0.0] * (nrec + 1), [0.0] * (nrec + 1)
    self_n, by_kernel = [0] * (nrec + 1), [None] * (nrec + 1)
    ops = sorted(kernels, key=lambda op: op[1])
    cursor = ops[0][1] if ops else 0
    for name, s, e, corr in ops:
        if s > cursor:
            i = innermost((s + cursor) // 2)
            idle[i if i >= 0 else nrec] += (s - cursor) / 1e9
        cursor = max(cursor, e)
        if name.startswith(("Memcpy", "Memset")):
            continue
        t = launches.get(corr)
        i = innermost(t) if t is not None else -1
        i = i if i >= 0 else nrec
        self_s[i] += (e - s) / 1e9
        self_n[i] += 1
        d = by_kernel[i] = by_kernel[i] or {}
        k = d.setdefault(name, [0.0, 0])
        k[0] += (e - s) / 1e9
        k[1] += 1
    incl_s, incl_n = self_s[:nrec], self_n[:nrec]
    for i in range(nrec - 1, -1, -1):
        p = records[i][1]
        if p >= 0:
            incl_s[p] += incl_s[i]
            incl_n[p] += incl_n[i]
    incl_s.append(self_s[nrec])
    incl_n.append(self_n[nrec])
    out = {}
    for i in range(nrec + 1):
        name, parent = records[i][:2] if i < nrec else (NO_SPAN, -1)
        r = out.setdefault(name, {
            "n": 0, "device_s": 0.0, "launches": 0, "self_s": 0.0,
            "self_launches": 0, "idle_s": 0.0, "kernels": {}})
        if not _under(records, parent, name):     # outermost of its name
            r["n"] += i < nrec
            r["device_s"] += incl_s[i]
            r["launches"] += incl_n[i]
        r["self_s"] += self_s[i]
        r["self_launches"] += self_n[i]
        r["idle_s"] += idle[i]
        for k, (sec, cnt) in (by_kernel[i] or {}).items():
            acc = r["kernels"].setdefault(k, [0.0, 0])
            acc[0] += sec
            acc[1] += cnt
    total = sum(self_s)
    return {"spans": out,
            "coverage": 1.0 - self_s[nrec] / total if total else None}


def span_metrics(att, setup=None):
    """The per-layer numbers the spans give: device ms per denoiser call
    (``unet_device_ms`` and each sub-layer's, ``attention_ms`` only where
    attention ran), per update and per window's preparation; the set-up's
    ``model.build`` and ``kernels.load`` seconds."""
    s = att["spans"]
    n = {name: r["n"] for name, r in s.items()}
    calls = n.get("denoiser", 0)
    out = {}
    for metric, name, count in (
            ("unet_device_ms", "denoiser", calls),
            ("update_device_ms", "update", n.get("update")),
            ("prep_device_ms", "prep", n.get("prep")),
            ("resnet_ms", "resnet", calls), ("temporal_ms", "temporal", calls),
            ("vsrpp_ms", "vsrpp", calls),
            ("attention_ms", "attention", calls)):
        if name in s and count:
            out[metric] = 1e3 * s[name]["device_s"] / count
    for metric, name in (("model_build_s", "model.build"),
                         ("kernel_load_s", "kernels.load")):
        if setup and setup[name]:
            out[metric] = setup[name]
    return out


def table(att) -> str:
    """One row per span name: instances, device ms per denoiser call and
    per instance (inclusive, then self), launches per instance, the glue
    share of the self time, and the idle ms with the host inside it per
    call; then the coverage."""
    calls = att["spans"].get("denoiser", {}).get("n") or 1
    rows = [f"{'span':<10} {'n':>6} {'ms/call':>9} {'ms/inst':>9} "
            f"{'self ms':>9} {'launches':>9} {'glue %':>7} {'idle/call':>9}"]
    order = sorted(att["spans"].items(), key=lambda kv: -kv[1]["device_s"])
    for name, r in order:
        n = max(r["n"], 1)
        glue = sum(sec for k, (sec, _) in r["kernels"].items()
                   if kernel_class(k) in GLUE)
        glue = 100.0 * glue / r["self_s"] if r["self_s"] else 0.0
        rows.append(
            f"{name:<10} {r['n']:>6} {1e3 * r['device_s'] / calls:>9.3f} "
            f"{1e3 * r['device_s'] / n:>9.3f} {1e3 * r['self_s'] / n:>9.3f} "
            f"{r['launches'] / n:>9.1f} {glue:>7.1f} "
            f"{1e3 * r['idle_s'] / calls:>9.3f}")
    cov = att["coverage"]
    rows.append("coverage: " + ("no kernels" if cov is None else
                                f"{100.0 * cov:.3f} % of the kernel time "
                                "was launched inside a span"))
    return "\n".join(rows)


def checks(att, unet_ms):
    """The join's checks on a cell's window: every K1 launch in a
    ``vsrpp`` span and every K2 launch in an ``attention`` span (counts
    per call), the denoiser's sub-layers within its device time, that
    within the CUDA-event span of a call, and the coverage."""
    s = att["spans"]
    calls = s.get("denoiser", {}).get("n", 0) or 1

    def count(pattern, where=None):
        return sum(c for name, r in s.items() if where in (None, name)
                   for k, (_, c) in r["kernels"].items()
                   if pattern in k.lower())

    m = span_metrics(att)
    sub = sum(m.get(f"{n}_ms", 0.0) for n in SUBLAYERS)
    unet = m.get("unet_device_ms", 0.0)
    return {"k1_per_call": count("dcn_raw") / calls,
            "k1_in_vsrpp_per_call": count("dcn_raw", "vsrpp") / calls,
            "k2_per_call": count("flash_fwd") / calls,
            "k2_in_attention_per_call":
                count("flash_fwd", "attention") / calls,
            "sublayers_ms": sub, "unet_device_ms": unet, "unet_ms": unet_ms,
            "sublayers_within_denoiser": sub <= unet + 1e-9,
            "denoiser_within_unet_ms": unet_ms is None or unet <= unet_ms,
            "coverage": att["coverage"]}


def summary_of(att, top=12):
    """``att`` for a JSON line: each span's kernels cut to the ``top``
    by seconds, and its self seconds by kernel class."""
    out = {}
    for name, r in att["spans"].items():
        classes = {}
        for k, (sec, _) in r["kernels"].items():
            c = kernel_class(k)
            classes[c] = classes.get(c, 0.0) + sec
        ks = sorted(r["kernels"].items(), key=lambda kv: -kv[1][0])[:top]
        out[name] = dict(r, kernels=[[k[:120], sec, cnt]
                                     for k, (sec, cnt) in ks],
                         classes=classes)
    return out


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m flairbench.join")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--spans", type=int, choices=(0, 1), default=1)
    return p.parse_args(argv)


def traced_window(config, traffic, seed, seconds, trace, device, t_start,
                  record=True):
    """``harness.run_window`` with the program's spans recorded from
    before the model is built (none when not ``record``, or when the
    program has no ``utils.spans``): the run's record, with the set-up's
    and the window's span records under ``span_records``, split at the
    window's start (``t_start`` + its set-up on the host clock)."""
    from . import harness
    try:
        from flair_tpu_torch.utils import spans
    except ImportError:
        spans = None
    offset = time.time_ns() - time.perf_counter_ns()
    if record and spans is not None:
        spans.start()
    try:
        rec = harness.run_window(config, traffic, seed, seconds, trace,
                                 device, t_start)
    finally:
        records = spans.stop() if spans is not None else []
    t0_ns = int((t_start + rec["setup_s"]) * 1e9) + offset
    rec["span_records"] = split(records, t0_ns)
    return rec


def main(argv=None) -> int:
    args = parse(argv)
    import torch
    from . import harness
    bench, cell, config, traffic = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("flairbench.join: needs a CUDA card", file=sys.stderr)
        return 2
    rec = traced_window(config, traffic, args.seed, args.seconds, True,
                        "cuda", T_START, record=bool(args.spans))
    setup_records, window = rec["span_records"]
    summary = harness.trace_summary(rec, config, traffic)
    names = [m["name"] for m in bench["per_layer"]
             if cell["name"] in m.get("workloads", [cell["name"]])]
    metrics = harness.per_layer(summary, names)
    att = summary["attribution"]
    result = {"workload": args.workload, "seed": args.seed,
              "spans": bool(args.spans), "calls": rec["calls"],
              "window_s": rec["window_s"], "setup_s": rec["setup_s"],
              "setup": setup_seconds(setup_records),
              "records": len(setup_records) + len(window),
              "metrics": metrics, "span_metrics": summary["spans"],
              "checks": checks(att, metrics.get("unet_ms")),
              "attribution": summary_of(att)}
    print(table(att), file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"join {k} {v}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
