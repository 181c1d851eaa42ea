"""Run one cell of the benchmark once and print its result line.

    python3 -m flairbench.run --workload x8_window --seed 7 --seconds 35 \
        --trace 0

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for. ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics from a traced window, in which the
program's own spans are recorded and joined to the trace
(``flairbench.join``). Every run
compares what its window produced with the frozen reference and prints
each number compared beside its limit, last on standard error and under
``checks``, the last key of the result line on standard output.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m flairbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def power_limit() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "unknown"


def selected(entries, cell):
    return [m for m in entries if cell in m.get("workloads", [cell])]


def main(argv=None) -> int:
    args = parse(argv)
    import torch
    from flairbench import compare, harness, join
    bench, cell, config, traffic = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"flairbench: needs {cell['chips']} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if args.trace:
        # the traced window records the program's spans, joined to the
        # trace by launch for the span metrics
        rec = join.traced_window(config, traffic, args.seed, args.seconds,
                                 True, "cuda", T_START)
    else:
        rec = harness.run_window(config, traffic, args.seed, args.seconds,
                                 False, "cuda", T_START)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": rec["memory_peak_bytes"],
              "card": power_limit()}
    breakdown = None
    if args.trace:
        summary = harness.trace_summary(rec, config, traffic)
        names = [m["name"] for m in selected(bench["per_layer"], cell["name"])]
        metrics = harness.per_layer(summary, names)
        device.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        breakdown = summary["breakdown"]
        entries = bench["per_layer"]
    else:
        known = harness.end_to_end(rec, config, traffic)
        metrics = {m["name"]: known[m["name"]]
                   for m in selected(bench["end_to_end"], cell["name"])}
        entries = bench["end_to_end"]
    units = {m["name"]: m["unit"] for m in entries}
    t0 = time.perf_counter()
    vals = compare.readings(config, traffic, args.seed, rec["clip"],
                            rec["buffers"], rec["plan"], "cuda")
    compare_s = time.perf_counter() - t0
    found = harness.forbidden_modules()
    if found:
        print(f"flairbench: the process holds {found}", file=sys.stderr)
        return 3
    checks = compare.verdict(vals, config["limits"])
    failed = sum(c["value"] > c["limit"] for c in checks.values())
    result = {"correct": failed == 0, "attempted": len(checks),
              "failed": failed,
              "metrics": {k: {"value": v, "unit": units[k]}
                          for k, v in metrics.items()},
              "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["window"] = {"calls": rec["calls"], "seconds": rec["window_s"],
                        "compare_s": compare_s}
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']:.6g} limit {c['limit']:.6g}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
