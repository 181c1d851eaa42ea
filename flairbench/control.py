"""The readings that the comparison's limits are set from, on the card:

    python3 -m flairbench.control --workload x8_window \
        --seeds 11,12,13 --control-seeds 11,12,13

For each seed, one process-local run of the cell's timed path (set-up,
warm-up, the window closed as soon as the recorded calls are in) and the
numbers of ``compare.readings``: the program against the reference
(the lower readings) and, for the control seeds, the control against the
reference (the upper readings). One JSON line a seed on standard output.
The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m flairbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    args = p.parse_args(argv)
    import torch
    from flairbench import compare, harness
    _, _, config, traffic = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("flairbench.control: needs a CUDA card", file=sys.stderr)
        return 2
    control = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        rec = harness.run_window(config, traffic, seed, 0.0, False, "cuda",
                                 time.perf_counter())
        line = {"seed": seed, "calls": rec["calls"],
                "window_s": rec["window_s"]}
        for kind, lower in (("program", False), ("control", True)):
            if lower and seed not in control:
                continue
            t0 = time.perf_counter()
            line[kind] = compare.readings(
                config, traffic, seed, rec["clip"], rec["buffers"],
                rec["plan"], "cuda", lower=lower)
            line[kind + "_s"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
