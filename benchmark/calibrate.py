"""Readings of the comparison for setting a cell's limits, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--out chiprun_out/cal.jsonl]

For each seed: the cell's set-up work for that seed (the entry block or
the warm-up solve), one pass of its traffic through the same window as a
run, and the check of every point of the pass against the reference: the
program's readings.  For each control seed the same pass, with the
control (``reference/control.py``) in the program's place: the readings
the control gives.  One JSON line per pass; the benchmark's runs never
call this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    from benchmark import harness, traffic
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    c = harness.cell(args.workload, False)
    c = c._replace(mix={**c.mix, "check_per_pass": 1 << 30})
    prog = harness.Program(c, device)
    runs = [(int(s), False) for s in args.seeds.split(",") if s] + \
           [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in runs:
        plan = traffic.plan(c.mix, c.config, seed)
        entry = prog.warm(plan)
        keeper = harness.Keeper(0, None, None, torch.device("cpu"))
        records, wall, _ = harness.window(prog, plan, entry, 0.0, False,
                                          keeper)
        del entry
        checks = harness.check(c, records, device, control)
        line = {"workload": c.name, "seed": seed, "control": control,
                "wall_s": wall,
                "iterations": sum(r.iterations for r in records),
                "by_point": [r.iterations for r in records],
                **{k: v for k, (v, _) in checks.items()},
                "device": torch.cuda.get_device_name(device),
                "at": time.time()}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
