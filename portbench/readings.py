"""Readings of the comparison's numbers, from which the limits are set.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 --seconds 5 [--out file.jsonl]

In one process on the card: for each of ``--seeds`` the program's run at
the cell's own size (set-up, a window of ``--seconds``, the comparison of a
sample of its analyses and of its neighborhoods), and for each of
``--control-seeds`` the control: the reference put in the program's place,
computed one precision step below the configuration's (bfloat16 distances,
TF32 contractions), judged by the same comparison. One JSON line each, with
every number (the kind's ``NUMBERS``); the lower reading of a number is the
largest over sound program runs, its upper reading the smallest over the
control's. The benchmark's own runs never run this.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def program_readings(cell, limits, seed, seconds, device):
    """The numbers of one run of the benchmark itself, window and all."""
    from portbench import harness

    lines = []
    result = harness.run(cell, limits, seed, seconds, False, device,
                         time.perf_counter(), log=lines.append)
    return ({k: c["value"] for k, c in result["checks"].items()},
            dict(analyses=result["attempted"], failed=result["failed"],
                 window=lines[-1]))


def control_readings(cell, seed, device):
    """The numbers of the control in the program's place."""
    from portbench import harness

    inputs = harness.make_inputs(cell, seed, device)
    control = cell.kind.Reference(inputs, device, lowered=True)
    j = cell.kind.Judge(inputs, device)
    j.judge_neighborhoods(control.neighborhoods())
    for k in range(min(harness.SAMPLE, len(inputs.pool))):
        j.judge_analysis(k, control.outputs(k))
    return j.readings, dict(rows_off=j.rows_off, checked=j.checked)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.compare import load_limits
    from portbench.spec import load_cell

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    cell = load_cell(ROOT, args.workload)
    limits = load_limits(ROOT, args.workload, cell.kind.NUMBERS)
    out = open(args.out, "a") if args.out else None
    jobs = ([("program", int(s)) for s in args.seeds.split(",") if s]
            + [("control", int(s)) for s in args.control_seeds.split(",")
               if s])
    for kind, seed in jobs:
        t0 = time.perf_counter()
        if kind == "program":
            readings, extra = program_readings(cell, limits, seed,
                                               args.seconds, device)
        else:
            readings, extra = control_readings(cell, seed, device)
        line = json.dumps(dict(
            workload=args.workload, kind=kind, seed=seed, readings=readings,
            seconds=round(time.perf_counter() - t0, 3), **extra))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
