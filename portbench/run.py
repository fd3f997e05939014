"""Run one cell of ``BENCHMARK.json`` once on one NVIDIA GPU.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. With ``--trace 0`` the result line holds the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics (three
profiled spans inside the window). The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with the reference beside its limit, which also end
standard error). Exits non-zero, printing no result, without a CUDA device,
when a cell, configuration, mix, limit or the program is missing, or when a
module of ``jax`` or of the JAX package is loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "portbench-cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every kernel and build cache of the run stays inside the checkout, at
    # a fixed path, so that only a checkout's first run builds
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness
    from portbench.compare import load_limits
    from portbench.spec import load_cell

    cell = load_cell(ROOT, args.workload)
    limits = load_limits(ROOT, args.workload, cell.kind.NUMBERS)
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark runs only on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    # the score contractions run in full f32 (the program refuses TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.empty(1, device="cuda")  # the CUDA context, counted as set-up

    def log(line):
        print(line, file=sys.stderr, flush=True)

    result = harness.run(cell, limits, args.seed, args.seconds,
                         bool(args.trace), torch.device("cuda"), T_START,
                         log=log)
    loaded = harness.forbidden_modules()
    if loaded:
        log(f"modules of jax or the JAX package were loaded: {loaded}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
