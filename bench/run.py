"""Run one cell of the benchmark on the card this process finds:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the numbers compared with their
limits as the last lines of standard error and one JSON object as the
last line of standard output; exits with an error, printing no result,
where there is no CUDA card or fewer than the cell asks for.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def environment() -> None:
    """Kernel and bytecode caches at fixed paths inside the checkout; no
    JAX through any library."""
    build = ROOT / "build"
    # Python's bytecode, cached like the kernels, also where the
    # environment turns the writing off: only a checkout's first run
    # compiles the modules it imports (PyTorch's alone take seconds)
    sys.pycache_prefix = str(build / "pycache")
    sys.dont_write_bytecode = False
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    environment()
    from bench import harness
    cell = harness.find_cell(args.workload)
    import torch
    torch.set_num_threads(1)        # the host only feeds the card
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this "
              f"machine has {have}", file=sys.stderr)
        return 2
    harness.execute(cell, seed=args.seed, seconds=args.seconds,
                    trace=bool(args.trace), device=torch.device("cuda", 0),
                    t_start=T_START)
    return 0


if __name__ == "__main__":
    sys.exit(main())
