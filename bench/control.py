"""Run a cell's control: the plain reference in the program's place, in
the precision just below the one the configuration states (the
preprocessing cells' codes one bit narrower than b), through the rest
of a run.

    python3 bench/control.py --workload <cell> --seconds <s> --seed <n> [--seed <n> ...]

Each seed prints the run's result line; the command exits 0 only when
every control came out not correct, which is what the benchmark's
comparison has to show.  Needs the card, as ``run.py`` does.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)
    run.environment()
    from bench import harness
    import torch
    if not torch.cuda.is_available():
        print("the control runs on a CUDA card; none found", file=sys.stderr)
        return 2
    caught = 0
    for seed in args.seed:
        result = harness.execute(harness.find_cell(args.workload), seed=seed,
                                 seconds=args.seconds, trace=False,
                                 device=torch.device("cuda", 0),
                                 t_start=time.perf_counter(), control=True)
        caught += not result["correct"]
    print(f"control caught on {caught} of {len(args.seed)} seeds",
          file=sys.stderr)
    return 0 if caught == len(args.seed) else 1


if __name__ == "__main__":
    sys.exit(main())
