"""Render the dry run's records (``launch.dryrun``) as markdown tables
(port of ``repro.roofline.report``): the dry-run matrix and the roofline
of each production mesh.

    PYTHONPATH=src python -m repro_torch.roofline.report [--jsonl PATH]

Memory is in GB (1e9 B) a GPU, against the H100's 80 GB of HBM3: the
total (args + output - alias + temp) and, beside it, the temp of the
traced step; "compile s" is the trace's seconds.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict


def load(path) -> Dict[tuple, dict]:
    """The LAST record per (arch, cell, mesh) of a JSON-lines file."""
    by_key = {}
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            by_key[(r["arch"], r["cell"], r["mesh"])] = r
    return by_key


def dryrun_table(by_key) -> str:
    lines = [
        "| arch | cell | mesh | status | mem/chip GB | temp GB | "
        "fits 80 GB HBM3 | compile s |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for (a, c, m), r in sorted(by_key.items()):
        if r["status"] == "skipped":
            lines.append(f"| {a} | {c} | {m} | SKIP: {r['reason'][:40]}… "
                         f"| – | – | – | – |")
            continue
        if r["status"] != "ok":
            lines.append(f"| {a} | {c} | {m} | {r['status']}: "
                         f"{r.get('error', '')[:40]} | – | – | – | – |")
            continue
        mem = r["memory"]
        lines.append(
            f"| {a} | {c} | {m} | ok | "
            f"{mem['total_per_chip_bytes'] / 1e9:.2f} | "
            f"{mem['temp_bytes'] / 1e9:.2f} | "
            f"{'yes' if mem['fits_hbm'] else 'no*'} | "
            f"{r['compile_s']:.2f} |")
    return "\n".join(lines)


def roofline_table(by_key, mesh="16x16") -> str:
    lines = [
        "| arch | cell | compute ms | memory ms | collective ms | "
        "bottleneck | useful FLOP frac | roofline frac |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for (a, c, m), r in sorted(by_key.items()):
        if m != mesh or r["status"] != "ok":
            continue
        rf = r["roofline"]
        lines.append(
            f"| {a} | {c} | {rf['compute_s'] * 1e3:.2f} | "
            f"{rf['memory_s'] * 1e3:.2f} | {rf['collective_s'] * 1e3:.2f} | "
            f"{rf['bottleneck']} | {rf['useful_flop_frac']:.2f} | "
            f"{rf['peak_fraction']:.3f} |")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--jsonl", default="experiments/dryrun.jsonl")
    args = ap.parse_args(argv)
    by_key = load(args.jsonl)
    print("## Dry-run matrix\n")
    print(dryrun_table(by_key))
    print("\n## Roofline (single-pod 16x16)\n")
    print(roofline_table(by_key, "16x16"))
    print("\n## Roofline (multi-pod 2x16x16)\n")
    print(roofline_table(by_key, "2x16x16"))


if __name__ == "__main__":
    main()
