"""Training launcher (port of ``repro.launch.train``) for the recsys, LM
and GNN families.

    PYTHONPATH=src python -m repro_torch.launch.train
        --arch wide-deep|autoint|din|mind|gatedgcn|<an LM arch>
        [--cell CELL] [--smoke | --no-smoke] [--steps N] [--ckpt-dir DIR]
        [--ckpt-every N] [--seed S] [--device cuda|cpu]

Builds the arch's train cell (``--cell``, by default its first: a recsys
arch's ``train_batch``, 65,536 rows a step, an LM's ``train_4k``, 256 x
4,096 tokens, at ``--no-smoke``, GatedGCN's ``full_graph_sm``; its other
cells are ``minibatch_lg``, ``ogb_products`` and ``molecule``), draws its
weights from a generator seeded with ``--seed`` on the device, and runs
the cell's step (the optimizer ``launch.steps`` picks) through
``Trainer``: checkpoints every ``--ckpt-every`` steps into ``--ckpt-dir``, resume from
its latest checkpoint, heartbeat, bounded-retry restart.  Batch i is drawn
from a generator seeded with ``seed + 1 + i``, so a resumed run sees the
batches the unbroken one would; ``--steps`` is the run's total, resumed
steps included.  Prints the parameter count, the reference's
``optimizer=fused-adafactor`` (it prints that for every train cell), and
the first and last loss.  ``--mesh`` is refused: it is ``ROADMAP.md``'s
"The multi-GPU mesh path".
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import cells_for, get_arch, get_cell
from repro_torch.device import resolve_device
from repro_torch.launch.steps import build_cell, init_inputs
from repro_torch.train import TrainState, Trainer


def _train_cell_name(arch_id: str) -> str:
    for c in cells_for(arch_id):
        if "train" in c.kind:
            return c.name
    raise ValueError(f"{arch_id} has no train cell")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="a recsys arch (wide-deep, autoint, din, mind), "
                         "an LM arch or gatedgcn")
    ap.add_argument("--cell", default=None,
                    help="the train cell (default: the arch's first, "
                         "train_batch, train_4k or full_graph_sm)")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="shrink the arch for a fast smoke run "
                         "(--no-smoke trains the full-size config)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default="none",
                    choices=["none", "debug", "single-pod", "multi-pod"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu (the plain versions)")
    return ap


def main(argv=None) -> TrainState:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.mesh != "none":
        ap.error(f"--mesh {args.mesh} is not ported: ROADMAP.md queue 1, "
                 "\"The multi-GPU mesh path\"")
    try:
        get_arch(args.arch)
        cell = args.cell or _train_cell_name(args.arch)
        get_cell(args.arch, cell)
    except KeyError as e:
        ap.error(e.args[0])
    dev = resolve_device(args.device)
    prog = build_cell(args.arch, cell, smoke=args.smoke, device=dev)
    if "train" not in prog.kind:
        ap.error(f"cell {cell!r} of {args.arch} is {prog.kind}, not a train "
                 "cell")
    model = prog.init_params(torch.Generator(device=dev).manual_seed(args.seed))
    params = model.params()
    n = sum(p.numel() for p in model.parameters())
    print(f"{args.arch}/{cell}: {n:,} params, optimizer=fused-adafactor")

    def step(state, batch):
        p, o, loss = prog.step(model, state.params, state.opt_state, batch)
        return (TrainState(params=p, opt_state=o, step=state.step + 1),
                {"loss": loss})

    state = TrainState(params=params, opt_state=prog.optimizer.init(params),
                       step=torch.zeros((), dtype=torch.int32, device=dev))
    tr = Trainer(step, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    state = tr.maybe_resume(state)
    done = int(state.step)

    def batches():
        return (init_inputs(prog, torch.Generator(device=dev).manual_seed(
            args.seed + 1 + i)) for i in range(args.steps))

    state = tr.fit(state, batches, args.steps, start_step=done)
    losses = [m["loss"] for m in tr.metrics_log]
    if losses:
        print(f"loss: first={losses[0]:.4f} last={losses[-1]:.4f} "
              f"({len(losses)} steps from step {done}, "
              f"{tr.heartbeat.stragglers} stragglers)")
    return state


if __name__ == "__main__":
    main()
