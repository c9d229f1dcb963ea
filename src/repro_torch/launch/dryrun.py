"""Multi-pod dry run (port of ``repro.launch.dryrun``): every (arch x cell
x mesh) cell placed under the production shardings, and its step traced
on one rank of the production world.

For each cell this builds the cell's program (``build_cell`` given
``device="cpu"``, where nothing is put), takes its parameter,
optimizer-state and input trees on the meta device, and places every leaf
under its spec (``param_specs``, ``opt_specs``, ``input_specs_tree``) on
a shape-only mesh (``launch.mesh.abstract_mesh``): 16x16 over ("data",
"model"), or 2x16x16 over ("pod", "data", "model").  Then it runs the
cell's real step (``CellProgram.step``) as rank 0 of a fake world of 256
or 512 ranks (``launch.mesh.fake_world``: torch's ``"fake"`` process-group
backend), on meta tensors of that rank's shards placed as the launcher
places them (``step_args``), under ``roofline.traced.StepTrace``: the
reference's ``lowered.compile()`` and the compiled program's memory and
cost analyses.  Nothing is allocated and no device is touched, so it
runs on any machine, a card or not, as the reference compiles over forced
host devices.  The fake group is this process's, destroyed after each
cell; a process that has a group of its own traces in a child process
(``trace_cell``), so the caller's group stays as it was.

Placement is the reference dry run's rule (``placement``), not the
launcher's: "batch", and a bare "data", mean every data axis the mesh has
(("pod", "data") on 2x16x16; "data" inside a tuple stays literal), "all"
means every axis, axes the mesh lacks are dropped, and then axes are
popped from the right until their product divides the dim.  The launcher
(``sharding.rules.NamedSharding(..., greedy=True)``) reads "data"
literally and skips an axis that does not divide while it tries the rest;
on 2x16x16 the two differ (deepseek-7b's parameters: 102,858,752 B a GPU
here, 152,788,992 B by the launcher's rule).  A GPU holds ``shape[d] //
extent`` of each dim.  ``args_bytes`` follows the reference's rule; the
traced step takes its arguments as the launcher places them.

Each record's ``memory``, in bytes per GPU:
  * ``args_bytes``: parameters + optimizer state + inputs
    (``args_breakdown`` gives each, ``args_leaves`` their leaf count);
  * ``output_bytes`` / ``alias_bytes``: the step's outputs, and those that
    reuse a donated argument's buffer, as the reference donates.  A train
    step donates its parameters and optimizer state: the new ones alias
    them, and the loss is one replicated float32.  ``lm_decode`` donates
    its inputs: the cache written in place is aliased, the next tokens
    ((B,) int32) are new.  Serving outputs are sharded on their batch dim
    over the data axes: ``lm_prefill``'s (B, S, d) hidden states in the
    parameters' type, ``recsys_serve``'s (B,) float32 scores; a
    ``recsys_retrieval`` query's (n_candidates,) float32 logits are
    replicated, as every rank scores the one query whole;
  * ``temp_bytes``: the traced step's peak of live bytes less its traced
    arguments + outputs - aliased outputs (``TraceCounts.temp_bytes``):
    XLA's temp size;
  * ``total_per_chip_bytes``: args + output - alias + temp, and
    ``fits_hbm``: that total <= ``hardware.HBM_BYTES``.

``cost`` and ``roofline`` come from ``roofline.analysis.analyze``: each
count the larger of the traced one and ``roofline.analytic``'s estimate,
as the reference takes the larger of XLA's and its estimate, with the
traced collectives by kind in ``collective_breakdown``
(``parsed_hlo_once_per_loop``, the reference's key) and the traced totals
(``raw_hlo``); H100 constants.  ``lower_s`` is the time to build and
place the trees on the meta device; ``compile_s`` the trace's.
``trace`` holds what the trace counted (its arguments, outputs, aliases,
peak and operations).  ``place_cell`` gives the placed bytes alone.

Usage:
    python -m repro_torch.launch.dryrun --arch deepseek-7b --cell train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
        [--smoke] [--out FILE]

One JSON record per cell and mesh is appended to ``--out``
(``experiments/dryrun.jsonl``), read by ``roofline.report``; an ``OK``,
``SKIP`` or ``FAIL`` line is printed for each.  The cells are traced in
a process each, as many at once as the host has cores.  A cell that raises is
recorded as ``"status": "error"``, and the command then exits 1.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import all_archs, cells_for, get_arch, is_skipped
from repro_torch.launch.mesh import abstract_mesh, production_shape
from repro_torch.launch.steps import build_cell
from repro_torch.roofline import hardware as hw
from repro_torch.roofline import traced
from repro_torch.roofline.analysis import analyze
from repro_torch.sharding.rules import PartitionSpec as P
from repro_torch.tree import path_leaves, tree_map


def production_mesh(multi_pod: bool = False):
    """The production mesh's shape, as an ``abstract_mesh``."""
    return abstract_mesh(*production_shape(multi_pod))


def mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh.shape.values())


def placement(mesh, spec, shape) -> Tuple:
    """Each dim's mesh axes under ``spec`` by the reference dry run's rule
    (see the module docstring): None, an axis name, or a tuple of them,
    first major."""
    parts = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    out = []
    for dim, ax in zip(shape, parts):
        if ax is None:
            out.append(None)
            continue
        literal_tuple = not isinstance(ax, str)
        resolved = []
        for nm in ((ax,) if isinstance(ax, str) else tuple(ax)):
            if nm == "batch" or (nm == "data" and not literal_tuple):
                resolved.extend(n for n in ("pod", "data")
                                if n in mesh.axis_names)
            elif nm == "all":
                resolved.extend(mesh.axis_names)
            elif nm in mesh.axis_names:
                resolved.append(nm)
        resolved = list(dict.fromkeys(resolved))
        while resolved and dim % math.prod(
                mesh.shape[n] for n in resolved) != 0:
            resolved.pop()
        out.append(None if not resolved else
                   resolved[0] if len(resolved) == 1 else tuple(resolved))
    return tuple(out)


def local_shape(mesh, spec, shape) -> Tuple[int, ...]:
    """The shape of one GPU's part of a ``shape`` tensor under ``spec``."""
    out = []
    for dim, axes in zip(shape, placement(mesh, spec, shape)):
        names = () if axes is None else (
            (axes,) if isinstance(axes, str) else axes)
        out.append(dim // math.prod(mesh.shape[n] for n in names))
    return tuple(out)


def placed_bytes(mesh, specs, tensors) -> Tuple[int, int]:
    """(bytes a GPU holds, leaves) of a tree of meta tensors under a tree
    of specs of the same paths."""
    spec_of = dict(path_leaves(specs))
    total = n = 0
    for path, t in path_leaves(tensors):
        total += math.prod(local_shape(mesh, spec_of[path], t.shape)) \
            * t.element_size()
        n += 1
    return total, n


def _meta(specs):
    """A tree of ``InputSpec``s (in dicts) as meta tensors."""
    if isinstance(specs, dict):
        return {k: _meta(v) for k, v in specs.items()}
    return torch.empty(specs.shape, dtype=specs.dtype, device="meta")


def _outputs(program, mesh, args: Dict[str, int]) -> Tuple[int, int]:
    """(output_bytes, alias_bytes) a GPU holds (see the module
    docstring)."""
    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
    av, cfg = program.input_specs, program.config
    if program.optimizer is not None:
        donated = args["params"] + args["opt_state"]
        return donated + 4, donated
    if program.kind == "lm_decode":
        B = av["tokens"].shape[0]
        cache, _ = placed_bytes(mesh, program.input_specs_tree["cache"],
                                _meta(av["cache"]))
        toks, _ = placed_bytes(mesh, P("batch"), meta((B,), torch.int32))
        return toks + cache, cache
    if program.kind == "lm_prefill":
        B, S = av["tokens"].shape
        out = meta((B, S, cfg.d_model), cfg.param_dtype)
        return placed_bytes(mesh, P("batch"), out)[0], 0
    if program.kind == "recsys_retrieval":
        return program.n_candidates * 4, 0
    B = av.get("field_ids", av.get("hist_ids")).shape[0]
    return placed_bytes(mesh, P("batch"), meta((B,), torch.float32))[0], 0


# -- the traced step ----------------------------------------------------------

def _owned(tree):
    """Each tensor of ``tree`` on a storage of its own: a placed chunk may
    be a view of the whole meta tensor it was cut from."""
    from torch.distributed.tensor import DTensor

    def own(t):
        if isinstance(t, DTensor):
            return DTensor.from_local(t.to_local().clone(), t.device_mesh,
                                      t.placements, run_check=False,
                                      shape=t.shape, stride=t.stride())
        return t.clone()

    return tree_map(own, tree)


def _traced_model(program):
    """The step's ``model`` argument: a recsys step's config and frontend
    coefficients (meta), nothing for the other families."""
    if program.family != "recsys":
        return None
    from repro_torch.models.recsys import RecsysModel
    cfg = program.config
    coeffs = (None, None)
    if cfg.use_minhash_frontend:
        coeffs = tuple(torch.empty(cfg.minhash_k, dtype=torch.int32,
                                   device="meta") for _ in range(2))
    return RecsysModel(cfg, {}, *coeffs)


def step_args(program, mesh) -> Tuple[Any, Tuple]:
    """(model, arguments) of ``program``'s step on ``mesh`` (a process
    mesh, current under ``set_mesh``), meta tensors placed as the launcher
    places them: ``place_params`` / ``init_opt_state`` / ``place_inputs``
    (the launcher's rule, not ``placement``)."""
    from repro_torch.launch.steps import (init_opt_state, place_inputs,
                                          place_params)
    params = _owned(place_params(program, program.param_shapes(), mesh))
    inputs = _owned(place_inputs(program, _meta(program.input_specs)))
    model = _traced_model(program)
    if program.optimizer is not None:
        return model, (params, init_opt_state(program, params), inputs)
    return model, (params, inputs)


def trace_counts(program, mesh) -> traced.TraceCounts:
    """The traced counts of one step of ``program`` on ``mesh`` (a process
    mesh of a fake world, current under ``set_mesh``), with the trace's
    seconds (arguments placed included)."""
    t0 = time.perf_counter()
    model, args = step_args(program, mesh)
    buffers = list(model.buffers()) if model is not None else []
    _, counts = traced.trace_step(lambda *a: program.step(model, *a), args,
                                  buffers)
    counts.seconds = time.perf_counter() - t0
    return counts


def _trace_here(arch_id, cell_name, smoke, shape, axes):
    from repro_torch.launch.mesh import fake_world
    from repro_torch.sharding.rules import set_mesh
    program = build_cell(arch_id, cell_name, smoke=smoke, device="cpu")
    with fake_world(shape, axes) as pm, set_mesh(pm):
        return trace_counts(program, pm)


def trace_cell(arch_id: str, cell_name: str, mesh,
               smoke: bool = False) -> traced.TraceCounts:
    """``trace_counts`` of one cell on rank 0 of a fake world of
    ``mesh``'s shape.  The process group is this process's (created and
    destroyed here) when it has none; otherwise the trace runs in a child
    process, so the caller's group is left as it was."""
    args = (arch_id, cell_name, smoke, tuple(mesh.shape.values()),
            tuple(mesh.axis_names))
    if not torch.distributed.is_initialized():
        return _trace_here(*args)
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    with ProcessPoolExecutor(1, mp_context=mp.get_context("spawn")) as pool:
        return pool.submit(_trace_here, *args).result()


def place_cell(program, mesh) -> Dict[str, Any]:
    """The bytes a GPU of ``mesh`` (any shape-only mesh) holds of
    ``program``'s arguments by the reference's rule: ``args`` by group
    (``params``, ``opt_state``, ``inputs``), ``leaves``, and the step's
    ``output`` and ``alias`` bytes."""
    groups = {"params": (program.param_specs, program.param_shapes()),
              "inputs": (program.input_specs_tree,
                         _meta(program.input_specs))}
    if program.optimizer is not None:
        groups["opt_state"] = (program.opt_specs, program.opt_shapes())
    placed = {name: placed_bytes(mesh, specs, tree)
              for name, (specs, tree) in groups.items()}
    args = {name: b for name, (b, _) in placed.items()}
    out_bytes, alias_bytes = _outputs(program, mesh, args)
    return {"args": args, "leaves": sum(n for _, n in placed.values()),
            "output": out_bytes, "alias": alias_bytes}


def run_cell(arch_id: str, cell_name: str, multi_pod: bool = False,
             smoke: bool = False, mesh=None) -> Dict[str, Any]:
    """Place one cell on the production mesh (or on ``mesh``, any
    shape-only mesh) and trace its step there (rank 0 of a fake world);
    returns its record."""
    mesh = mesh if mesh is not None else production_mesh(multi_pod)
    t0 = time.perf_counter()
    program = build_cell(arch_id, cell_name, smoke=smoke, device="cpu")
    placed = place_cell(program, mesh)
    args, out_bytes, alias_bytes = (placed["args"], placed["output"],
                                    placed["alias"])
    t_lower = time.perf_counter() - t0

    counts = trace_cell(arch_id, cell_name, mesh, smoke=smoke)
    temp = counts.temp_bytes
    args_bytes = sum(args.values())
    total = args_bytes + out_bytes - alias_bytes + temp
    roof = analyze(program, mesh, smoke=smoke, memory_bytes=total,
                   traced=counts)
    rec = {
        "arch": arch_id, "cell": cell_name, "mesh": mesh_name(mesh),
        "chips": mesh.size, "status": "ok",
        "lower_s": round(t_lower, 3),
        "compile_s": round(counts.seconds, 3),
        "memory": {
            "args_bytes": args_bytes,
            "temp_bytes": temp,
            "output_bytes": out_bytes,
            "alias_bytes": alias_bytes,
            "total_per_chip_bytes": total,
            "fits_hbm": bool(total <= hw.HBM_BYTES),
            "args_breakdown": args,
            "args_leaves": placed["leaves"],
        },
        "cost": {
            "hlo_flops_per_chip": roof.hlo_flops_per_chip,
            "hlo_bytes_per_chip": roof.hlo_bytes_per_chip,
            "collective_bytes_per_chip": roof.coll_bytes_per_chip,
            "collective_breakdown": roof.coll_breakdown,
        },
        "roofline": {
            "compute_s": roof.compute_s, "memory_s": roof.memory_s,
            "collective_s": roof.collective_s,
            "bottleneck": roof.bottleneck,
            "model_flops": roof.model_flops,
            "useful_flop_frac": roof.useful_flop_frac,
            "peak_fraction": roof.peak_fraction,
            "link": roof.link, "link_bw": roof.link_bw,
        },
        "trace": {"ops": counts.ops, "args_bytes": counts.args_bytes,
                  "output_bytes": counts.output_bytes,
                  "alias_bytes": counts.alias_bytes,
                  "peak_bytes": counts.peak_bytes},
    }
    return rec


def _record_of(arch_id: str, cell_name: str, multi_pod: bool,
               smoke: bool) -> Tuple[Dict[str, Any], str, str]:
    """One cell's record on one production mesh, with the line ``run_all``
    prints for it and the traceback of a cell that raised."""
    mesh = production_mesh(multi_pod)
    tag = f"{arch_id}/{cell_name}/{mesh_name(mesh)}"
    head = {"arch": arch_id, "cell": cell_name, "mesh": mesh_name(mesh)}
    reason = is_skipped(arch_id, cell_name)
    if reason:
        return ({**head, "status": "skipped", "reason": reason},
                f"SKIP {tag}: {reason}", "")
    try:
        rec = run_cell(arch_id, cell_name, smoke=smoke, mesh=mesh)
    except Exception as e:
        return ({**head, "status": "error",
                 "error": f"{type(e).__name__}: {e}"},
                f"FAIL {tag}: {type(e).__name__}: {e}",
                traceback.format_exc(limit=5))
    r, m = rec["roofline"], rec["memory"]
    return rec, (f"OK   {tag}: mem/chip="
                 f"{m['total_per_chip_bytes'] / 1e9:.2f}GB "
                 f"fits={m['fits_hbm']} bottleneck={r['bottleneck']} "
                 f"peak_frac={r['peak_fraction']:.3f} "
                 f"(placed in {rec['lower_s']:.2f}s, traced in "
                 f"{rec['compile_s']:.2f}s)"), ""


def run_all(cells, meshes, smoke: bool = False, out=None):
    """Yield the record of every (arch, cell) on every mesh (``True``:
    2x16x16), printing its line; a skipped cell's record says why, and a
    cell that raises is recorded as an error, not dropped.  ``out``, an
    open file, gets each record as a JSON line.  The cells are traced as
    many at once as the host has cores, each in a process of its own
    (spawned), the deepest archs first, whose traces take longest; the
    records come in the given order.  A lone cell is traced here."""
    work = [(a, c, mp, smoke) for a, c in cells for mp in meshes]
    jobs = min(os.cpu_count() or 1, len(work))
    if jobs > 1:                 # a worker that dies raises, not hangs
        import multiprocessing as mp_lib
        from concurrent.futures import ProcessPoolExecutor
        pool = ProcessPoolExecutor(jobs,
                                   mp_context=mp_lib.get_context("spawn"))
        depth = lambda w: getattr(get_arch(w[0]).config, "n_layers", 0)
        futures = {i: pool.submit(_record_of, *work[i]) for i in sorted(
            range(len(work)), key=lambda i: -depth(work[i]))}
        results = (futures[i].result() for i in range(len(work)))
    else:
        pool, results = None, (_record_of(*w) for w in work)
    try:
        for rec, line, trace_text in results:
            print(line, flush=True)
            if trace_text:
                print(trace_text, end="", file=sys.stderr)
            if out is not None:
                out.write(json.dumps(rec) + "\n")
                out.flush()
            yield rec
    finally:
        if pool is not None:
            pool.shutdown(cancel_futures=True)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--cell", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced configs (debug only)")
    ap.add_argument("--out", default="experiments/dryrun.jsonl")
    args = ap.parse_args(argv)

    archs = sorted(all_archs()) if (args.all or not args.arch) \
        else [args.arch]
    cells = [(a, c.name) for a in archs for c in cells_for(a)
             if not args.cell or c.name == args.cell]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "a") as f:
        recs = list(run_all(cells, meshes, smoke=args.smoke, out=f))
    return 1 if any(r["status"] == "error" for r in recs) else 0


if __name__ == "__main__":
    sys.exit(main())
