"""The rank side of the mesh tests (``test_torch_mesh_*.py``): functions a
``torch_spawn.RankPool`` runs in every rank as ``fn(rank, world, ...)``.
They import torch and the port only -- never JAX -- and exchange numpy.
Rank 0 returns the whole results; the other ranks return what the check
needs of them (their local chunks) or None."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.convert import (adafactor_state_from_numpy,
                                 params_to_mesh, tree_from_numpy,
                                 tree_to_numpy)
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_process_mesh
from repro_torch.sharding.rules import set_mesh
from repro_torch.tree import tree_map

def _mesh(shape, axes=None):
    """A process mesh of ``shape`` over ("data", "model"), or ("pod",
    "data", "model") for three dims."""
    if axes is None:
        axes = ("pod", "data", "model")[-len(shape):]
    return make_process_mesh(tuple(shape), tuple(axes), device="cpu")


def _whole(tree, rank):
    """Every DTensor leaf gathered (all ranks); numpy on rank 0."""
    from torch.distributed.tensor import DTensor
    full = tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                    else t, tree)
    return tree_to_numpy(full) if rank == 0 else None


def layout(rank, world, shape, xshape, axes):
    """``constrain`` of an arange tensor: this rank's local chunk and
    ``named_sharding``'s spec."""
    from repro_torch.sharding.rules import constrain, named_sharding
    mesh = _mesh(shape)
    x = torch.arange(int(np.prod(xshape)), dtype=torch.float32).reshape(
        xshape)
    with set_mesh(mesh):
        y = constrain(x, *axes)
        ns = named_sharding(*axes)
    assert torch.equal(y.full_tensor(), x)
    return y.to_local().numpy(), tuple(ns.spec)


def with_capacity(cfg, capacity_factor):
    """An LM config whose MoE runs at ``capacity_factor`` (None: as it
    is)."""
    import dataclasses
    if capacity_factor is None or cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))


def frontend_model(prog, coeffs):
    """A recsys program's weightless model (config and the handed-over
    frontend coefficients ``coeffs``, (a1, a2) uint32 or None); None for
    another family."""
    from repro_torch.convert import recsys_params_from_jax
    if prog.family != "recsys":
        return None
    return recsys_params_from_jax({}, prog.config, *(coeffs or (None, None)),
                                  device="cpu")


def train_steps(rank, world, shape, arch, cell, starts, optimizer_n,
                microbatch, capacity_factor=None, coeffs=None):
    """One step of ``arch``'s ``cell`` at smoke size on a (shape) mesh from
    each handed-over (parameters, optimizer state, batch) in ``starts``:
    the loss, and rank 0's whole parameters and state after, for each.
    A recsys arch's frontend takes the coefficients ``coeffs``."""
    from repro_torch.launch.steps import _pick_optimizer, build_cell
    mesh = _mesh(shape)
    prog = build_cell(arch, cell, smoke=True, device="cpu")
    if optimizer_n is not None:
        prog.optimizer, prog.fused = _pick_optimizer(optimizer_n)
    prog.microbatch = microbatch
    if prog.family == "lm":
        prog.config = with_capacity(prog.config, capacity_factor)
    model = frontend_model(prog, coeffs)
    out = []
    for params_np, state_np, batch_np in starts:
        if prog.fused:
            state = adafactor_state_from_numpy(state_np, "cpu")
        else:
            state = tree_from_numpy(state_np, "cpu")
        with set_mesh(mesh):
            params = params_to_mesh(params_np, prog, mesh)
            state = steps.place_opt_state(prog, state, mesh)
            inputs = steps.place_inputs(prog, tree_from_numpy(batch_np, "cpu"))
            params, state, loss = prog.step(model, params, state, inputs)
            out.append((float(loss), _whole(params, rank), _whole(state, rank)))
    return out


def recsys_grads(rank, world, shape, arch, params_np, batch_np, coeffs,
                 changes=None):
    """``recsys_loss`` of a recsys arch's smoke ``train_batch`` cell (its
    config with ``changes``) on a (shape) mesh and its gradient in every
    parameter, from the handed-over weights and batch: (loss, rank 0's
    whole gradient tree, each table's placements)."""
    import dataclasses
    from repro_torch.launch.steps import _rewrap, build_cell
    from repro_torch.models import recsys
    from repro_torch.sharding import spmd
    from repro_torch.sharding.rules import entries_of
    from repro_torch.tree import tree_leaves, unflatten_like
    mesh = _mesh(shape)
    prog = build_cell(arch, "train_batch", smoke=True, device="cpu")
    prog.config = dataclasses.replace(prog.config, **(changes or {}))
    model = frontend_model(prog, coeffs)
    with set_mesh(mesh):
        params = params_to_mesh(params_np, prog, mesh)
        inputs = steps.place_inputs(prog, tree_from_numpy(batch_np, "cpu"))
        ents = tree_map(lambda t: entries_of(t.placements, mesh, t.dim()),
                        params)
        placements = {k: [str(p) for p in params[k].placements]
                      for k in recsys.TABLES if k in params}
        sh = spmd.Shards(mesh, rows=entries_of(
            inputs["labels"].placements, mesh, 1)[0])
        live = tree_map(lambda t: t.to_local().detach().requires_grad_(True),
                        params)
        loss = recsys.recsys_loss(model, {k: v.to_local() for k, v in
                                          inputs.items()}, live, sh, ents)
        grads = torch.autograd.grad(loss, tree_leaves(live))
        whole = _whole(_rewrap(params, unflatten_like(live, list(grads))),
                       rank)
    return float(loss), whole, placements


def recsys_scores(rank, world, shape, arch, cell, params_np, batch_np,
                  coeffs):
    """A recsys serving or retrieval ``cell``'s step on a (shape) mesh,
    the parameters as DTensors: its output gathered whole, and this rank's
    local rows of it."""
    from repro_torch.launch.steps import build_cell
    mesh = _mesh(shape)
    prog = build_cell(arch, cell, smoke=True, device="cpu")
    model = frontend_model(prog, coeffs)
    with set_mesh(mesh):
        params = params_to_mesh(params_np, prog, mesh)
        inputs = steps.place_inputs(prog, tree_from_numpy(batch_np, "cpu"))
        out = prog.step(model, params, inputs)
    return out.full_tensor().numpy(), out.to_local().numpy()


def moe_ep(rank, world, shape, cfg_kw, params_np, x_np):
    """``moe_ffn_ep`` on DTensors: its output and, from the loss
    sum(y ** 2), the gradients of the parameters and of x (whole)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.models.moe import MoEConfig, moe_ffn_ep
    from repro_torch.sharding.params import lm_param_specs
    from repro_torch.sharding.rules import constrain
    mesh = _mesh(shape)
    cfg = MoEConfig(**cfg_kw)
    params = tree_from_numpy(params_np, "cpu")
    with set_mesh(mesh):
        pd = steps.place_tree(params, lm_param_specs(params), mesh)
        pd = tree_map(lambda t: t.requires_grad_(True), pd)
        x = constrain(torch.from_numpy(x_np), "batch", None)
        x.requires_grad_(True)
        y = moe_ffn_ep(pd, x, cfg, mesh)
        (y ** 2).sum().full_tensor().backward()
        out = y.full_tensor().detach()
        grads = tree_map(lambda t: t.grad.full_tensor()
                         if isinstance(t.grad, DTensor) else t.grad, pd)
        gx = x.grad.full_tensor()
    if rank:
        return None
    return out.numpy(), tree_to_numpy(grads), gx.numpy()


def compressed(rank, world, g_full, draws):
    """``make_compressed_allreduce`` over a ("dp",) mesh of every rank:
    this rank's chunk of ``g_full`` in, its result out."""
    from repro_torch.optim.compression import make_compressed_allreduce
    mesh = _mesh((world,), ("dp",))
    n = g_full.shape[0] // world
    g = torch.from_numpy(g_full[rank * n:(rank + 1) * n])
    f = make_compressed_allreduce(mesh, "dp")
    return f(g, draws=torch.from_numpy(draws.copy())).numpy()


def reshard_checkpoint(rank, world, ckpt_dir, arch, params_np, state_np,
                       cell="train_4k"):
    """``arch``'s smoke parameters and optimizer state (of its ``cell``)
    placed on a (1, 4) mesh and saved; restored on a (2, 2) mesh through
    ``elastic.reshard_restore``.  Returns each rank's local chunks after
    the restore (and rank 0's whole restored tree)."""
    from repro_torch.launch.steps import build_cell
    from repro_torch.sharding.rules import NamedSharding
    from repro_torch.train import checkpoint, elastic
    from repro_torch.tree import map_with_path, path_leaves
    prog = build_cell(arch, cell, smoke=True, device="cpu")
    tree = {"params": tree_from_numpy(params_np, "cpu"),
            "opt_state": tree_from_numpy(state_np, "cpu")}
    wide = _mesh((1, world))
    with set_mesh(wide):
        placed = {"params": steps.place_params(prog, tree["params"], wide),
                  "opt_state": steps.place_opt_state(prog, tree["opt_state"],
                                                     wide)}
        checkpoint.save(ckpt_dir, 3, placed)
    square = _mesh((2, world // 2))
    specs = {"params": prog.param_specs, "opt_state": prog.opt_specs}
    spec_of = dict(path_leaves(specs))

    def shardings(template):
        return map_with_path(lambda path, _: NamedSharding(
            square, spec_of[path], greedy=True), template)

    with set_mesh(square):
        got, step = elastic.reshard_restore(ckpt_dir, tree, shardings)
        placements = {path: [str(p) for p in t.placements]
                      for path, t in path_leaves(got)}
        local = {path: t.to_local().numpy() for path, t in path_leaves(got)}
        whole = _whole(got, rank)
    return step, placements, local, whole


def placed(rank, world, shape, xshape, spec):
    """``NamedSharding(mesh, spec, greedy=True).place`` of an arange
    tensor: this rank's local chunk, and the whole tensor gathered back."""
    from repro_torch.sharding.rules import NamedSharding, PartitionSpec
    mesh = _mesh(shape)
    x = torch.arange(int(np.prod(xshape)), dtype=torch.float32).reshape(
        xshape)
    y = NamedSharding(mesh, PartitionSpec(*spec), greedy=True).place(x)
    assert torch.equal(y.full_tensor(), x)
    return y.to_local().numpy()



def traced_collectives(rank, world, shape, arch, cell):
    """One smoke step of ``arch``'s ``cell`` on a (shape) mesh of these
    ranks, placed as the launcher places it, under
    ``roofline.traced.StepTrace``: this rank's collectives by kind, with
    ``_counts``."""
    from repro_torch.launch.steps import (build_cell, init_inputs,
                                          init_opt_state)
    from repro_torch.roofline import traced
    mesh = _mesh(shape)
    prog = build_cell(arch, cell, smoke=True, device="cpu")
    gen = torch.Generator().manual_seed(0)
    model = prog.init_params(gen)
    batch = init_inputs(prog, gen)
    shell = model.without_weights() if prog.family == "recsys" else None
    with set_mesh(mesh):
        params = steps.place_params(prog, model.params(), mesh)
        inputs = steps.place_inputs(prog, batch)
        args = ((params, init_opt_state(prog, params), inputs)
                if prog.optimizer is not None else (params, inputs))
        _, counts = traced.trace_step(lambda *a: prog.step(shell, *a), args)
    return counts.breakdown()


def lm_serving(rank, world, shape, arch, cell, capacity_factor, params_np,
               inputs_np):
    """An LM ``cell``'s smoke step (prefill or decode, the MoE at
    ``capacity_factor``) on a (shape) mesh, the handed-over parameters as
    DTensors: rank 0's whole hidden states, or (next tokens, cache)."""
    from repro_torch.launch.steps import build_cell
    mesh = _mesh(shape)
    prog = build_cell(arch, cell, smoke=True, device="cpu")
    prog.config = with_capacity(prog.config, capacity_factor)
    with set_mesh(mesh):
        params = params_to_mesh(params_np, prog, mesh)
        inputs = steps.place_inputs(prog, tree_from_numpy(inputs_np, "cpu"))
        out = prog.step(None, params, inputs)
    if prog.kind == "lm_prefill":
        return _whole(out, rank)
    nxt, cache = out
    return _whole(nxt, rank), _whole(cache, rank)
