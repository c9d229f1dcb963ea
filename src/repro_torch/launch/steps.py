"""Step programs per (architecture x shape cell) (port of
``repro.launch.steps``).

``build_cell(arch_id, cell_name, smoke, device)`` returns a ``CellProgram``
with the cell's config and input specs, ``init_params(generator)`` (the
model, on the generator's device) and ``step``, whose arguments follow the
cell's kind as the reference's do:

  * ``lm_train``:         ``step(model, params, opt_state, inputs) ->
    (params, opt_state, loss)``, ``transformer.train_loss`` differentiated
    on the reference's parameter tree, ``cfg.microbatch`` slices of the
    batch (1 with ``smoke``) accumulated, then the optimizer
    ``_pick_optimizer`` chose from the parameter count: AdamW (unfused),
    or in place of it above 50e9 parameters the fused Adafactor.  The
    step consumes ``params`` and ``opt_state``, as the reference's jitted
    step donates them: it writes the new parameters (and Adafactor's
    state) over them, so it holds no second copy;
  * ``lm_prefill``:       ``step(model, inputs) -> (B, S, D)`` final hidden
    states (``transformer.forward``), or ``step(model, params, inputs)``
    with the parameters given apart;
  * ``lm_decode``:        ``step(model, inputs) -> ((B,) next tokens,
    cache)``, one greedy ``serve_step`` that writes ``inputs["cache"]`` in
    place at ``inputs["pos"] - 1`` and returns it, or ``step(model,
    params, inputs)``;
  * ``recsys_serve``:     ``step(model, inputs) -> (B,) scores``, or
    ``step(model, params, inputs)`` with the parameters given apart;
  * ``recsys_retrieval``: ``step(model, inputs) -> (n_candidates,)
    logits``, or ``step(model, params, inputs)``;
  * ``recsys_train``:     ``step(model, params, opt_state, inputs) ->
    (params, opt_state, loss)``, the fused Adafactor step on the
    reference's parameter dict, new tensors out;
  * ``gnn_train_full``, ``gnn_train_sampled``, ``gnn_train_graphs``:
    ``step(model, params, opt_state, inputs) -> (params, opt_state,
    loss)``, ``gnn.gnn_loss`` differentiated on the reference's parameter
    tree, then AdamW (``_pick_optimizer`` for the GNN family), its update
    added to ``params`` in place.

For a train cell ``model`` gives the config (and a recsys model the
frontend's coefficients); its own parameters are not read.  The LM
serving steps run under ``torch.inference_mode``, the train steps with
autograd.  ``build_cell`` refuses a cell the arch skips.

``init_inputs(program, generator)`` draws a batch of inputs in the
reference's ranges.

The reference's ``PartitionSpec`` trees: ``param_specs`` / ``opt_specs``
(``sharding.params``, from the parameter and optimizer-state trees on the
meta device: nothing is allocated, the published configs included),
``input_specs_tree`` and ``arg_specs()``.  On a process mesh (inside
``set_mesh``), ``place_params`` / ``place_opt_state`` put whole trees
under them as DTensors (each rank keeping its chunk) and ``place_inputs``
a batch (``constrain`` to its input spec: each rank keeps its rows; a
microbatched LM batch laid out (m, B / m, S) first, so that microbatches
group the *global* batch as the reference reshapes it); a train step
given DTensor parameters then runs ``_mesh_step``: the same loss on the
local shards with explicit collectives (``transformer.train_loss`` /
``gnn.gnn_loss`` / ``recsys.recsys_loss`` given a ``sharding.spmd.Shards``),
the gradients left on the shards, the optimizer on the shards
(Adafactor's means summed across the axes that shard them).  A recsys
step there takes a model that carries the config and the frontend's
coefficients (``RecsysModel.without_weights()``); a recsys serving step
given DTensor parameters runs the same body (``_mesh_serve``) and returns
the scores as a DTensor of the rank's rows.  So does an LM serving step
(``_mesh_lm_serve``): prefill returns the rank's rows of hidden states,
decode the rank's next tokens, its cache (the length split over "model")
written in place at ``pos - 1`` on the rank that holds that position.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import (config_for_cell, get_arch, get_cell,
                                      input_specs, is_skipped)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import gnn as gnn_lib
from repro_torch.models import recsys as recsys_lib
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.optim.base import Optimizer
from repro_torch.optim.optimizers import adafactor_fused
from repro_torch.sharding import spmd
from repro_torch.sharding.params import opt_state_specs, param_specs_for
from repro_torch.sharding.rules import PartitionSpec as P
from repro_torch.tree import (map_with_path, path_leaves, tree_leaves,
                              tree_map, unflatten_like)

ADAFACTOR_THRESHOLD = 50e9        # parameters above this: Adafactor
MOMENTUM_FREE_THRESHOLD = 300e9   # and above this, without momentum


@dataclasses.dataclass
class CellProgram:
    arch_id: str
    cell_name: str
    kind: str
    family: str
    config: Any
    device: torch.device
    input_specs: Dict[str, Any]          # tensor inputs only
    n_candidates: Optional[int] = None   # recsys_retrieval
    optimizer: Optional[Optimizer] = None   # train kinds
    fused: bool = True                   # the optimizer applies its update
    microbatch: int = 1                  # gradient-accumulation slices

    def param_shapes(self):
        """The parameter tree on the meta device."""
        if self.family == "lm":
            return tfm.param_shapes(self.config)
        if self.family == "gnn":
            return gnn_lib.gnn_param_shapes(self.config)
        return recsys_lib.recsys_param_shapes(self.config)

    def opt_shapes(self):
        """The optimizer state on the meta device (None for inference)."""
        if self.optimizer is None:
            return None
        return self.optimizer.init(self.param_shapes())

    @property
    def param_specs(self):
        return param_specs_for(self.family, self.param_shapes())

    @property
    def opt_specs(self):
        if self.optimizer is None:
            return None
        shapes = self.param_shapes()
        return opt_state_specs(param_specs_for(self.family, shapes), shapes,
                               self.optimizer.init(shapes))

    @property
    def input_specs_tree(self) -> Dict[str, Any]:
        if self.family == "lm":
            return _lm_input_spec_tree(self.kind, self.input_specs)
        if self.family == "gnn":
            return _gnn_input_spec_tree(self.input_specs)
        return _recsys_input_spec_tree(self.input_specs)

    def arg_specs(self) -> Tuple:
        if self.optimizer is not None:
            return (self.param_specs, self.opt_specs, self.input_specs_tree)
        return (self.param_specs, self.input_specs_tree)

    def init_params(self, generator: torch.Generator):
        """Fresh weights from ``generator``, which must be on the
        program's device: a ``TransformerModel``, a ``RecsysModel`` or a
        ``GNNModel``."""
        if torch.device(generator.device).type != self.device.type:
            raise ValueError(f"generator on {generator.device}, program on "
                             f"{self.device}")
        if self.family == "lm":
            return tfm.init_params(self.config, generator)
        if self.family == "gnn":
            return _gnn_init(self.config, generator)
        return recsys_lib.init_recsys_params(self.config, generator)

    def step(self, model, *args):
        """The cell's step (see the module docstring for its arguments)."""
        if self.kind in ("lm_prefill", "lm_decode"):
            *params, inputs = args
            params = params[0] if params else model.params()
            if _is_dtensor(tree_leaves(params)[0]):
                return _mesh_lm_serve(self, params, inputs)
            with torch.inference_mode():
                if self.kind == "lm_prefill":
                    return tfm.forward(params, inputs["tokens"], self.config)
                return tfm.serve_step(params, inputs["cache"],
                                      inputs["tokens"], inputs["pos"],
                                      self.config)
        if self.kind in ("recsys_serve", "recsys_retrieval"):
            *params, inputs = args
            params = params[0] if params else None
            if params is not None and _is_dtensor(tree_leaves(params)[0]):
                return _mesh_serve(self, model, params, inputs)
            if self.kind == "recsys_serve":
                return recsys_lib.serve_scores(model, inputs, params)
            return recsys_lib.retrieval_scores(model, inputs,
                                               self.n_candidates, params)
        params, opt_state, inputs = args
        if _is_dtensor(tree_leaves(params)[0]):
            return _mesh_step(self, model, params, opt_state, inputs)
        if self.kind == "lm_train":
            loss = lambda p, batch: tfm.train_loss(p, batch, self.config)
            split = tfm.per_layer
        elif self.family == "gnn":
            loss = lambda p, batch: _gnn_loss(p, batch, self.config)
            split = None
        else:
            loss = lambda p, batch: recsys_lib.recsys_loss(model, batch, p)
            split = None
        return _make_train_step(loss, self.optimizer, self.microbatch,
                                self.fused, split)(params, opt_state, inputs)


def _pick_optimizer(n_params: int, steps: int = 10000, family: str = "lm"
                    ) -> Tuple[Optimizer, bool]:
    """(optimizer, fused), the reference's choice: a recsys cell's
    embedding tables dominate, so a factored second moment (O(V + d) state
    a table) in place of AdamW's two table-sized states; an LM or a GNN
    takes AdamW (weight decay 0.01) up to ``ADAFACTOR_THRESHOLD``
    parameters, Adafactor with bfloat16 momentum 0.9 above, and
    momentum-free Adafactor above ``MOMENTUM_FREE_THRESHOLD``.  A fused
    optimizer applies its own update; the LM's writes over the old
    parameters and state."""
    lr = warmup_cosine(3e-4, 200, steps)
    if family == "recsys":
        return adafactor_fused(lr, momentum=None), True
    if n_params > MOMENTUM_FREE_THRESHOLD:
        return adafactor_fused(lr, momentum=None, inplace=True), True
    if n_params > ADAFACTOR_THRESHOLD:
        return adafactor_fused(lr, momentum=0.9, inplace=True), True
    return adamw(lr, weight_decay=0.01), False


def _leaf(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``p`` (a tensor outside autograd) made a leaf of autograd whose
    gradient is added into ``g``."""
    p.requires_grad_(True)
    p.grad = g
    return p


def _make_train_step(loss_fn: Callable, optimizer: Optimizer,
                     microbatch: int = 1, fused: bool = True,
                     split: Optional[Callable] = None) -> Callable:
    """``step(params, opt_state, inputs) -> (params, opt_state, loss)``.
    The gradients go to a zero tree of the parameters' types: ``loss_fn``
    gets leaves sharing the parameters' storage (``split(params)``'s
    views, with ``split``) whose ``.grad`` are the matching parts of that
    tree, so each ``backward()`` adds into it in place.  With
    ``microbatch`` m > 1 the batch is split in m along axis 0, each slice's
    gradients added in, in the parameters' type, and the sum divided by m
    in place: the reference's scan (``a + g.astype(a.dtype)`` from zeros,
    then ``g / m``) without a second gradient tree.  The loss is the mean
    over the slices.  A fused optimizer applies its own update
    (``update(g, s, p) -> (new_params, new_state)``); another returns
    updates, added to the parameters in place."""
    m = max(microbatch, 1)
    views = split or (lambda tree: tree)

    def step(params, opt_state, inputs):
        grads = tree_map(torch.zeros_like, params)
        live = tree_map(_leaf, views(tree_map(torch.Tensor.detach, params)),
                        views(grads))
        loss = torch.zeros((), dtype=torch.float32,
                           device=tree_leaves(params)[0].device)
        for i in range(m):
            mb = inputs if m == 1 else {
                k: v.reshape(m, v.shape[0] // m, *v.shape[1:])[i]
                for k, v in inputs.items()}
            l_i = loss_fn(live, mb)
            l_i.backward()
            loss = loss + l_i.detach()
        del live
        with torch.no_grad():
            if m > 1:
                for g in tree_leaves(grads):
                    g.div_(m)
                loss = loss / m
            if fused:
                params, opt_state = optimizer.update(grads, opt_state,
                                                     params)
            else:
                updates, opt_state = optimizer.update(grads, opt_state,
                                                      params)
                del grads
                # apply_updates' (p + u) in p's type, written over p
                for p, u in zip(tree_leaves(params), tree_leaves(updates)):
                    p.add_(u)
        return params, opt_state, loss

    return step


# -- input sharding specs per kind ------------------------------------------

def _lm_input_spec_tree(kind: str, specs) -> Dict[str, Any]:
    if kind in ("lm_train", "lm_prefill"):
        return {k: P("batch", None) for k in specs}

    # decode: cache entries (L, B, len, ...) -- cache length over "model"
    # (decode sequence parallelism), batch over "batch"
    def cache_spec(leaf):
        if len(leaf.shape) == 5:        # (L, B, len, n_kv, hd)
            return P(None, "batch", "model", None, None)
        return P(None, "batch", "model", None)  # (L, B, len, lora/rope)

    def over(tree):            # the cache's dicts, down to its InputSpecs
        return ({k: over(v) for k, v in tree.items()}
                if isinstance(tree, dict) else cache_spec(tree))

    return {"cache": over(specs["cache"]), "tokens": P("batch"), "pos": P()}


def _gnn_input_spec_tree(specs) -> Dict[str, Any]:
    spec = {
        "node_feats": P("batch", None),
        "edge_index": P(None, ("batch", "model")),
        "edge_mask": P(("batch", "model")),
        "labels": P("batch"),
        "node_mask": P("batch"),
    }
    if "graph_ids" in specs:
        spec["graph_ids"] = P("batch")
    return spec


def _recsys_input_spec_tree(specs) -> Dict[str, Any]:
    out = {}
    for k, v in specs.items():
        rank = len(v.shape)
        out[k] = P("batch", *([None] * (rank - 1))) if rank else P()
    return out


# -- placement on a process mesh ---------------------------------------------

def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def place_tree(tree, specs, mesh):
    """Each whole leaf of ``tree`` (the same on every rank) as a DTensor
    under its spec in ``specs`` (a parameter spec: literal axes, dropped
    within a tuple where they do not divide)."""
    from repro_torch.sharding.rules import NamedSharding
    spec_of = dict(path_leaves(specs))
    return map_with_path(
        lambda path, t: NamedSharding(mesh, spec_of[path], greedy=True).place(
            t.detach()), tree)


def place_params(program: "CellProgram", params, mesh):
    """The parameter tree (whole) under ``param_specs``."""
    return place_tree(params, program.param_specs, mesh)


def place_opt_state(program: "CellProgram", state, mesh):
    """An optimizer state (whole) under ``opt_specs``."""
    return place_tree(state, program.opt_specs, mesh)


def init_opt_state(program: "CellProgram", params):
    """``optimizer.init`` of DTensor parameters, on their shards: the
    state's leaves as DTensors under ``opt_specs``."""
    from torch.distributed.tensor import DTensor
    from repro_torch.sharding.rules import NamedSharding, current_mesh
    mesh = current_mesh()
    local = program.optimizer.init(tree_map(lambda t: t.to_local(), params))
    shapes = dict(path_leaves(program.opt_shapes()))
    spec_of = dict(path_leaves(program.opt_specs))

    def wrap(path, t):
        full = shapes[path]
        shd = NamedSharding(mesh, spec_of[path], greedy=True)
        return DTensor.from_local(t, mesh.device_mesh,
                                  shd.placements(full.shape),
                                  run_check=False, shape=full.shape,
                                  stride=full.stride())

    return map_with_path(wrap, local)


def place_inputs(program: "CellProgram", batch: Dict[str, Any]):
    """A whole batch (the same on every rank) under ``input_specs_tree``
    on the current mesh: ``constrain`` to each input's spec, so each rank
    keeps its rows (its edges, for a graph's).  A microbatched LM step's
    inputs are laid out (m, B / m, S) first, the rows of each microbatch
    over "batch": the reference reshapes the *global* batch so, and each
    rank then holds its rows of every microbatch."""
    from repro_torch.sharding.rules import constrain
    specs = program.input_specs_tree
    m = program.microbatch
    if program.kind == "lm_train" and m > 1:
        return {k: constrain(v.reshape(m, v.shape[0] // m, *v.shape[1:]),
                             None, *specs[k]) for k, v in batch.items()}

    def place(v, spec):        # a decode cache is a tree of specs
        if isinstance(v, dict):
            return {k: place(v[k], spec[k]) for k in v}
        return constrain(v, *spec)

    return place(batch, specs)


def _rewrap(like, local):
    """``local``'s leaves as DTensors placed as ``like``'s."""
    from torch.distributed.tensor import DTensor
    return unflatten_like(like, [
        DTensor.from_local(t, d.device_mesh, d.placements, run_check=False,
                           shape=d.shape, stride=d.stride())
        for d, t in zip(tree_leaves(like), tree_leaves(local))])


def _axes_of(t, mesh, dim: int) -> Tuple[str, ...]:
    """The mesh axes a DTensor's ``dim`` is split over, first major."""
    from repro_torch.sharding.rules import entries_of
    return tuple(entries_of(t.placements, mesh, t.dim())[dim] or ())


def _process_mesh():
    from repro_torch.launch.mesh import ProcessMesh
    from repro_torch.sharding.rules import current_mesh
    mesh = current_mesh()
    if not isinstance(mesh, ProcessMesh):
        raise ValueError("DTensor parameters need their process mesh "
                         "current (set_mesh)")
    return mesh


def _ents(params, mesh):
    """Each DTensor leaf's per-dim axes."""
    from repro_torch.sharding.rules import entries_of
    return tree_map(lambda t: entries_of(t.placements, mesh, t.dim()),
                    params)


def _local(tree):
    return tree_map(lambda t: t.to_local() if _is_dtensor(t) else t, tree)


def _recsys_model(prog: "CellProgram", model):
    if model is None:
        raise ValueError(f"{prog.arch_id}: a recsys step on a mesh needs "
                         "the model's config and frontend coefficients "
                         "(RecsysModel.without_weights())")
    return model


def _mesh_serve(prog: "CellProgram", model, params, inputs):
    """A recsys serving or retrieval step on a process mesh: the body on
    the local shards, the scores a DTensor of the rank's rows (replicated
    for retrieval, whose one query every rank scores whole)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.sharding.rules import placements_for
    mesh = _process_mesh()
    model = _recsys_model(prog, model)
    first = next(iter(inputs.values()))
    rows = _axes_of(first, mesh, 0) if _is_dtensor(first) else ()
    sh = spmd.Shards(mesh, rows=rows)
    args = (_local(params), sh, _ents(params, mesh))
    batch = _local(inputs)
    if prog.kind == "recsys_serve":
        out = recsys_lib.serve_scores(model, batch, *args)
    else:
        out = recsys_lib.retrieval_scores(model, batch, prog.n_candidates,
                                          *args)
    return DTensor.from_local(out, mesh.device_mesh,
                              placements_for([rows], mesh), run_check=False)


def _mesh_lm_serve(prog: "CellProgram", params, inputs):
    """An LM prefill or decode step on a process mesh: the body on the
    local shards (``transformer.forward`` / ``serve_step`` given the
    shard context), the hidden states or next tokens a DTensor of the
    rank's rows; decode writes the cache's local chunks in place and
    returns the cache it was given."""
    from torch.distributed.tensor import DTensor
    from repro_torch.sharding.rules import placements_for
    mesh = _process_mesh()
    tokens = inputs["tokens"]
    rows = _axes_of(tokens, mesh, 0) if _is_dtensor(tokens) else ()
    sh = spmd.Shards(mesh, rows=rows)
    ents = _ents(params, mesh)
    local = _local(inputs)
    with torch.inference_mode():
        if prog.kind == "lm_prefill":
            out = tfm.forward(_local(params), local["tokens"], prog.config,
                              sh, ents)
            return DTensor.from_local(out, mesh.device_mesh,
                                      placements_for([rows], mesh),
                                      run_check=False)
        leaf = tree_leaves(inputs["cache"])[0]
        seq = _axes_of(leaf, mesh, 2) if _is_dtensor(leaf) else ()
        nxt, _ = tfm.serve_step(_local(params), local["cache"],
                                local["tokens"], local["pos"], prog.config,
                                sh, ents, seq)
    return (DTensor.from_local(nxt, mesh.device_mesh,
                               placements_for([rows], mesh),
                               run_check=False), inputs["cache"])


def _mesh_step(prog: "CellProgram", model, params, opt_state, inputs):
    """The train step on a process mesh (see the module docstring)."""
    from repro_torch.optim.base import Optimizer
    mesh = _process_mesh()
    ents = _ents(params, mesh)
    opt = prog.optimizer
    if prog.fused:
        opt = Optimizer(opt.init, lambda g, s, p: prog.optimizer.update(
            g, s, p, shards=(ents, mesh)))
    cfg = prog.config
    if prog.kind == "lm_train":
        tokens = inputs["tokens"]
        if prog.microbatch > 1 and tokens.dim() != 3:
            raise ValueError("a microbatched step on a mesh takes its batch "
                             "as place_inputs lays it out, (m, B / m, S)")
        # each rank's rows of microbatch 0, 1, ... in turn
        sh = spmd.Shards(mesh, rows=_axes_of(tokens, mesh, -2))
        batch = {k: v.to_local().flatten(0, -2) for k, v in inputs.items()}
        loss = lambda p, b: tfm.train_loss(p, b, cfg, sh, ents)
        split = tfm.per_layer
    elif prog.family == "gnn":
        sh = spmd.Shards(mesh, rows=_axes_of(inputs["node_feats"], mesh, 0),
                         edges=_axes_of(inputs["edge_mask"], mesh, 0))
        batch = {k: (spmd.gather(v.to_local(), 0, mesh, _axes_of(v, mesh, 0))
                     if k == "labels" and cfg.readout == "graph"
                     else v.to_local()) for k, v in inputs.items()}
        loss = lambda p, b: gnn_lib.gnn_loss(p, b, cfg, sh, ents)
        split = None
    else:
        model = _recsys_model(prog, model)
        sh = spmd.Shards(mesh, rows=_axes_of(inputs["labels"], mesh, 0))
        batch = {k: v.to_local() for k, v in inputs.items()}
        loss = lambda p, b: recsys_lib.recsys_loss(model, b, p, sh, ents)
        split = None
    p_loc, s_loc, loss_v = _make_train_step(
        loss, opt, prog.microbatch, prog.fused, split)(
            _local(params), _local(opt_state), batch)
    return _rewrap(params, p_loc), _rewrap(opt_state, s_loc), loss_v


def build_cell(arch_id: str, cell_name: str, smoke: bool = False,
               device: DeviceLike = None) -> CellProgram:
    cell = get_cell(arch_id, cell_name)
    reason = is_skipped(arch_id, cell_name)
    if reason:
        raise ValueError(f"{arch_id} skips {cell_name}: {reason}")
    specs = input_specs(arch_id, cell_name, smoke)
    cfg = config_for_cell(arch_id, cell, smoke)
    prog = CellProgram(arch_id=arch_id, cell_name=cell_name, kind=cell.kind,
                       family=get_arch(arch_id).family, config=cfg,
                       device=resolve_device(device), input_specs=specs,
                       n_candidates=specs.pop("n_candidates", None))
    if cell.kind == "recsys_train":
        prog.optimizer, prog.fused = _pick_optimizer(0, family="recsys")
    elif cell.kind == "lm_train":
        prog.optimizer, prog.fused = _pick_optimizer(tfm.count_params(cfg))
        prog.microbatch = 1 if smoke else cfg.microbatch
    elif prog.family == "gnn":
        prog.optimizer, prog.fused = _pick_optimizer(
            sum(t.numel() for t in tree_leaves(gnn_lib.gnn_param_shapes(cfg))),
            family="gnn")
    return prog


def _gnn_init(cfg, generator: torch.Generator):
    return gnn_lib.init_gnn_params(cfg, generator)


def _gnn_loss(params, inputs, cfg):
    return gnn_lib.gnn_loss(params, inputs, cfg)


def init_inputs(program: CellProgram,
                generator: torch.Generator) -> Dict[str, Any]:
    """One batch of random inputs, drawn on the generator's device in the
    reference's ranges: LM ``tokens`` (and a train cell's ``labels``) in
    [0, vocab), a zero ``cache`` and ``pos`` 2 (int32); recsys ``field_ids`` in [0, vocab), ``hist_ids``
    and ``target_id`` in [0, item_vocab), ``set_ids`` in [0, 2^s),
    ``set_counts`` in [1, set_nnz), ``hist_mask`` ones and ``labels``
    Bernoulli(0.5) in float32; GNN ``node_feats`` standard normal,
    ``edge_index`` in [0, nodes) (a molecule batch's edges may join two of
    its graphs, as the reference's do), ``edge_mask`` and ``node_mask``
    ones, ``labels`` in [0, n_classes) and ``graph_ids`` the
    block-diagonal repeat (graph g owns nodes [g * per, (g + 1) * per))."""
    cfg = program.config
    dev = generator.device
    if program.family == "gnn":
        return _gnn_inputs(program, generator)
    if program.family == "lm":
        tok = program.input_specs["tokens"]
        out = {name: torch.randint(0, cfg.vocab, tok.shape, dtype=tok.dtype,
                                   generator=generator, device=dev)
               for name in ("tokens", "labels")
               if name in program.input_specs}
        if program.kind == "lm_decode":
            layer0 = next(iter(program.input_specs["cache"]["layers"].values()))
            _, B, L = layer0.shape[:3]            # (n, B, L, ...)
            out["cache"] = tfm.init_cache(cfg, B, L, device=dev)
            out["pos"] = torch.tensor(2, dtype=torch.int32, device=dev)
        return out
    ranges = {"field_ids": (0, cfg.vocab), "hist_ids": (0, cfg.item_vocab),
              "target_id": (0, cfg.item_vocab),
              "set_ids": (0, 1 << cfg.minhash_s),
              "set_counts": (1, cfg.set_nnz)}
    out = {}
    for name, spec in program.input_specs.items():
        if name == "hist_mask":
            out[name] = torch.ones(spec.shape, dtype=spec.dtype, device=dev)
        elif name == "labels":
            out[name] = torch.bernoulli(
                torch.full(spec.shape, 0.5, dtype=spec.dtype, device=dev),
                generator=generator)
        else:
            out[name] = torch.randint(*ranges[name], spec.shape,
                                      dtype=spec.dtype, generator=generator,
                                      device=dev)
    return out


def _gnn_inputs(program: CellProgram,
                generator: torch.Generator) -> Dict[str, Any]:
    specs, dev = program.input_specs, generator.device
    n_nodes = specs["node_feats"].shape[0]
    out = {}
    for name, spec in specs.items():
        if name == "node_feats":
            out[name] = torch.randn(spec.shape, generator=generator,
                                    device=dev)
        elif name in ("edge_mask", "node_mask"):
            out[name] = torch.ones(spec.shape, dtype=spec.dtype, device=dev)
        elif name in ("edge_index", "labels"):
            hi = n_nodes if name == "edge_index" else program.config.n_classes
            out[name] = torch.randint(0, hi, spec.shape, dtype=spec.dtype,
                                      generator=generator, device=dev)
    if "graph_ids" in specs:
        n_graphs = specs["labels"].shape[0]
        out["graph_ids"] = torch.arange(
            n_graphs, dtype=torch.int32, device=dev).repeat_interleave(
                n_nodes // n_graphs)
    return out
