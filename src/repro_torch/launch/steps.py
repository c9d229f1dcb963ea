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
    states (``transformer.forward``);
  * ``lm_decode``:        ``step(model, inputs) -> ((B,) next tokens,
    cache)``, one greedy ``serve_step`` that writes ``inputs["cache"]`` in
    place at ``inputs["pos"] - 1`` and returns it;
  * ``recsys_serve``:     ``step(model, inputs) -> (B,) scores``
  * ``recsys_retrieval``: ``step(model, inputs) -> (n_candidates,) logits``
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
reference's ranges.  The reference's sharding specs and shape-only avals
belong to the mesh path (``ROADMAP.md`` queue 1, "The multi-GPU mesh
path").
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
from repro_torch.tree import tree_leaves, tree_map

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
        if self.kind == "lm_prefill":
            (inputs,) = args
            with torch.inference_mode():
                return tfm.forward(model.params(), inputs["tokens"],
                                   self.config)
        if self.kind == "lm_decode":
            (inputs,) = args
            with torch.inference_mode():
                return tfm.serve_step(model.params(), inputs["cache"],
                                      inputs["tokens"], inputs["pos"],
                                      self.config)
        if self.kind == "recsys_serve":
            (inputs,) = args
            return recsys_lib.serve_scores(model, inputs)
        if self.kind == "recsys_retrieval":
            (inputs,) = args
            return recsys_lib.retrieval_scores(model, inputs,
                                               self.n_candidates)
        params, opt_state, inputs = args
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
