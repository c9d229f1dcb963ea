"""Step programs per (architecture x shape cell) (port of the recsys and
LM serving parts of ``repro.launch.steps``).

``build_cell(arch_id, cell_name, smoke, device)`` returns a ``CellProgram``
with the cell's config and input specs, ``init_params(generator)`` (the
model, on the generator's device) and ``step``, whose arguments follow the
cell's kind as the reference's do:

  * ``lm_prefill``:       ``step(model, inputs) -> (B, S, D)`` final hidden
    states (``transformer.forward``);
  * ``lm_decode``:        ``step(model, inputs) -> ((B,) next tokens,
    cache)``, one greedy ``serve_step`` that writes ``inputs["cache"]`` in
    place at ``inputs["pos"] - 1`` and returns it;
  * ``recsys_serve``:     ``step(model, inputs) -> (B,) scores``
  * ``recsys_retrieval``: ``step(model, inputs) -> (n_candidates,) logits``
  * ``recsys_train``:     ``step(model, params, opt_state, inputs) ->
    (params, opt_state, loss)``, the fused Adafactor step on the
    reference's parameter dict; ``model`` gives the config and the
    frontend's coefficients, and its own parameters are not read.

The LM steps run under ``torch.inference_mode``.  The LM train cell
(``lm_train``) and the reference's unfused optimizers (AdamW,
for the LM family below its parameter thresholds) come with the LM
training slice (``ROADMAP.md`` queue 1); ``build_cell`` refuses it, and a
cell the arch skips.  Every recsys cell trains with the fused Adafactor.

``init_inputs(program, generator)`` draws a batch of inputs in the
reference's ranges.  The reference's sharding specs and shape-only avals
belong to the mesh path (``ROADMAP.md`` queue 1, "The multi-GPU mesh
path").
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import (get_arch, get_cell, get_config,
                                      input_specs, is_skipped)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import recsys as recsys_lib
from repro_torch.models import transformer as tfm
from repro_torch.optim import warmup_cosine
from repro_torch.optim.base import Optimizer
from repro_torch.optim.optimizers import adafactor_fused
from repro_torch.tree import tree_leaves, tree_map, unflatten_like


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
    optimizer: Optional[Optimizer] = None   # recsys_train, fused

    def init_params(self, generator: torch.Generator):
        """Fresh weights from ``generator``, which must be on the
        program's device: a ``TransformerModel`` or a ``RecsysModel``."""
        if torch.device(generator.device).type != self.device.type:
            raise ValueError(f"generator on {generator.device}, program on "
                             f"{self.device}")
        if self.family == "lm":
            return tfm.init_params(self.config, generator)
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
        loss = lambda p, batch: recsys_lib.recsys_loss(model, batch, p)
        return _make_train_step(loss, self.optimizer)(params, opt_state,
                                                      inputs)


def _pick_optimizer() -> Optimizer:
    """A recsys train cell's optimizer: embedding tables dominate, so a
    factored second moment (O(V + d) state a table) in place of AdamW's
    two table-sized states, applied by the fused update."""
    return adafactor_fused(warmup_cosine(3e-4, 200, 10000), momentum=None)


def _make_train_step(loss_fn: Callable, optimizer: Optimizer,
                     microbatch: int = 1) -> Callable:
    """``step(params, opt_state, inputs) -> (params, opt_state, loss)``,
    gradients by ``torch.autograd.grad``, applied by a fused optimizer
    (``update(g, s, p) -> (new_params, new_state)``).  With ``microbatch``
    m > 1 the batch is split in m along axis 0, the gradients summed over
    the slices from zero and divided by m in the parameters' type, as the
    reference's scan does."""

    def grads_of(params, inputs):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = loss_fn(live, inputs)
        grads = torch.autograd.grad(loss, tree_leaves(live))
        return loss.detach(), unflatten_like(params, list(grads))

    def step(params, opt_state, inputs):
        if microbatch <= 1:
            loss, grads = grads_of(params, inputs)
        else:
            m = microbatch
            grads = tree_map(torch.zeros_like, params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            for i in range(m):
                mb = {k: v.reshape(m, v.shape[0] // m, *v.shape[1:])[i]
                      for k, v in inputs.items()}
                l_i, g_i = grads_of(params, mb)
                grads = tree_map(lambda a, g: a + g.to(a.dtype), grads, g_i)
                loss = loss + l_i
            grads = tree_map(lambda g: (g / m).to(g.dtype), grads)
            loss = loss / m
        with torch.no_grad():
            params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, loss

    return step


def build_cell(arch_id: str, cell_name: str, smoke: bool = False,
               device: DeviceLike = None) -> CellProgram:
    cell = get_cell(arch_id, cell_name)
    reason = is_skipped(arch_id, cell_name)
    if reason:
        raise ValueError(f"{arch_id} skips {cell_name}: {reason}")
    if cell.kind == "lm_train":
        raise NotImplementedError(
            f"{arch_id}/{cell_name}: LM training is not ported yet "
            "(ROADMAP.md queue 1, LM training)")
    specs = input_specs(arch_id, cell_name, smoke)
    prog = CellProgram(arch_id=arch_id, cell_name=cell_name, kind=cell.kind,
                       family=get_arch(arch_id).family,
                       config=get_config(arch_id, smoke),
                       device=resolve_device(device), input_specs=specs,
                       n_candidates=specs.pop("n_candidates", None))
    if cell.kind == "recsys_train":
        prog.optimizer = _pick_optimizer()
    return prog


def init_inputs(program: CellProgram,
                generator: torch.Generator) -> Dict[str, Any]:
    """One batch of random inputs, drawn on the generator's device in the
    reference's ranges: LM ``tokens`` in [0, vocab), a zero ``cache`` and
    ``pos`` 2 (int32); recsys ``field_ids`` in [0, vocab), ``hist_ids``
    and ``target_id`` in [0, item_vocab), ``set_ids`` in [0, 2^s),
    ``set_counts`` in [1, set_nnz), ``hist_mask`` ones and ``labels``
    Bernoulli(0.5) in float32."""
    cfg = program.config
    dev = generator.device
    if program.family == "lm":
        tok = program.input_specs["tokens"]
        out = {"tokens": torch.randint(0, cfg.vocab, tok.shape,
                                       dtype=tok.dtype, generator=generator,
                                       device=dev)}
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
