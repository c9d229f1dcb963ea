"""Generic training loop machinery (port of ``repro.train.trainer``).

``make_train_step`` turns (loss_fn, optimizer) into a step function whose
gradients come from autograd (``torch.autograd.grad``, in place of
``jax.value_and_grad``); ``Trainer`` adds the loop around it: checkpoint /
resume, heartbeat / straggler tracking, bounded-retry restart.  The
online-learning loop (paper §6) accounts load time against train time per
epoch, the quantity the paper's Table 4 reports.

PyTorch runs eagerly, so the reference's ``jit`` switch has no
counterpart.  Steps are as deterministic as their operations: a gather's
backward on the card is an atomic scatter-add, so a caller that needs
bit-identical reruns (a restart that must land on the unfailed weights)
wraps ``fit`` in ``torch.use_deterministic_algorithms(True)``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch

from repro_torch.optim.base import Optimizer, apply_updates, params_device
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.fault import Heartbeat, run_with_restarts
from repro_torch.tree import tree_leaves, tree_map, unflatten_like


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: torch.Tensor           # () int32, on the parameters' device

    @staticmethod
    def create(params: Any, optimizer: Optimizer) -> "TrainState":
        return TrainState(params=params, opt_state=optimizer.init(params),
                          step=torch.zeros((), dtype=torch.int32,
                                           device=params_device(params)))


def make_train_step(loss_fn: Callable, optimizer: Optimizer,
                    ) -> Callable[[TrainState, Any], Tuple[TrainState, Dict]]:
    """loss_fn(params, batch) -> 0-d loss. Returns step(state, batch) ->
    (new state, {"loss", "grad_norm"}); the old state is left as it was."""

    def step(state: TrainState, batch: Any) -> Tuple[TrainState, Dict]:
        params = tree_map(lambda p: p.detach().requires_grad_(True),
                          state.params)
        leaves = tree_leaves(params)
        loss = loss_fn(params, batch)
        grads = unflatten_like(params, torch.autograd.grad(loss, leaves))
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, state.opt_state,
                                                  state.params)
            new_params = apply_updates(state.params, updates)
            gnorm = torch.sqrt(sum(torch.square(g.to(torch.float32)).sum()
                                   for g in tree_leaves(grads)))
        return (TrainState(params=new_params, opt_state=opt_state,
                           step=state.step + 1),
                {"loss": loss.detach(), "grad_norm": gnorm})

    return step


def _wait(tree) -> None:
    """Block until the device work behind ``tree``'s tensors is done."""
    dev = params_device(tree)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclasses.dataclass
class Trainer:
    """The loop: steps + checkpointing + fault handling."""

    step_fn: Callable[[TrainState, Any], Tuple[TrainState, Dict]]
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    keep: int = 3
    heartbeat_deadline_s: float = 120.0
    max_failures: int = 3

    def __post_init__(self):
        self.heartbeat = Heartbeat(deadline_s=self.heartbeat_deadline_s)
        self.metrics_log: list[Dict] = []

    def maybe_resume(self, state: TrainState) -> TrainState:
        if self.ckpt_dir and ckpt_lib.latest_step(self.ckpt_dir) is not None:
            state, _ = ckpt_lib.restore(self.ckpt_dir, state)
        return state

    def fit(self, state: TrainState, batches: Callable[[], Iterable[Any]],
            n_steps: int, start_step: int = 0) -> TrainState:
        """Run up to n_steps over (repeatable) batch streams with restarts.

        Steps are counted from ``start_step``, whose batches the stream
        skips: a state resumed at step s passes ``start_step=s`` and the
        run's total as ``n_steps``, so checkpoints keep absolute step
        names.  (The reference counts from 0, so a resumed run there takes
        ``n_steps`` more steps under step names that restart at 0.)"""

        def run(st: TrainState, from_step: int):
            step_no = from_step
            it = iter(batches())
            # skip batches already consumed before the restart
            for _ in range(from_step):
                next(it, None)
            for batch in it:
                if step_no >= n_steps:
                    break
                t0 = time.perf_counter()
                st, metrics = self.step_fn(st, batch)
                _wait(st.params)
                self.heartbeat.observe(time.perf_counter() - t0)
                step_no += 1
                self.metrics_log.append(
                    {k: float(v) for k, v in metrics.items()})
                if self.ckpt_dir and step_no % self.ckpt_every == 0:
                    ckpt_lib.save(self.ckpt_dir, step_no, st, keep=self.keep)
            if self.ckpt_dir:
                ckpt_lib.save(self.ckpt_dir, step_no, st, keep=self.keep)
            return st, step_no

        def restore():
            step = ckpt_lib.latest_step(self.ckpt_dir) or 0
            return ckpt_lib.restore(self.ckpt_dir, state, step=step)

        if not self.ckpt_dir:
            st, _ = run(state, start_step)
            return st
        st, _, _ = run_with_restarts(
            init_state=state, init_step=start_step, run_steps=run,
            restore_fn=restore, max_failures=self.max_failures)
        return st


# ---------------------------------------------------------------------------
# Online-learning epoch loop with load/train accounting (paper §6)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EpochTimes:
    load_s: float = 0.0
    train_s: float = 0.0


def online_epochs(sgd_step: Callable, state: Any,
                  epoch_batches: Callable[[], Iterable[Any]],
                  n_epochs: int,
                  eval_fn: Optional[Callable[[Any], float]] = None
                  ) -> Tuple[Any, list, list]:
    """Run SGD epochs, re-loading the data each epoch (the paper's
    disk-resident setup).  Returns (final state, per-epoch EpochTimes,
    per-epoch eval metrics); each step's train time ends in a device
    sync, so it holds the device's work."""
    times, evals = [], []
    for _ in range(n_epochs):
        et = EpochTimes()
        t_iter = time.perf_counter()
        for batch in epoch_batches():
            t_loaded = time.perf_counter()
            et.load_s += t_loaded - t_iter
            state = sgd_step(state, batch)
            _wait(state)
            t_iter = time.perf_counter()
            et.train_s += t_iter - t_loaded
        times.append(et)
        evals.append(float(eval_fn(state)) if eval_fn else float("nan"))
    return state, times, evals
