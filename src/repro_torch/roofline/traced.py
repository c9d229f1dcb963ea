"""A step's compiled analysis, traced: the port's counterpart of the
reference's ``repro.roofline.hlo`` (collectives parsed from the compiled
HLO) and of XLA's ``compiled.memory_analysis()`` (temp bytes) and
``compiled.cost_analysis()`` (FLOPs, bytes accessed).

torch compiles nothing, so a step is *run* instead, on tensors of the
meta device (shapes, strides and types, no data, no device), under
``StepTrace``, a ``TorchDispatchMode`` that sees every aten operation the
step issues below autograd -- the backward's included -- and records:

  * **FLOPs**: torch's own formulas (``torch.utils.flop_counter``: the
    products, convolutions and attention kernels), as ``FlopCounterMode``
    counts them;
  * **bytes accessed**: each operation's operand bytes plus its result
    bytes, views (and bare allocations) excluded -- how XLA defines its
    ``bytes accessed``;
  * **collectives, by kind, with counts**: torch's functional collectives
    (``sharding.spmd``'s gathers, reduce-scatters, all-reduces and
    all-to-alls) and the in-place c10d all-reduce (``spmd.pmean_``), under
    the reference's kind names (``all-gather``, ``all-reduce``,
    ``reduce-scatter``, ``all-to-all``), each op's bytes ``max(result,
    operands)`` as ``hlo.collective_bytes`` takes them;
  * **the peak of live bytes**: each storage once, rounded up to 512 B as
    the CUDA caching allocator rounds a block, from the step's entry (its
    arguments live) to its exit.  ``temp_bytes`` is that peak less
    arguments + outputs - aliased outputs, the quantity XLA's memory
    analysis reports.

A kernel of ours is an operator of its own (``kernels.build.kernel_op``):
on meta tensors it allocates the results its launch allocates and
launches nothing, and the trace counts its operands and results as it
counts any operation's, as XLA counts a custom call's.

A dispatch mode makes autograd's derivative formulas take the branches
they keep for tensor subclasses (``isTensorSubclassLike`` is true while
any mode is active): where a formula would write a fresh zero buffer in
place (``new_zeros(...).index_add_(...)``, the backward of a lookup), it
writes an out-of-place copy instead.  The trace counts such a step as the
in-place one the card runs: inside a derivative formula (a graph task
running with gradients off), a scatter-type operation on a zero buffer
made there and not read since takes over that buffer's bytes.

Unlike XLA:CPU's cost analysis, which counts a ``while`` body once, this
counts every layer of the Python loops: there is no once-per-loop
undercount.  What it cannot see: workspaces an operation allocates inside
its kernel (cuBLAS, a sort's scratch) and the allocator's fragmentation.

Meta, not ``FakeTensorMode``'s fake CUDA tensors: autograd on a fake CUDA
tensor needs CUDA's device guard, which a CPU-only build of torch lacks
(it aborts the process), and the dry run runs on any machine.  The card's
path is still the one traced: the port's device branches send meta
tensors where they send CUDA ones (``attention.matmul_f32``'s bfloat16
product with a float32 result; the kernels' wrappers).

Operations on meta tensors cost 30-250 us each in torch's meta kernels,
so the traces of a process remember, per (operation, argument shapes,
strides and types, other arguments), the outputs' layout and the
operation's counts: an operation seen before whose outputs are meta
tensors sharing no storage with its inputs gets fresh outputs of that layout
without running its meta kernel again, and an in-place one on a meta tensor
returns that tensor (there is nothing to write).  Operations on tensors with data
always run (the same trace on CPU tensors checks the meta one).
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from collections import defaultdict
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

ALLOC_ROUND = 512          # the caching allocator's block granularity

# (namespace, op name) -> the reference's kind of collective
COLLECTIVES = {
    ("_c10d_functional", "all_gather_into_tensor"): "all-gather",
    ("_c10d_functional", "all_reduce"): "all-reduce",
    ("_c10d_functional", "reduce_scatter_tensor"): "reduce-scatter",
    ("_c10d_functional", "all_to_all_single"): "all-to-all",
    ("_c10d_functional_autograd", "all_gather_into_tensor"): "all-gather",
    ("_c10d_functional_autograd", "reduce_scatter_tensor"): "reduce-scatter",
    ("_c10d_functional_autograd", "all_to_all_single"): "all-to-all",
    ("c10d", "allreduce_"): "all-reduce",
    ("c10d", "allgather_"): "all-gather",
    ("c10d", "_allgather_base_"): "all-gather",
    ("c10d", "reduce_scatter_"): "reduce-scatter",
    ("c10d", "_reduce_scatter_base_"): "reduce-scatter",
    ("c10d", "alltoall_base_"): "all-to-all",
}
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")

# operations that neither compute nor move bytes
_SILENT = {("_c10d_functional", "wait_tensor"),
           ("_c10d_functional", "_wrap_tensor_autograd"),
           ("aten", "empty"), ("aten", "empty_strided"),
           ("aten", "empty_like"), ("aten", "new_empty"),
           ("aten", "new_empty_strided"), ("aten", "lift_fresh"),
           ("prim", "device"), ("prim", "layout")}

# zero buffers a derivative formula makes, and the scatter-type operations
# that would write into one in place outside a dispatch mode
_ZEROS = {("aten", "new_zeros"), ("aten", "zeros"), ("aten", "zeros_like")}
_SCATTERS = {("aten", n) for n in (
    "index_add", "index_put", "_index_put_impl", "index_copy", "scatter",
    "scatter_add", "masked_scatter", "slice_scatter", "select_scatter",
    "diagonal_scatter", "as_strided_scatter")}

# in-place operations that change their tensor's shape or strides
_RESHAPING = {"resize_", "resize_as_", "set_", "as_strided_", "squeeze_",
              "unsqueeze_", "t_", "transpose_", "swapdims_", "swapaxes_",
              "_resize_output_", "detach_"}

# (operation, its arguments' description) -> (output layouts or None,
# where they alias or hold data, FLOPs, bytes): shared by every trace of
# the process (a
# meta kernel's result depends on nothing else), bounded
_MEMO: Dict[Any, Tuple] = {}
MEMO_LIMIT = 500_000


def rounded(nbytes: int) -> int:
    """``nbytes`` as the caching allocator holds it (0 for nothing)."""
    return -(-nbytes // ALLOC_ROUND) * ALLOC_ROUND


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def local_leaves(tree) -> list:
    """The plain tensors of a tree of dicts, lists and tuples; a DTensor
    gives its local shard."""
    from torch.distributed.tensor import DTensor
    out = []
    for leaf in tree_flatten(tree)[0]:
        if isinstance(leaf, DTensor):
            out.append(leaf.to_local())
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf)
    return out


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


@dataclasses.dataclass
class TraceCounts:
    """What a trace of one step records (bytes per rank)."""
    flops: int = 0
    bytes_accessed: int = 0
    coll_bytes: Dict[str, int] = dataclasses.field(default_factory=dict)
    coll_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    args_bytes: int = 0          # live storages at entry
    output_bytes: int = 0        # the outputs' storages
    alias_bytes: int = 0         # outputs whose storage is an argument's
    peak_bytes: int = 0          # live bytes at most, arguments included
    ops: int = 0
    seconds: float = 0.0

    @property
    def temp_bytes(self) -> int:
        return self.peak_bytes - (self.args_bytes + self.output_bytes
                                  - self.alias_bytes)

    @property
    def coll_total(self) -> int:
        return sum(self.coll_bytes.values())

    def breakdown(self) -> Dict[str, Any]:
        """The reference's ``collective_bytes`` breakdown: bytes by kind,
        and ``_counts``."""
        out: Dict[str, Any] = dict(self.coll_bytes)
        out["_counts"] = dict(self.coll_counts)
        return out


class _Opaque(Exception):
    """An argument ``_describe`` cannot key on."""


_SCALARS = (int, float, bool, str, type(None), torch.dtype, torch.device,
            torch.layout, torch.memory_format)


def _describe(x):
    """A hashable description of one argument: a tensor by its layout."""
    if isinstance(x, torch.Tensor):
        return (x.shape, x.stride(), x.dtype, x.is_meta)
    if isinstance(x, (list, tuple)):
        return (type(x),) + tuple(_describe(v) for v in x)
    if isinstance(x, _SCALARS):
        return x
    raise _Opaque


def _key(func, args, kwargs):
    """The memo key of one call, or None."""
    try:
        return (func, _describe(args),
                tuple((k, _describe(v)) for k, v in kwargs.items()))
    except _Opaque:
        return None


def _tensors(x, out: list) -> list:
    """The tensors of nested tuples, lists and dicts, in order."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    return out


class _Info:
    """What a trace needs to know of one operation, found once."""
    __slots__ = ("silent", "collective", "decomposes", "aliases", "flops",
                 "dtype_overload", "zeros", "scatter", "inplace")

    def __init__(self, func, registry):
        name = (func.namespace, func._opname)
        self.zeros = name in _ZEROS
        self.scatter = name in _SCATTERS
        self.silent = name in _SILENT or func.is_view
        self.collective = COLLECTIVES.get(name)
        self.decomposes = torch._C._dispatch_has_kernel_for_dispatch_key(
            func.name(), torch._C.DispatchKey.CompositeImplicitAutograd)
        self.aliases = func.is_view or any(r.alias_info is not None
                                           for r in func._schema.returns)
        rets, params = func._schema.returns, func._schema.arguments
        # writes its first argument and returns it, its layout unchanged
        self.inplace = (len(rets) == 1 and rets[0].alias_info is not None
                        and rets[0].alias_info.is_write and bool(params)
                        and params[0].alias_info is not None
                        and rets[0].alias_info.before_set
                        == params[0].alias_info.before_set
                        and func._opname not in _RESHAPING)
        self.flops = registry.get(func._overloadpacket)
        self.dtype_overload = func._overloadname == "dtype"


_INFO: Dict[Any, _Info] = {}


_SELF = object()       # a remembered in-place operation: its first argument


class _Layout(tuple):
    """A remembered output tensor: (shape, stride, dtype, device)."""


def _layout(x):
    if isinstance(x, torch.Tensor):
        return _Layout((tuple(x.shape), x.stride(), x.dtype, x.device))
    return x


def _make(lay):
    """A fresh output of a remembered layout (another value as it was)."""
    if isinstance(lay, _Layout):
        shape, stride, dtype, device = lay
        return torch.empty_strided(shape, stride, dtype=dtype, device=device)
    return lay


_PLAIN = (torch.Tensor, torch.nn.Parameter)


def _shares_storage(outs, ins) -> bool:
    """Does an output live in an input's storage (``_unsafe_view`` and
    the like, whose schemas do not say so)?"""
    held = {_storage_key(t) for t in ins if type(t) in _PLAIN}
    return any(_storage_key(t) in held for t in outs)


class StepTrace(TorchDispatchMode):
    """Records a step's counts (see the module docstring).  Use::

        with StepTrace() as tr:
            tr.enter(args)          # the arguments' storages are live
            out = step(*args)
            tr.exit(out)
        tr.counts                   # a TraceCounts
    """

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self.flops = 0
        self.bytes_accessed = 0
        self.coll_bytes: Dict[str, int] = defaultdict(int)
        self.coll_counts: Dict[str, int] = defaultdict(int)
        self.ops = 0
        self._live: Dict[int, int] = {}       # storage -> rounded bytes
        self._cur = self._peak = 0
        self._entry: Dict[int, int] = {}
        self._fresh: set = set()     # a formula's zero buffers, unread
        self._t0 = 0.0
        self.counts: Optional[TraceCounts] = None

    # -- live bytes -------------------------------------------------------

    def _take_over(self, src: torch.Tensor, out: torch.Tensor) -> bool:
        """``out`` takes over ``src``'s live bytes (an in-place write),
        if their storages are the same size."""
        key, st = _storage_key(src), out.untyped_storage()
        held = self._live.get(key)
        if (held is None or src.untyped_storage().nbytes() != st.nbytes()
                or st._cdata in self._live):
            return False
        del self._live[key]
        self._live[st._cdata] = held
        weakref.finalize(st, self._free, st._cdata)
        return True

    def _free(self, key: int) -> None:
        n = self._live.pop(key, None)
        if n is not None:
            self._cur -= n

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = rounded(st.nbytes())
        self._live[key] = n
        self._cur += n
        weakref.finalize(st, self._free, key)
        if self._cur > self._peak:
            self._peak = self._cur

    def enter(self, *trees) -> None:
        """Mark the step's entry: the storages of ``trees`` (its
        arguments: parameters, optimizer state, inputs, the model's
        buffers) are live."""
        for t in local_leaves(trees):
            self._hold(t)
        self._entry = dict(self._live)
        self._peak = self._cur
        self._t0 = time.perf_counter()

    def exit(self, outputs) -> TraceCounts:
        """Mark the step's exit, with its outputs; returns the counts."""
        seconds = time.perf_counter() - self._t0
        outs: Dict[int, int] = {}
        for t in local_leaves(outputs):
            outs.setdefault(_storage_key(t),
                            rounded(t.untyped_storage().nbytes()))
        self.counts = TraceCounts(
            flops=self.flops, bytes_accessed=self.bytes_accessed,
            coll_bytes=dict(self.coll_bytes),
            coll_counts=dict(self.coll_counts),
            args_bytes=sum(self._entry.values()),
            output_bytes=sum(outs.values()),
            alias_bytes=sum(n for k, n in outs.items() if k in self._entry),
            peak_bytes=self._peak, ops=self.ops, seconds=seconds)
        return self.counts

    # -- the operations -----------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for t in types:
            if t not in _PLAIN and issubclass(t, _dtensor()):
                return NotImplemented    # its local operations come here
        info = _INFO.get(func)
        if info is None:
            info = _INFO[func] = _Info(func, self._flops)
        if info.silent:
            out = func(*args, **kwargs)
            self._hold_all(out)
            return out
        if info.collective is not None:
            out = func(*args, **kwargs)
            self.coll_bytes[info.collective] += max(
                sum(map(tensor_bytes, _tensors((args, kwargs), []))),
                sum(map(tensor_bytes, _tensors(out, []))))
            self.coll_counts[info.collective] += 1
            self.ops += 1
            self._hold_all(out)
            return out
        if info.decomposes:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        self.ops += 1
        formula = (not torch.is_grad_enabled()
                   and torch._C._current_graph_task_id() != -1)
        into = False
        if self._fresh:
            if (info.scatter and formula and args
                    and isinstance(args[0], torch.Tensor)):
                into = _storage_key(args[0]) in self._fresh
            self._fresh.difference_update(
                _storage_key(t) for t in _tensors((args, kwargs), []))
        key = _key(func, args, kwargs)
        hit = _MEMO.get(key) if key is not None else None
        if hit is not None and hit[0] is not None:
            layouts, flops, nbytes = hit
            if layouts is _SELF:
                out = args[0]
            elif isinstance(layouts, _Layout):
                out = _make(layouts)
            else:
                out = type(layouts)(_make(lay) for lay in layouts)
        else:
            out = func(*args, **kwargs)
            if hit is None:
                outs = _tensors(out, [])
                flops = self._count_flops(info, args, kwargs, out)
                ins = _tensors((args, kwargs), [])
                nbytes = (sum(map(tensor_bytes, ins))
                          + sum(map(tensor_bytes, outs))) if outs else 0
                layouts = None
                if (info.inplace and out is args[0] and out.is_meta
                        and type(out) in _PLAIN):
                    layouts = _SELF
                elif (not info.aliases and outs
                        and all(type(t) in _PLAIN and t.is_meta
                                for t in outs)
                        and not _shares_storage(outs, ins)):
                    if isinstance(out, torch.Tensor):
                        layouts = _layout(out)
                    elif (type(out) in (tuple, list) and not any(
                            isinstance(v, (tuple, list, dict)) for v in out)):
                        layouts = type(out)(_layout(v) for v in out)
                if key is not None:
                    if len(_MEMO) >= MEMO_LIMIT:
                        _MEMO.clear()
                    _MEMO[key] = (layouts, flops, nbytes)
            else:
                _, flops, nbytes = hit
        self.flops += flops
        self.bytes_accessed += nbytes
        if not (into and isinstance(out, torch.Tensor)
                and self._take_over(args[0], out)):
            self._hold_all(out)
        if info.zeros and formula and isinstance(out, torch.Tensor):
            self._fresh.add(_storage_key(out))
        return out

    def _hold_all(self, out) -> None:
        if isinstance(out, torch.Tensor):
            if type(out) in _PLAIN:
                self._hold(out)
            return
        for t in _tensors(out, []):
            if type(t) in _PLAIN:
                self._hold(t)

    @staticmethod
    def _count_flops(info: _Info, args, kwargs, out) -> int:
        if info.flops is None:
            return 0
        if info.dtype_overload:           # mm / bmm with out_dtype
            args, kwargs = args[:2], {}
        return int(info.flops(*args, **kwargs, out_val=out))


_DTENSOR: list = []


def _dtensor():
    if not _DTENSOR:
        from torch.distributed.tensor import DTensor
        _DTENSOR.append(DTensor)
    return _DTENSOR[0]


def trace_step(step: Callable, args: Tuple, extra=()) -> Tuple[Any,
                                                                TraceCounts]:
    """``step(*args)`` under a ``StepTrace``; ``extra`` holds other trees
    live at entry (the model's buffers).  Returns (outputs, counts)."""
    with StepTrace() as tr:
        tr.enter(args, extra)
        out = step(*args)
        counts = tr.exit(out)
    return out, counts
