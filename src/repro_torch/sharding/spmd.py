"""Collectives with autograd over the axes of a ``ProcessMesh``: what the
reference's ``shard_map`` bodies call (``all_gather``, ``psum``,
``all_to_all``) and what GSPMD inserts between layouts, for code that runs
on each rank's local shards.

Cotangent convention (Megatron's): a tensor replicated over an axis
carries the *whole* cotangent on every rank of that axis, not a share.
So each operation's backward is its adjoint under that convention:

  ``gather(x, dim, axes)``        all-gather; backward: the rank's own
                                  chunk of the cotangent (the gathered
                                  tensor feeds replicated work), or with
                                  ``grad="sum"`` a reduce-scatter (it
                                  feeds work split over ``axes``: FSDP's
                                  just-in-time weight gather);
  ``scatter(x, dim, axes)``       the rank's own chunk; backward:
                                  all-gather;
  ``reduce_scatter(x, dim, axes)`` sum, then the rank's chunk; backward:
                                  all-gather;
  ``psum(x, axes)``               all-reduce to a replicated result;
                                  backward: identity (Megatron's g);
  ``enter(x, axes)``              identity; backward: all-reduce -- a
                                  replicated tensor entering work split
                                  over ``axes`` (Megatron's f, the
                                  transpose of ``shard_map``'s broadcast
                                  of an unmapped input);
  ``all_to_all(x, axes)``         chunk k of dim 0 to the rank numbered k;
                                  backward: the same exchange.

The all-gather with a reduce-scattered backward, the reduce-scatter and
the all-to-all are torch's functional collectives with autograd; the
other backwards are this module's own.  Chunks are numbered as the
reference numbers an axis tuple, the first axis major
(``ProcessMesh.index``), whatever the process group's own order.

``Shards`` is what one SPMD body needs: the mesh, the axes its batch rows
and its edges are split over.  With no mesh (``Shards()``), or over axes
of one rank, every operation is the identity and runs no collective, so
one model body serves the mesh and a single device; ``WHOLE`` stands for
the per-dim axes of a tree none of whose leaves is sharded.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as fc

Axes = Union[str, Sequence[str], None]

# torch 2.13's names; the older torch has only the earlier ones, which
# 2.13 keeps but warns on
_all_gather = getattr(fc, "all_gather_single", fc.all_gather_tensor)
_all_gather_ad = getattr(fc, "all_gather_single_autograd",
                         fc.all_gather_tensor_autograd)
_reduce_scatter = getattr(fc, "reduce_scatter_single",
                          fc.reduce_scatter_tensor)
_reduce_scatter_ad = getattr(fc, "reduce_scatter_single_autograd",
                             fc.reduce_scatter_tensor_autograd)



def _axes(axes: Axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _trivial(mesh, axes) -> bool:
    return mesh is None or mesh.extent(axes) == 1


def _done(t: torch.Tensor) -> torch.Tensor:
    """A functional collective's result, waited for."""
    return t.wait() if isinstance(t, fc.AsyncCollectiveTensor) else t


def _from_group(x: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    """Chunks along ``dim`` in the group's order -> in the reference's."""
    order = mesh.order(axes)
    if order == tuple(range(len(order))):
        return x
    parts = x.chunk(len(order), dim)
    ordered = [None] * len(order)
    for g, k in enumerate(order):
        ordered[k] = parts[g]
    return torch.cat(ordered, dim)


def _to_group(x: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    """Chunks along ``dim`` in the reference's order -> the group's."""
    order = mesh.order(axes)
    if order == tuple(range(len(order))):
        return x
    parts = x.chunk(len(order), dim)
    return torch.cat([parts[k] for k in order], dim)


def _raw_gather(x: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    out = _done(_all_gather(x.contiguous(), dim, mesh.group(axes)))
    return _from_group(out, dim, mesh, axes)


def _raw_scatter(x: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    size = x.shape[dim] // mesh.extent(axes)
    return x.narrow(dim, mesh.index(axes) * size, size).contiguous()


def _raw_all_reduce(x: torch.Tensor, mesh, axes, op: str = "sum"
                    ) -> torch.Tensor:
    return _done(fc.all_reduce(x.contiguous(), op, mesh.group(axes)))


class _SliceGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axes):
        ctx.args = (dim, mesh, axes)
        return _raw_gather(x, dim, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return (_raw_scatter(g, *ctx.args),) + (None,) * 3


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axes):
        ctx.args = (dim, mesh, axes)
        return _raw_scatter(x, dim, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return (_raw_gather(g, *ctx.args),) + (None,) * 3


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _raw_all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _raw_all_reduce(g, *ctx.args), None, None


def gather(x: torch.Tensor, dim: int, mesh, axes: Axes,
           grad: str = "slice") -> torch.Tensor:
    """All-gather ``x`` along ``dim`` over ``axes``; ``grad`` is "slice"
    (the result feeds replicated work) or "sum" (it feeds work split over
    ``axes``: the backward reduce-scatters)."""
    axes = _axes(axes)
    if _trivial(mesh, axes):
        return x
    dim %= x.dim()
    # without a gradient recorded (serving) the plain collectives run the
    # same exchange: torch 2.11's autograd ones have no meta kernel, which
    # a dry-run trace needs
    if not torch.is_grad_enabled():
        return _raw_gather(x, dim, mesh, axes)
    if grad == "sum":
        out = _all_gather_ad(x.contiguous(), dim, mesh.group(axes))
        return _from_group(out, dim, mesh, axes)
    return _SliceGather.apply(x, dim, mesh, axes)


def scatter(x: torch.Tensor, dim: int, mesh, axes: Axes) -> torch.Tensor:
    """This rank's chunk of ``x`` along ``dim`` over ``axes``."""
    axes = _axes(axes)
    if _trivial(mesh, axes):
        return x
    return _Scatter.apply(x, dim % x.dim(), mesh, axes)


def reduce_scatter(x: torch.Tensor, dim: int, mesh, axes: Axes
                   ) -> torch.Tensor:
    """The sum of ``x`` over ``axes``, this rank's chunk along ``dim``."""
    axes = _axes(axes)
    if _trivial(mesh, axes):
        return x
    dim %= x.dim()
    fn = _reduce_scatter_ad if torch.is_grad_enabled() else _reduce_scatter
    return _done(fn(_to_group(x, dim, mesh, axes).contiguous(), "sum", dim,
                    mesh.group(axes)))


def psum(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """The sum over ``axes``, replicated (backward: identity)."""
    axes = _axes(axes)
    if _trivial(mesh, axes):
        return x
    return _Psum.apply(x, mesh, axes)


def enter(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """``x`` unchanged; its cotangent summed over ``axes``."""
    axes = _axes(axes)
    if _trivial(mesh, axes) or not x.requires_grad:
        return x
    return _Enter.apply(x, mesh, axes)


def all_to_all(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """Chunk k of dim 0 goes to the rank numbered k along ``axes``; the
    result holds the chunks received, by sender."""
    axes = _axes(axes)
    if _trivial(mesh, axes):
        return x
    fn = (fc.all_to_all_single_autograd if torch.is_grad_enabled()
          else fc.all_to_all_single)
    out = _done(fn(_to_group(x, 0, mesh, axes).contiguous(), None, None,
                   mesh.group(axes)))
    return _from_group(out, 0, mesh, axes)


def pmax(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """The maximum over ``axes``, outside autograd (``x`` itself over
    axes of one rank)."""
    axes = _axes(axes)
    if _trivial(mesh, axes):
        return x
    return _raw_all_reduce(x.detach(), mesh, axes, "max")


def pmean_(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """The mean over ``axes`` (no gradient), written into ``x``."""
    axes = _axes(axes)
    if not _trivial(mesh, axes):
        dist.all_reduce(x, group=mesh.group(axes))
        x.div_(mesh.extent(axes))
    return x


def use(t: torch.Tensor, mesh, entries, keep: Axes = (),
        split: Axes = ()) -> torch.Tensor:
    """A parameter's local shard made ready for work split over ``split``:
    its dims' axes (``entries``, first major) gathered, minor first, but
    for those in ``keep`` (which must be major to the gathered ones): an
    axis the work is split over gathers with the cotangent summed (FSDP's
    reduce-scatter), another with the rank's own chunk of it.  Then the
    cotangent is summed over the axes of ``split`` the shard is not
    sharded over (the tensor is replicated there, its work is not)."""
    if mesh is None:
        return t
    keep, split = _axes(keep), _axes(split)
    held = set()
    for dim, axes in enumerate(entries):
        axes = _axes(axes)
        held.update(axes)
        for a in reversed(axes):
            if a in keep:
                continue
            t = gather(t, dim, mesh, (a,), "sum" if a in split else "slice")
    return enter(t, mesh, tuple(a for a in split if a not in held))


class _Whole:
    """The per-dim axes of a tree whose leaves are all whole: any part of
    it is itself, and it names no axis."""
    _tree_leaf = True

    def __getitem__(self, key):
        return self

    def __repr__(self) -> str:
        return "WHOLE"


WHOLE = _Whole()


class Shards:
    """One SPMD body's context: the process mesh (None: a single device),
    the axes its batch rows are split over (``rows``) and those a graph's
    edges are split over (``edges``).  ``tp`` is the extent of "model"."""

    def __init__(self, mesh=None, rows: Axes = (), edges: Axes = ()):
        self.mesh, self.rows, self.edges = mesh, _axes(rows), _axes(edges)
        self.tp = (mesh.extent("model") if mesh is not None
                   and "model" in mesh.axis_names else 1)

    def extent(self, axes: Axes) -> int:
        return 1 if self.mesh is None else self.mesh.extent(_axes(axes))

    def index(self, axes: Axes) -> int:
        return 0 if self.mesh is None else self.mesh.index(_axes(axes))

    def model_split(self, ent, dim: int = -1) -> bool:
        """Is the leaf's ``dim`` (per-dim axes ``ent``) split over a
        "model" of more than one rank?"""
        return self.tp > 1 and "model" in (ent[dim] or ())

    def heads_split(self, n_heads: int, ent_in, ent_out) -> bool:
        """Do a block's heads split over "model": its input projection's
        columns and its output projection's rows sharded there, and the
        heads divisible?"""
        return (self.model_split(ent_in) and self.model_split(ent_out, 0)
                and n_heads % self.tp == 0)

    def use(self, t: torch.Tensor, ent, keep: Axes = (),
            split: Axes = None) -> torch.Tensor:
        """A weight made ready (``use``) for work split over ``split``,
        by default the rows and ``keep``: its split over ``keep`` kept."""
        keep = _axes(keep)
        return use(t, self.mesh, ent, keep=keep,
                   split=self.rows + keep if split is None else split)

    def col(self, x: torch.Tensor, w: torch.Tensor, ent):
        """``x @ w``, column-parallel over "model" where ``w``'s columns
        are split there: (the product, split over "model"?)."""
        if self.model_split(ent):
            xt = enter(x, self.mesh, ("model",))
            return xt @ self.use(w, ent, ("model",)), True
        return x @ self.use(w, ent), False
