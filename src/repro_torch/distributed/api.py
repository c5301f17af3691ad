"""Logical-axis sharding API (the counterpart of ``repro.distributed.api``).

Model code names a tensor's dims with LOGICAL axes; a rules table maps
them to mesh axes of a ``torch.distributed`` ``DeviceMesh``.
``resolve_spec`` gives the JAX package's ``PartitionSpec`` entries (one a
tensor dim: None, a mesh axis name or a tuple of them), degrading a dim to
replication where it does not divide the mapped mesh axes and dropping
mesh axes the mesh lacks. ``placements`` turns such a spec into DTensor
placements, one a mesh dim; ``shard(x, *names)`` redistributes a DTensor
to them (a plain tensor, this rank's copy of a replicated value, stays
as it is), and never changes values. ``replicated(x, like)`` lifts a
tensor the model builds itself (positions, masks, the vocab mask) onto
the mesh of the DTensor it meets, so plain tensors and DTensors never
meet in one op; beside a plain tensor it returns ``x``, and nothing on
the unsharded path becomes a DTensor.

Where the JAX package has a ``NamedSharding``, the port has
:class:`NamedSharding` (the mesh, the spec and its placements); trees are
the port's dicts, lists and tuples, with :class:`Axes` leaves.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional, Sequence, Union

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.optim.adamw import tree_leaves

Logical = Union[str, None, tuple]

# default rules: logical name -> mesh axis (str) or tuple of mesh axes
DEFAULT_RULES: tuple[tuple[str, Union[str, tuple, None]], ...] = (
    ("batch", ("pod", "data")),
    ("seq", None),
    ("seq_sp", "model"),        # sequence-parallel residual stream
    ("kv_seq", None),           # decode KV cache sequence dim
    ("kv_seq_dp", ("pod", "data")),  # long-context batch=1: shard cache seq over data
    ("embed", None),
    ("embed_fsdp", "data"),     # FSDP: weights' embed dim over data
    ("heads", "model"),
    ("kv_heads", "model"),
    ("head_dim", None),
    ("ffn", "model"),
    ("experts", "model"),
    ("vocab", "model"),
    ("ssm_inner", "model"),
    ("ssm_heads", "model"),
    ("ssm_state", None),
    ("conv_dim", "model"),
    ("layers", None),
    ("stream", ("pod", "data")),  # batched DGNN streams
    ("node", None),
    ("feat", "model"),          # wide-DGNN feature dim
)


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: dict = dict(DEFAULT_RULES)


_CTX = _Ctx()


@contextmanager
def sharding_ctx(mesh, rules: Optional[dict] = None):
    """Make ``mesh`` (and ``rules``) current on this thread."""
    old_mesh, old_rules = _CTX.mesh, _CTX.rules
    _CTX.mesh = mesh
    _CTX.rules = dict(DEFAULT_RULES) if rules is None else dict(rules)
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = old_mesh, old_rules


def current_mesh():
    return _CTX.mesh


def mesh_axis_sizes(mesh) -> dict:
    """{axis name: size} of a mesh (a ``DeviceMesh``, or anything with its
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _mesh_axes_size(mesh, axes: Union[str, tuple, None]) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_axis_sizes(mesh)
    size = 1
    for a in axes:
        size *= sizes.get(a, 1)
    return size


def resolve_spec(shape: Sequence[int], names: Sequence[Logical],
                 mesh=None, rules: Optional[dict] = None) -> tuple:
    """Logical names -> the PartitionSpec entries (a tuple, one a dim), with
    the divisibility fallback."""
    mesh = mesh or _CTX.mesh
    rules = rules or _CTX.rules
    if len(shape) != len(names):
        raise ValueError(f"shape {tuple(shape)} has {len(shape)} dims, "
                         f"names {tuple(names)} {len(names)}")
    entries = []
    for dim, name in zip(shape, names):
        if name is None:
            entries.append(None)
            continue
        axes = rules.get(name)
        if axes is None:
            entries.append(None)
            continue
        if mesh is not None:
            sz = _mesh_axes_size(mesh, axes)
            if sz == 1 or dim % sz != 0:
                entries.append(None)
                continue
            # drop mesh axes the mesh lacks
            present = set(mesh.mesh_dim_names)
            axes_t = (axes,) if isinstance(axes, str) else tuple(axes)
            axes_t = tuple(a for a in axes_t if a in present)
            if not axes_t:
                entries.append(None)
                continue
            entries.append(axes_t[0] if len(axes_t) == 1 else axes_t)
        else:
            entries.append(axes if isinstance(axes, str) else tuple(axes))
    return tuple(entries)


def placements(spec: Sequence, mesh) -> tuple:
    """DTensor placements of a resolved spec, one a mesh dim: ``Shard(d)``
    where tensor dim d names the mesh axis, else ``Replicate()``. A dim
    over a tuple of axes is split major to minor in the mesh's order, as a
    JAX PartitionSpec tuple is."""
    out = []
    for axis in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a resolved spec (the JAX ``NamedSharding``)."""

    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def distribute(x: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """``x``, this rank's copy of a value replicated over the mesh, as a
    DTensor with the sharding's placements: each rank keeps its own slice,
    nothing is sent."""
    mesh = sharding.mesh
    rep = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    return rep.redistribute(mesh, sharding.placements)


def shard(x, *names: Logical):
    """``x`` with the sharding the rules give its logical axes: a DTensor
    is redistributed over the current mesh; with no current mesh, or for a
    plain tensor (this rank's whole copy of a replicated value: a model
    whose parameters are plain runs replicated under a mesh, as before
    its parameters are distributed), ``x`` itself."""
    mesh = _CTX.mesh
    if mesh is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, named_sharding(x.shape, names,
                                               mesh).placements)


def replicated(x, like):
    """``x``, a tensor the model built itself, beside the tensor ``like``
    it meets: where ``like`` is a DTensor, ``x`` as a DTensor replicated
    over ``like``'s mesh (this rank's copy of the value, nothing sent);
    else ``x`` itself. Keyed to the operand, not to the current mesh: a
    rank's local work under a mesh (``local_map``, the expert-parallel
    body) stays plain, and so does a recompute on autograd's thread."""
    if isinstance(x, DTensor) or not isinstance(like, DTensor):
        return x
    mesh = like.device_mesh
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def in_current_ctx(fn):
    """``fn`` bound to the current mesh and rules: a checkpointed layer's
    recompute runs on autograd's thread (the card's), where the
    thread-local context is empty, and must shard as its forward did."""
    mesh, rules = _CTX.mesh, _CTX.rules
    if mesh is None:
        return fn

    def bound(*args, **kwargs):
        with sharding_ctx(mesh, rules):
            return fn(*args, **kwargs)
    return bound


def gather_fsdp(w, *names: Logical):
    """A weight as its product takes it: with its FSDP dim
    ("embed_fsdp") gathered over 'data' (ZeRO-3, in the weight's dtype:
    cast first) and its other dims as ``names`` say. Without a mesh, or
    where "embed_fsdp" maps to nothing, no data moves. Each product
    gathers its weight so, rather than leave DTensor to pick between
    gathering the weight and gathering the batch."""
    return shard(w, *(None if n == "embed_fsdp" else n for n in names))


def local_tensor(x):
    """The tensor this rank holds: a DTensor's local shard, or ``x``."""
    return x.to_local() if isinstance(x, DTensor) else x


def named_sharding(shape: Sequence[int], names: Sequence[Logical],
                   mesh=None) -> NamedSharding:
    mesh = mesh or _CTX.mesh
    if mesh is None:
        raise ValueError("named_sharding needs a mesh (pass one, or enter "
                         "sharding_ctx)")
    return NamedSharding(mesh, resolve_spec(shape, names, mesh))


class Axes:
    """Logical-axis annotation leaf (opaque to tree traversal)."""

    __slots__ = ("names",)

    def __init__(self, *names: Logical):
        self.names = tuple(names)

    def __repr__(self) -> str:
        return f"Axes{self.names}"

    def __eq__(self, other):
        return isinstance(other, Axes) and self.names == other.names

    def __hash__(self):
        return hash(self.names)


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure whose leaves come, in ``tree_leaves``
    order (dict keys sorted, as the JAX package flattens), from the
    iterator ``leaves``."""
    if isinstance(tree, dict):
        got = {k: tree_unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: got[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_unflatten(v, leaves) for v in tree)
    return next(leaves)


def tree_map2(fn, tree, other):
    """``fn(leaf, other_leaf)`` over two trees of one structure (dicts,
    lists, tuples); ``other``'s leaves may be :class:`Axes`."""
    if isinstance(tree, dict):
        return {k: tree_map2(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        if len(tree) != len(other):
            raise ValueError(f"tree of {len(tree)} entries against "
                             f"{len(other)}")
        return type(tree)(tree_map2(fn, a, b) for a, b in zip(tree, other))
    return fn(tree, other)


def tree_shardings(tree_shapes, tree_axes, mesh=None):
    """A tree of tensors (or anything with a ``shape``) and a matching tree
    of ``Axes`` leaves -> a tree of :class:`NamedSharding`."""
    mesh = mesh or _CTX.mesh
    return tree_map2(lambda shp, ax: named_sharding(shp.shape, ax.names, mesh),
                     tree_shapes, tree_axes)


def local_block(x: torch.Tensor, spec: Sequence, mesh) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec`` (a resolved spec): a
    DTensor redistributed to the spec's placements, a plain tensor taken as
    this rank's copy of a replicated value; its local shard."""
    sh = NamedSharding(mesh, tuple(spec))
    if isinstance(x, DTensor):
        return x.redistribute(mesh, sh.placements).to_local()
    return distribute(x, sh).to_local()
