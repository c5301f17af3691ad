"""AdamW with optional quantized moments (the counterpart of
``repro.optim.adamw``).

``state_dtype``:
  fp32   exact moments (default).
  bf16   half-cost moments.
  int8   the first moment as blockwise int8 codes with per-block absmax
         scales (blocks of up to 256 along the last axis), the second
         moment bf16.

The state holds FLAT LISTS in the order of ``tree_leaves(params)``, which
is the JAX package's order of leaves (dict keys sorted, lists in order),
so a JAX state carries across leaf by leaf (``params.opt_state_from_jax``)
and a checkpoint has the JAX package's key paths. ``step`` is a host-side
int32 scalar: the schedule is read without a device sync.

Where the JAX package donates its buffers, the port updates in place:
``apply_updates`` writes the new parameters and moments into the tensors
it was given, in pieces of at most ``CHUNK`` elements along a leaf's
leading axis (one layer of a stacked leaf, as the JAX package streams
leaves of over 1e8 elements over their layer axis), so the fp32
temporaries of the update stay near one piece's size. The update is
elementwise and the int8 blocks lie along the last axis, so the pieces
give the whole leaf's result.

DTensor parameters (the LM under a mesh) update on their local shards:
each rank runs the elementwise update on its block of the parameter, its
gradient (redistributed to the parameter's placements where they differ)
and its moments; ``global_norm`` reduces over the mesh. The int8 first
moment keeps the unsharded leaf's blocks (``_block_for`` of the global
last dim): where the last dim is sharded and the blocks fall inside each
rank's slice, each rank quantizes its own blocks and its scale is its
slice of the scale; where a block crosses ranks (the scale's last dim is
then replicated), each rank takes its elements' partial absmax a block,
and one MAX all-reduce over the sharding mesh dims gives every rank the
whole scale. Nothing is all-gathered.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

_BLOCK = 256
#: the most elements ``apply_updates`` updates at once
CHUNK = 1 << 25


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "fp32"  # fp32 | bf16 | int8
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


_STATE_DTYPES = ("fp32", "bf16", "int8")


def tree_leaves(tree) -> list:
    """The tensors of a tree of dicts and lists, in the JAX package's
    flatten order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_ratio``, in float32 (a
    0-d CPU tensor)."""
    s = torch.as_tensor(step).to(torch.float32).cpu()
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


# ---------------------------------------------------------- quantization ----


def _block_for(last_dim: int) -> int:
    """Largest divisor of last_dim that is <= _BLOCK (axis-preserving)."""
    b = min(last_dim, _BLOCK)
    while last_dim % b:
        b -= 1
    return max(b, 1)


def quantize_blockwise(x: torch.Tensor, block: int | None = None) -> dict:
    """int8 absmax quantization in blocks along the LAST axis: q keeps x's
    shape (int8), scale is x.shape[:-1] + (last / block,) float32.
    ``block`` defaults to ``_block_for`` of the last dim."""
    if x.dim() == 0:
        x = x[None]
    block = _block_for(x.shape[-1]) if block is None else block
    nb = x.shape[-1] // block
    xb = x.float().reshape(*x.shape[:-1], nb, block)
    scale = torch.clamp_min(xb.abs().amax(dim=-1) / 127.0, 1e-12)
    q = torch.clamp(torch.round(xb / scale[..., None]), -127, 127)
    return {"q": q.to(torch.int8).reshape(x.shape), "scale": scale}


def dequantize_blockwise(qd: dict, shape) -> torch.Tensor:
    q, scale = qd["q"], qd["scale"]
    nb = scale.shape[-1]
    xb = q.float().reshape(*q.shape[:-1], nb, q.shape[-1] // nb)
    return (xb * scale[..., None]).reshape(shape)


@dataclass(frozen=True)
class _Blocks:
    """Where a rank's slice of a leaf's last dim lies among the unsharded
    leaf's int8 blocks: ``crossing`` when a block spans ranks (then
    ``ids``, each local column's global block, and ``groups``, the mesh
    groups that split the last dim, serve the MAX all-reduce)."""

    block: int
    crossing: bool = False
    ids: object = None
    n_blocks: int = 0
    groups: tuple = ()


def _quantize(x: torch.Tensor, lay) -> dict:
    if lay is None or not lay.crossing:
        return quantize_blockwise(x, None if lay is None else lay.block)
    ax = x.float().abs()
    part = torch.zeros((*x.shape[:-1], lay.n_blocks), device=x.device)
    part = part.scatter_reduce(-1, lay.ids.expand_as(ax), ax, "amax")
    for g in lay.groups:
        dist.all_reduce(part, op=dist.ReduceOp.MAX, group=g)
    scale = torch.clamp_min(part / 127.0, 1e-12)
    q = torch.clamp(torch.round(x.float() / scale[..., lay.ids]), -127, 127)
    return {"q": q.to(torch.int8), "scale": scale}


def _dequantize(qd: dict, shape, lay) -> torch.Tensor:
    if lay is None or not lay.crossing:
        return dequantize_blockwise(qd, shape)
    return (qd["q"].float() * qd["scale"][..., lay.ids]).reshape(shape)


def _blocks(p) -> "_Blocks | None":
    """The int8 block layout of leaf ``p``'s local slice (None: a plain
    tensor, its own blocks)."""
    if not isinstance(p, DTensor):
        return None
    last = p.dim() - 1
    full = p.shape[-1]
    block = _block_for(full)
    local = p.to_local().shape[-1]
    if local == full:
        return _Blocks(block)
    if local % block == 0:
        return _Blocks(block)
    mesh, coord = p.device_mesh, p.device_mesh.get_coordinate()
    offset, groups = 0, []
    for i, pl in enumerate(p.placements):
        if isinstance(pl, Shard) and pl.dim == last:
            offset = offset * mesh.size(i) + coord[i]
            groups.append(mesh.get_group(i))
    offset *= local
    ids = (offset + torch.arange(local, device=p.to_local().device)) // block
    return _Blocks(block, True, ids, full // block, tuple(groups))


def _encode(x: torch.Tensor, dtype: str, moment: str, lay=None):
    if dtype == "fp32":
        return x.float()
    if dtype == "bf16" or moment == "v":
        # int8 mode keeps v in bf16: its dynamic range breaks absmax int8
        return x.to(torch.bfloat16)
    return _quantize(x, lay)


def _decode(s, dtype: str, shape, moment: str, lay=None) -> torch.Tensor:
    if dtype in ("fp32", "bf16") or moment == "v":
        return s.float()
    return _dequantize(s, shape, lay)


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _lift(local: torch.Tensor, like, shape) -> torch.Tensor:
    """``local`` as a DTensor of global ``shape`` with ``like``'s mesh and
    placements; ``local`` itself where ``like`` is a plain tensor."""
    if not isinstance(like, DTensor):
        return local
    return DTensor.from_local(local, like.device_mesh, like.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _store(dst, src) -> None:
    """Write an encoded moment into its state tensors in place."""
    if isinstance(dst, dict):
        dst["q"].copy_(src["q"].reshape(dst["q"].shape))
        dst["scale"].copy_(src["scale"].reshape(dst["scale"].shape))
    else:
        dst.copy_(src)


# -------------------------------------------------------------- adamw ----


def init_opt_state(params, cfg: AdamWConfig) -> dict:
    """Zero moments beside each parameter leaf (on its device), in
    ``tree_leaves`` order, and step 0."""
    if cfg.state_dtype not in _STATE_DTYPES:
        raise ValueError(f"state_dtype {cfg.state_dtype!r}: one of "
                         f"{_STATE_DTYPES}")
    leaves = tree_leaves(params)
    return {"m": [_zero_moment(p, cfg.state_dtype, "m") for p in leaves],
            "v": [_zero_moment(p, cfg.state_dtype, "v") for p in leaves],
            "step": torch.zeros((), dtype=torch.int32)}


def _zero_moment(p, dtype: str, moment: str):
    """A zero moment beside leaf ``p``: for a DTensor leaf each rank's
    block (the int8 scale sharded where its blocks are, else whole)."""
    local = torch.zeros(_local(p).shape, device=_local(p).device)
    lay = _blocks(p)
    enc = _encode(local, dtype, moment, lay)
    if not isinstance(enc, dict):
        return _lift(enc, p, p.shape)
    scale_shape = (*p.shape[:-1], p.shape[-1] // _block_for(p.shape[-1]))
    if lay is None or not lay.crossing:
        scale = _lift(enc["scale"], p, scale_shape)
    else:
        # a block spans ranks: the scale's last dim is whole on each
        last = p.dim() - 1
        pl = [Replicate() if isinstance(x, Shard) and x.dim == last else x
              for x in p.placements]
        scale = DTensor.from_local(enc["scale"], p.device_mesh, pl,
                                   run_check=False,
                                   shape=torch.Size(scale_shape),
                                   stride=_contiguous_stride(scale_shape))
    return {"q": _lift(enc["q"], p, p.shape), "scale": scale}


def opt_state_axes(params_axes, cfg: AdamWConfig) -> dict:
    """Logical-axis tree matching init_opt_state's structure.

    int8 moments inherit the param's axes (q keeps the shape; scale keeps
    the leading dims, last dim axis dropped to None — divisibility fallback
    covers the blocked tail).
    """
    from repro_torch.distributed.api import Axes

    leaves = _axes_leaves(params_axes)

    def one(ax: "Axes", moment: str):
        names = ax.names if len(ax.names) else (None,)
        if cfg.state_dtype in ("fp32", "bf16") or moment == "v":
            return Axes(*names)
        return {"q": Axes(*names), "scale": Axes(*names)}

    ms = [one(a, "m") for a in leaves]
    vs = [one(a, "v") for a in leaves]
    return {"m": ms, "v": vs, "step": Axes()}


def _axes_leaves(tree) -> list:
    """The ``Axes`` leaves of a tree in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _axes_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _axes_leaves(v)]
    return [tree]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (no temporary of a
    leaf's size); a DTensor leaf's norm is reduced over its mesh."""
    norms = [_full(torch.linalg.vector_norm(t, dtype=torch.float32))
             for t in tree_leaves(tree)]
    return torch.linalg.vector_norm(torch.stack(norms))


def _full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def _pieces(p: torch.Tensor) -> list:
    """Slices of a leaf's leading axis of at most CHUNK elements each (the
    whole leaf, ``...``, where it has fewer than two axes)."""
    if p.dim() < 2 or p.numel() <= CHUNK:
        return [...]
    rows = max(1, CHUNK // (p.numel() // p.shape[0]))
    return [slice(r, r + rows) for r in range(0, p.shape[0], rows)]


def _piece(state, sl):
    if isinstance(state, dict):
        return {k: v[sl] for k, v in state.items()}
    return state[sl]


@torch.no_grad()
def apply_updates(params, grads, opt_state, cfg: AdamWConfig):
    """One AdamW step with global-norm clipping, IN PLACE: the parameter
    leaves and the moments of ``opt_state`` are overwritten (where the JAX
    package donates them). Returns (params, opt_state, metrics), the same
    objects; metrics {"grad_norm", "lr", "step"}. DTensor leaves update
    on their local shards."""
    step = _local(opt_state["step"]) + 1
    lr = float(schedule(cfg, step))
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9),
                        max=1.0)
    stepf = step.to(torch.float32)
    b1c = float(1 - cfg.b1 ** stepf)
    b2c = float(1 - cfg.b2 ** stepf)
    p_leaves, g_leaves = tree_leaves(params), tree_leaves(grads)
    if len(p_leaves) != len(g_leaves) or len(p_leaves) != len(opt_state["m"]):
        raise ValueError(f"{len(p_leaves)} parameters, {len(g_leaves)} "
                         f"grads, {len(opt_state['m'])} moments")
    sd = cfg.state_dtype
    for p_t, g_t, m_t, v_t in zip(p_leaves, g_leaves, opt_state["m"],
                                  opt_state["v"]):
        lay = _blocks(p_t)
        if isinstance(p_t, DTensor) and isinstance(g_t, DTensor) \
                and g_t.placements != p_t.placements:
            g_t = g_t.redistribute(p_t.device_mesh, p_t.placements)
        p, g = _local(p_t), _local(g_t)
        m_s = ({k: _local(v) for k, v in m_t.items()}
               if isinstance(m_t, dict) else _local(m_t))
        v_s = _local(v_t)
        for sl in _pieces(p):
            pp, ms, vs = p[sl], _piece(m_s, sl), _piece(v_s, sl)
            gs = g[sl].float() * scale
            m = cfg.b1 * _decode(ms, sd, pp.shape, "m", lay) + (
                (1 - cfg.b1) * gs)
            v = cfg.b2 * _decode(vs, sd, pp.shape, "v") + (
                (1 - cfg.b2) * gs * gs)
            del gs
            delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
            delta = delta + cfg.weight_decay * pp.float()
            pp.copy_(pp.float() - lr * delta)
            del delta
            _store(ms, _encode(m, sd, "m", lay))
            _store(vs, _encode(v, sd, "v"))
    opt_state["step"] = step
    metrics = {"grad_norm": gnorm, "lr": torch.tensor(lr), "step": step}
    return params, opt_state, metrics
