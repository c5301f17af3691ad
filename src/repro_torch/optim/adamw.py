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
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

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


def quantize_blockwise(x: torch.Tensor) -> dict:
    """int8 absmax quantization in blocks along the LAST axis: q keeps x's
    shape (int8), scale is x.shape[:-1] + (last / block,) float32."""
    if x.dim() == 0:
        x = x[None]
    block = _block_for(x.shape[-1])
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


def _encode(x: torch.Tensor, dtype: str, moment: str):
    if dtype == "fp32":
        return x.float()
    if dtype == "bf16" or moment == "v":
        # int8 mode keeps v in bf16: its dynamic range breaks absmax int8
        return x.to(torch.bfloat16)
    return quantize_blockwise(x)


def _decode(s, dtype: str, shape, moment: str) -> torch.Tensor:
    if dtype in ("fp32", "bf16") or moment == "v":
        return s.float()
    return dequantize_blockwise(s, shape)


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
    zeros = lambda p: torch.zeros(p.shape, device=p.device)
    return {"m": [_encode(zeros(p), cfg.state_dtype, "m") for p in leaves],
            "v": [_encode(zeros(p), cfg.state_dtype, "v") for p in leaves],
            "step": torch.zeros((), dtype=torch.int32)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (no temporary of a
    leaf's size)."""
    norms = [torch.linalg.vector_norm(t, dtype=torch.float32)
             for t in tree_leaves(tree)]
    return torch.linalg.vector_norm(torch.stack(norms))


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
    objects; metrics {"grad_norm", "lr", "step"}."""
    step = opt_state["step"] + 1
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
    for p, g, m_s, v_s in zip(p_leaves, g_leaves, opt_state["m"],
                              opt_state["v"]):
        for sl in _pieces(p):
            pp, ms, vs = p[sl], _piece(m_s, sl), _piece(v_s, sl)
            gs = g[sl].float() * scale
            m = cfg.b1 * _decode(ms, sd, pp.shape, "m") + (1 - cfg.b1) * gs
            v = cfg.b2 * _decode(vs, sd, pp.shape, "v") + (
                (1 - cfg.b2) * gs * gs)
            del gs
            delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
            delta = delta + cfg.weight_decay * pp.float()
            pp.copy_(pp.float() - lr * delta)
            del delta
            _store(ms, _encode(m, sd, "m"))
            _store(vs, _encode(v, sd, "v"))
    opt_state["step"] = step
    metrics = {"grad_norm": gnorm, "lr": torch.tensor(lr), "step": step}
    return params, opt_state, metrics
