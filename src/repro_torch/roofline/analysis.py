"""Roofline terms of a traced step on the NVIDIA H100 SXM (the
counterpart of ``repro.roofline.analysis``).

compute term    = FLOPs      / peak_FLOP/s
memory term     = bytes      / HBM bandwidth
collective term = coll_bytes / link bandwidth

All three inputs are PER DEVICE. There is no compiled HLO to read: a
:class:`CostCounter` (a ``TorchDispatchMode``) watches the ops that run
under it and counts them on the tensors each rank holds, so a DTensor
program is counted on its local shards (a mode that read the DTensor ops
themselves would count the global shapes):

* FLOPs: the matrix products and convolutions, by
  ``torch.utils.flop_counter``'s formulas (XLA's count also has the
  elementwise ops; the products are what the tensor cores bound);
* bytes: every op's inputs plus outputs, views excluded, which is what
  XLA's "bytes accessed" sums (without XLA's fusion: an elementwise chain
  counts each step's traffic);
* collectives: the operand bytes of each ``_c10d_functional`` op (what
  DTensor issues) and each ``c10d`` op (``torch.distributed`` called
  directly, as the expert-parallel MoE's ``all_to_all``), under the JAX
  package's five names;
* a peak estimate: the most bytes the live outputs of counted ops held at
  once (with fake tensors nothing is allocated, so this is an estimate).

Hardware constants, one H100 SXM5 80 GB card (NVIDIA's H100 datasheet):
989 TFLOP/s dense bf16 tensor-core peak, 3.35 TB/s HBM3, and 450 GB/s
each way over NVLink 4 (18 links of 25 GB/s a direction). A mesh larger
than one 8-card host crosses InfiniBand between hosts (400 Gb/s, 50 GB/s,
a card with one NDR adapter), so its collective term is a lower bound.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

PEAK_FLOPS = 989e12     # bf16 dense, per card
HBM_BW = 3.35e12        # bytes/s per card
NVLINK_BW = 450e9       # bytes/s per card, each way

COLLECTIVE_OPS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# op name (the overload packet's name, namespace dropped) -> JAX's name
_COLLECTIVE_NAMES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "send": "collective-permute",
    "recv_": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d")
# ops that move no bytes: allocations without a fill, a collective's wait
_NO_TRAFFIC = (torch.ops.aten.empty, torch.ops.aten.empty_like,
               torch.ops.aten.empty_strided, torch.ops.aten.new_empty,
               torch.ops.aten.new_empty_strided,
               torch.ops._c10d_functional.wait_tensor)


def cost_analysis_dict(counter: "CostCounter") -> dict:
    """A counter's totals under XLA's ``cost_analysis`` keys: "flops" and
    "bytes accessed", per device."""
    return {"flops": float(counter.flops),
            "bytes accessed": float(counter.bytes)}


@dataclass
class CollectiveStats:
    bytes_by_op: dict = field(default_factory=dict)
    count_by_op: dict = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())

    def add(self, op: str, nbytes: int) -> None:
        self.bytes_by_op[op] = self.bytes_by_op.get(op, 0) + nbytes
        self.count_by_op[op] = self.count_by_op.get(op, 0) + 1


def collective_bytes(counter: "CostCounter") -> CollectiveStats:
    """The operand bytes of the collectives that ran under ``counter``."""
    return counter.collectives


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class CostCounter(TorchDispatchMode):
    """Per-device FLOPs, bytes, collectives and live bytes of the ops that
    run under it (see the module docstring). A DTensor op is handed back
    to DTensor (``NotImplemented``), whose local ops then come here.

    ``device`` (a type, e.g. "cuda" or "meta") counts only the ops on
    tensors of that device: DTensor's sharding propagation computes on
    small host tensors of its own, which are not the step's work."""

    def __init__(self, device=None):
        super().__init__()
        self.device = None if device is None else torch.device(device).type
        self.flops = 0
        self.bytes = 0
        self.collectives = CollectiveStats()
        self.live = 0
        self.peak = 0

    def track(self, tensors) -> None:
        """Count ``tensors`` (a step's arguments, local shards) as live
        bytes for the rest of the count."""
        for t in _tensors(tensors):
            self.live += _nbytes(t.to_local() if isinstance(t, DTensor) else t)
        self.peak = max(self.peak, self.live)

    def _hold(self, t) -> None:
        n = _nbytes(t)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._release, n)

    def _release(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        tensors = _tensors((args, kwargs))
        if self.device is not None and not any(
                t.device.type == self.device for t in tensors):
            return out
        packet = func.overloadpacket
        ns = func.namespace
        if ns in _COLLECTIVE_NAMESPACES:
            name = packet.__name__
            if name in _COLLECTIVE_NAMES:
                ins = _tensors(args[:1]) if ns == "_c10d_functional" \
                    else _tensors(args[0] if name != "alltoall_base_"
                                  else args[1])
                self.collectives.add(_COLLECTIVE_NAMES[name],
                                     sum(_nbytes(t) for t in ins))
            return out
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if not func.is_view and packet not in _NO_TRAFFIC:
            ins, outs = tensors, _tensors(out)
            self.bytes += sum(_nbytes(t) for t in ins + outs)
            for t in outs:
                if not any(t is a for a in ins):  # an in-place op's input
                    self._hold(t)
        return out


@dataclass
class Roofline:
    """All byte/flop inputs are PER-DEVICE (counted on each rank's local
    shards); ``model_flops`` is the GLOBAL analytic useful work."""

    flops: float          # per-device FLOPs (+ per-device corrections)
    bytes_hbm: float      # per-device bytes accessed
    bytes_coll: float     # per-device collective operand bytes
    chips: int
    model_flops: float = 0.0  # global

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_hbm / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.bytes_coll / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs — remat/padding/dispatch waste
        detector."""
        if not self.flops:
            return 0.0
        return (self.model_flops / self.chips) / self.flops

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved when running at the
        bound: useful model FLOPs / (peak * bound-time), per device."""
        t = self.t_bound
        if t <= 0:
            return 0.0
        return (self.model_flops / self.chips) / (PEAK_FLOPS * t)

    def to_dict(self) -> dict:
        return {
            "flops": self.flops, "bytes_hbm": self.bytes_hbm,
            "bytes_coll": self.bytes_coll, "chips": self.chips,
            "model_flops": self.model_flops,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "bottleneck": self.bottleneck,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops(cfg, shape) -> float:
    """Analytic useful FLOPs per step: 6ND train / 2ND inference (+ exact
    quadratic attention and SSD terms, which dominate at 32k+)."""
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (1 if shape.is_decode else shape.seq_len)
    mult = 6 if shape.kind == "train" else 2
    base = mult * n_active * tokens
    # attention quadratic term: 2*2*hd*(Hq)*sum_over_queries(kv_len)
    attn_layers = sum(1 for mx, _ in cfg.layer_kinds() if mx == "attn")
    if attn_layers:
        hd, hq = cfg.resolved_head_dim, cfg.n_heads
        if shape.is_decode:
            kv_per_q = shape.seq_len
            qtok = shape.global_batch
        else:
            kv_per_q = shape.seq_len / 2  # causal average
            qtok = tokens
        attn = (mult / 1.5 if shape.kind == "train" else 2) * 2 * hd * hq * kv_per_q * qtok * attn_layers
        base += attn
    # SSD state term: per token 2*d_inner*N (state update) + 2*d_inner*N (out)
    ssm_layers = sum(1 for mx, _ in cfg.layer_kinds() if mx == "ssm")
    if ssm_layers:
        base += mult * 2 * cfg.d_inner * cfg.ssm_state * tokens * ssm_layers
    return float(base)
