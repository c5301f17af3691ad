"""Public kernel entry points of the port.

Per-step ops (levels baseline / o1 / v1 / v2): ``ell_spmm`` (the
message-passing stage of ``impl="pallas"``), ``dgnn_fused_step`` (GCRN V2)
and ``stacked_fused_step`` (stacked V2), each with the JAX package's
signature. Stream engine (level v3): one pair of entry points,
``stream_steps`` / ``stream_steps_batched``, dispatched by family name as
in the JAX package. This layer owns what surrounds the kernels: moving the
arguments to the device, the global-row table, the evolve pack/unpack
(``pack`` builds a stream kernel wrapper's inputs), ragged ``lengths``, and
the force-ref gate. Under ``force_ref=True`` the plain oracle
(kernels/ref.py) runs on the raw arguments and no kernel wrapper is
reached; otherwise the arguments are packed and handed to the kernel
wrapper (kernels/engine.py), which launches the CUDA kernel for CUDA
tensors and runs its plain version for CPU tensors.

Every family of the JAX registry is ported: the dense-snapshot families
(gcrn, stacked, evolve), the event-driven tgn (T counts event batches) and
the static static_gcn (T = 1, snapshots folded onto the batch axis).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.graph.padding import round_up
from repro_torch.kernels import engine as _engine
from repro_torch.kernels import ref as _ref

# time semantics of every family of the JAX stream-engine registry
_TEMPORAL = {"gcrn": "dense", "stacked": "dense", "evolve": "dense",
             "tgn": "event", "static_gcn": "static"}

RESIDENCY_MODES = ("vmem", "hbm_paged")
BUFFER_DEPTHS = (1, 2, 4)


def stream_families() -> tuple:
    """Families of the stream-engine registry (the JAX package's set)."""
    return tuple(sorted(_TEMPORAL))


def family_temporal(family: str) -> str:
    """The family's time semantics: "dense" | "event" | "static"."""
    if family not in _TEMPORAL:
        raise KeyError(f"unknown stream-engine family {family!r}; "
                       f"registered: {stream_families()}")
    return _TEMPORAL[family]


def resolve_device(device) -> torch.device:
    """A torch device for an entry point. CUDA is asked for by default and
    never replaced by the CPU: without a card this raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} but no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch path")
    return dev


def to_device(obj, device):
    """Arrays / tensors (or dicts, lists and tuples of them, or None) as
    torch tensors on ``device``, dtypes kept."""
    if obj is None:
        return None
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_device(o, device) for o in obj)
    t = obj if torch.is_tensor(obj) else torch.tensor(np.asarray(obj))
    return t.to(device)


def _pad_to(a, n2: int, axis: int, fill=0):
    """Pad ``a`` to ``n2`` entries along ``axis`` with a constant fill."""
    n = a.shape[axis]
    if n == n2:
        return a
    shape = list(a.shape)
    shape[axis] = n2 - n
    return torch.cat([a, a.new_full(shape, fill)], dim=axis)


def check_renumber(renumber, n_global: int) -> None:
    """Raise where a renumber table names a row past the store's
    ``n_global`` rows: a scatter would drop it (the JAX package's
    ``mode="drop"``) or, in a kernel, take it for the drop sentinel, and
    the row would be lost without a word."""
    if n_global >= 2 ** 31:
        raise ValueError(f"n_global={n_global} does not fit int32 row ids")
    if renumber.numel() and int(renumber.max()) >= n_global:
        raise ValueError(f"renumber holds row {int(renumber.max())}, past "
                         f"the store's n_global={n_global} rows")


def _row_index_table(renumber, n_global: int):
    """Global row of each local node, ``n_global`` (the drop sentinel) on
    padding rows (renumber < 0), as int32 whatever the renumber table's
    integer type. A renumber past the store raises: the kernel would
    read it as the drop sentinel and lose the row without a word.

    The JAX engine also builds a global id per ELL lane (``neigh_gidx``)
    because it aggregates straight out of the store; the CUDA kernel
    gathers each step's rows first and aggregates over local ids, so the
    row table is all it needs."""
    check_renumber(renumber, n_global)
    return torch.where(renumber >= 0, renumber,
                       torch.full_like(renumber, n_global)).to(torch.int32)


def _i32(a):
    return a.to(torch.int32).contiguous()


def _contig(a):
    return None if a is None else a.contiguous()


# ----------------------------------------------------------- per-step ----
# ``tn`` is the TPU kernels' node tile: accepted for the JAX signature; the
# CUDA kernels take any node count and compute the same function for any tn.

def ell_spmm(neigh_idx, neigh_coef, neigh_eidx, x, edge_msg=None, *,
             tn: int = 128, force_ref: bool = False):
    """agg[v] = sum_k coef[v,k] * (x[idx[v,k]] + edge_msg[eidx[v,k]]); any
    leading axes are shared by every argument (one launch for all)."""
    del tn
    if force_ref:
        return _ref.ell_spmm(neigh_idx, neigh_coef, neigh_eidx, x, edge_msg)
    return _engine.ell_spmm(_i32(neigh_idx), neigh_coef.contiguous(),
                            _i32(neigh_eidx), x.contiguous(),
                            _contig(edge_msg))


def dgnn_fused_step(neigh_idx, neigh_coef, neigh_eidx, x, h, c, wx, wh, b,
                    edge_msg=None, *, tn: int = 128, force_ref: bool = False):
    """GCRN-M2 V2 step: ELL-aggregate x and h, gate transform, LSTM update.
    Returns (h', c'), unmasked."""
    del tn
    if force_ref:
        return _ref.dgnn_fused_step(neigh_idx, neigh_coef, neigh_eidx, x, h,
                                    c, wx, wh, b, edge_msg)
    return _engine.gcrn_step(
        _i32(neigh_idx), neigh_coef.contiguous(), _i32(neigh_eidx),
        x.contiguous(), h.contiguous(), c.contiguous(), wx.contiguous(),
        wh.contiguous(), b.contiguous(), _contig(edge_msg))


def stacked_fused_step(neigh_idx, neigh_coef, neigh_eidx, x, h, w_gcn, b_gcn,
                       wx, wh, b, edge_msg=None, *, tn: int = 128,
                       force_ref: bool = False):
    """Stacked-DGNN V2 step: ELL-aggregate, linear node transform, GRU
    against each node's own h. Returns h', unmasked."""
    del tn
    if force_ref:
        return _ref.stacked_fused_step(neigh_idx, neigh_coef, neigh_eidx, x,
                                       h, w_gcn, b_gcn, wx, wh, b, edge_msg)
    return _engine.stacked_step(
        _i32(neigh_idx), neigh_coef.contiguous(), _i32(neigh_eidx),
        x.contiguous(), h.contiguous(), w_gcn.contiguous(),
        b_gcn.contiguous(), wx.contiguous(), wh.contiguous(), b.contiguous(),
        _contig(edge_msg))


# ------------------------------------------------------------- stream ----

def _gcrn_pack(neigh_idx, neigh_coef, neigh_eidx, node_feat, renumber,
               node_mask, h0, c0, wx, wh, b, edge_msg=None):
    """The GCRN kernel wrapper's inputs: int32 ids, the global-row table."""
    return (_i32(neigh_idx), neigh_coef.contiguous(), _i32(neigh_eidx),
            node_feat.contiguous(), _row_index_table(renumber, h0.shape[1]),
            node_mask.contiguous(), h0.contiguous(), c0.contiguous(),
            wx.contiguous(), wh.contiguous(), b.contiguous(),
            _contig(edge_msg))


def _stacked_pack(neigh_idx, neigh_coef, neigh_eidx, node_feat, renumber,
                  node_mask, h0, w_gcn, b_gcn, wx, wh, b, edge_msg=None):
    """The stacked kernel wrapper's inputs: int32 ids, the global-row
    table."""
    return (_i32(neigh_idx), neigh_coef.contiguous(), _i32(neigh_eidx),
            node_feat.contiguous(), _row_index_table(renumber, h0.shape[1]),
            node_mask.contiguous(), h0.contiguous(), w_gcn.contiguous(),
            b_gcn.contiguous(), wx.contiguous(), wh.contiguous(),
            b.contiguous(), _contig(edge_msg))


def _pad_matrix_gru_params(wx, wh, b, dmax: int):
    """Zero-pad square matrix-GRU cell params (din -> din) to dmax PER
    GATE BLOCK, so the padded cell splits its gates at dmax boundaries and
    the valid region evolves exactly as the unpadded cell; padded weight
    rows then evolve to zero (their gate inputs are identically zero)."""
    def pad_gates(m):
        return torch.cat([_pad_to(_pad_to(g, dmax, 0), dmax, 1)
                          for g in m.chunk(3, dim=1)], dim=1)

    return (pad_gates(wx), pad_gates(wh),
            torch.cat([_pad_to(g, dmax, 0) for g in b.chunk(3)]))


def _square_layers(weights, b_gcn, node_feat, edge_aggs, stack_dim: int):
    """Every GCN layer width padded into one common square ``dmax``
    (rounded up to the kernels' ``ROW_ALIGN``), as the JAX packs do: dmax,
    the weights stacked on ``stack_dim`` (dmax, dmax) each, the biases
    (L, dmax), the features (..., dmax) and the edge terms
    (..., L, n, dmax) or None."""
    dmax = round_up(max(max(w.shape[-2:]) for w in weights), _engine.ROW_ALIGN)
    eagg = None
    if edge_aggs is not None:
        eagg = torch.stack([_pad_to(ea, dmax, -1) for ea in edge_aggs],
                           dim=-3).contiguous()
    return (dmax,
            torch.stack([_pad_to(_pad_to(w, dmax, -2), dmax, -1)
                         for w in weights], dim=stack_dim).contiguous(),
            torch.stack([_pad_to(bb, dmax, 0) for bb in b_gcn]).contiguous(),
            _pad_to(node_feat, dmax, -1).contiguous(), eagg)


def _evolve_pack(neigh_idx, neigh_coef, node_feat, node_mask, live, weights,
                 b_gcn, gru_wx, gru_wh, gru_b, edge_aggs=None):
    """The EvolveGCN kernel wrapper's inputs: the common square layout of
    ``_square_layers`` with per-stream weights (B, L, dmax, dmax) and the
    matrix-GRU params padded per gate block."""
    dmax, w0, bg, x, eagg = _square_layers(weights, b_gcn, node_feat,
                                           edge_aggs, stack_dim=1)
    gwx, gwh, gb = zip(*[_pad_matrix_gru_params(wx, wh, bb, dmax)
                         for wx, wh, bb in zip(gru_wx, gru_wh, gru_b)])
    return (neigh_idx.to(torch.int32).contiguous(), neigh_coef.contiguous(),
            x, node_mask.contiguous(), live.to(torch.int32).contiguous(),
            w0, bg, torch.stack(gwx).contiguous(),
            torch.stack(gwh).contiguous(), torch.stack(gb).contiguous(), eagg)


def _gcrn_launch(batched, neigh_idx, neigh_coef, neigh_eidx, node_feat,
                 renumber, node_mask, h0, c0, wx, wh, b, edge_msg=None):
    """Pack + kernel wrapper for the integrated (GC-LSTM) family."""
    if not batched:
        em = None if edge_msg is None else edge_msg[None]
        outs, hT, cT = _gcrn_launch(
            True, neigh_idx[None], neigh_coef[None], neigh_eidx[None],
            node_feat[None], renumber[None], node_mask[None], h0[None],
            c0[None], wx, wh, b, em)
        return outs[0], hT[0], cT[0]
    return _engine.gcrn_engine(*_gcrn_pack(
        neigh_idx, neigh_coef, neigh_eidx, node_feat, renumber, node_mask,
        h0, c0, wx, wh, b, edge_msg))


def _stacked_launch(batched, neigh_idx, neigh_coef, neigh_eidx, node_feat,
                    renumber, node_mask, h0, w_gcn, b_gcn, wx, wh, b,
                    edge_msg=None):
    """Pack + kernel wrapper for the stacked (GCN -> GRU) family."""
    if not batched:
        em = None if edge_msg is None else edge_msg[None]
        outs, hT = _stacked_launch(
            True, neigh_idx[None], neigh_coef[None], neigh_eidx[None],
            node_feat[None], renumber[None], node_mask[None], h0[None],
            w_gcn, b_gcn, wx, wh, b, em)
        return outs[0], hT[0]
    return _engine.stacked_engine(*_stacked_pack(
        neigh_idx, neigh_coef, neigh_eidx, node_feat, renumber, node_mask,
        h0, w_gcn, b_gcn, wx, wh, b, edge_msg))


def _evolve_launch(batched, neigh_idx, neigh_coef, node_feat, node_mask,
                   live, weights, b_gcn, gru_wx, gru_wh, gru_b,
                   edge_aggs=None):
    """Pack + kernel wrapper for the weights-evolved family; returns
    outputs and per-layer weights sliced back to their true shapes."""
    if not batched:
        ea = None if edge_aggs is None else [a[None] for a in edge_aggs]
        outs, wT = _evolve_launch(
            True, neigh_idx[None], neigh_coef[None], node_feat[None],
            node_mask[None], live[None], [w[None] for w in weights], b_gcn,
            gru_wx, gru_wh, gru_b, ea)
        return outs[0], tuple(w[0] for w in wT)
    outs, wT = _engine.evolve_engine(*_evolve_pack(
        neigh_idx, neigh_coef, node_feat, node_mask, live, weights, b_gcn,
        gru_wx, gru_wh, gru_b, edge_aggs))
    dims = [w.shape[-2:] for w in weights]
    weights_T = tuple(wT[:, i, :di, :do] for i, (di, do) in enumerate(dims))
    return outs[..., :dims[-1][1]], weights_T


def _check_local_ids(neigh_idx, n: int) -> None:
    """Local ELL ids index the batch's own rows; the tgn pack looks each
    up in the renumber table, so an id outside [0, n) is refused first."""
    if neigh_idx.numel():
        lo, hi = torch.aminmax(neigh_idx)
        if int(lo) < 0 or int(hi) >= n:
            raise ValueError(f"neigh_idx ids span [{int(lo)}, {int(hi)}], "
                             f"outside [0, {n})")


def _partner_rows(renumber, neigh_idx):
    """Global row of each ELL lane's partner (row 0 where the partner is a
    padding row; such a lane carries coef 0), int32: the JAX package's
    ``neigh_gidx`` (``_stream_index_tables``)."""
    _check_local_ids(neigh_idx, neigh_idx.shape[-2])
    ren_safe = torch.where(renumber >= 0, renumber,
                           torch.zeros_like(renumber))
    flat = neigh_idx.reshape(*neigh_idx.shape[:-2], -1).long()
    return torch.gather(ren_safe, -1, flat).reshape(
        neigh_idx.shape).to(torch.int32).contiguous()


def _tgn_pack(neigh_idx, neigh_coef, neigh_ts, node_feat, renumber,
              node_mask, mem0, freq, w_in, wx, wh, b):
    """The TGN kernel wrapper's inputs: each lane's partner as a global row
    (the kernel reads partners straight from the memory store, as the
    Pallas cell does), the own-row table, float32 timestamps."""
    return (_partner_rows(renumber, neigh_idx), neigh_coef.contiguous(),
            neigh_ts.to(torch.float32).contiguous(), node_feat.contiguous(),
            _row_index_table(renumber, mem0.shape[1]),
            node_mask.contiguous(), mem0.contiguous(), freq.contiguous(),
            w_in.contiguous(), wx.contiguous(), wh.contiguous(),
            b.contiguous())


def _tgn_launch(batched, neigh_idx, neigh_coef, neigh_ts, node_feat,
                renumber, node_mask, mem0, freq, w_in, wx, wh, b):
    """Pack + kernel wrapper for the event-stream (TGN) family. The T axis
    sequences event batches (graph/events.pad_event_block); ``neigh_ts``
    carries each lane's timestamp in the slot the dense families use for
    edge ids, zero on dead lanes (coef 0, so they add exactly zero)."""
    if neigh_ts.shape != neigh_idx.shape:
        raise ValueError(
            f"tgn event timestamps must match the ELL lane shape: "
            f"ts {tuple(neigh_ts.shape)} vs idx {tuple(neigh_idx.shape)}")
    if not neigh_ts.is_floating_point():
        raise ValueError(
            f"tgn event timestamps must be floating, got "
            f"{str(neigh_ts.dtype).removeprefix('torch.')}")
    if not batched:
        outs, memT = _tgn_launch(
            True, neigh_idx[None], neigh_coef[None], neigh_ts[None],
            node_feat[None], renumber[None], node_mask[None], mem0[None],
            freq, w_in, wx, wh, b)
        return outs[0], memT[0]
    return _engine.tgn_engine(*_tgn_pack(
        neigh_idx, neigh_coef, neigh_ts, node_feat, renumber, node_mask,
        mem0, freq, w_in, wx, wh, b))


def _static_pack(neigh_idx, neigh_coef, node_feat, node_mask, weights,
                 b_gcn, edge_aggs=None):
    """The static-GCN kernel wrapper's inputs: the common square layout of
    ``_square_layers`` with the weights shared (params, not state),
    stacked (L, dmax, dmax)."""
    _, w, bg, x, eagg = _square_layers(weights, b_gcn, node_feat, edge_aggs,
                                       stack_dim=0)
    return (_i32(neigh_idx), neigh_coef.contiguous(), x,
            node_mask.contiguous(), w, bg, eagg)


def _static_launch(batched, neigh_idx, neigh_coef, node_feat, node_mask,
                   weights, b_gcn, edge_aggs=None):
    """Pack + kernel wrapper for the static (no-recurrence) family. T must
    be 1 (the wrapper raises otherwise): independent snapshots fold onto
    the batch axis. Returns the 1-tuple ``(outs,)`` — no final state."""
    if not batched:
        ea = None if edge_aggs is None else [a[None] for a in edge_aggs]
        (outs,) = _static_launch(True, neigh_idx[None], neigh_coef[None],
                                 node_feat[None], node_mask[None], weights,
                                 b_gcn, ea)
        return (outs[0],)
    outs = _engine.static_engine(*_static_pack(
        neigh_idx, neigh_coef, node_feat, node_mask, weights, b_gcn,
        edge_aggs))
    return (outs[..., :weights[-1].shape[-1]],)


# family -> ((solo oracle, batched oracle), kernel launcher, packer,
# positions of the (coef, mask, renumber, live) arguments the ragged
# rewrite touches)
_STREAM_DISPATCH = {
    "gcrn": ((_ref.gcrn_stream_ref, _ref.gcrn_stream_batched_ref),
             _gcrn_launch, _gcrn_pack, dict(coef=1, mask=5, ren=4, live=None)),
    "stacked": ((_ref.stacked_stream_ref, _ref.stacked_stream_batched_ref),
                _stacked_launch, _stacked_pack,
                dict(coef=1, mask=5, ren=4, live=None)),
    "evolve": ((_ref.evolve_stream_ref, _ref.evolve_stream_batched_ref),
               _evolve_launch, _evolve_pack,
               dict(coef=1, mask=3, ren=None, live=4)),
    "tgn": ((_ref.tgn_stream_ref, _ref.tgn_stream_batched_ref),
            _tgn_launch, _tgn_pack, dict(coef=1, mask=5, ren=4, live=None)),
    "static_gcn": ((_ref.static_gcn_stream_ref,
                    _ref.static_gcn_stream_batched_ref),
                   _static_launch, _static_pack,
                   dict(coef=1, mask=3, ren=None, live=None)),
}


def _apply_lengths(family: str, args: tuple, lengths) -> tuple:
    """Turn the T tail of each stream in a (B, T, ...) batch into no-op
    snapshots: steps t >= lengths[b] get coef 0 / mask 0 / renumber -1
    (and live 0 for the weights-evolved family), so the tail content is
    irrelevant and a length-0 row is a pure padding stream."""
    axes = _STREAM_DISPATCH[family][3]
    coef = args[axes["coef"]]
    if not torch.is_tensor(lengths):
        lengths = torch.as_tensor(np.asarray(lengths))
    lengths = lengths.to(coef.device)
    t_axis = torch.arange(coef.shape[1], device=coef.device)
    live = t_axis[None, :] < lengths[:, None]                  # (B, T)
    out = list(args)
    out[axes["coef"]] = coef * live[:, :, None, None]
    out[axes["mask"]] = args[axes["mask"]] * live[:, :, None]
    if axes["ren"] is not None:
        ren = args[axes["ren"]]
        out[axes["ren"]] = torch.where(live[:, :, None], ren,
                                       torch.full_like(ren, -1))
    if axes["live"] is not None:
        out[axes["live"]] = args[axes["live"]] * live.to(args[axes["live"]].dtype)
    return tuple(out)


def pack(family: str, *args, lengths=None) -> tuple:
    """The inputs that ``stream_steps_batched`` hands the family's kernel
    wrapper (``engine.<family>_engine``) for the
    same batched argument list (tensors already on their device), ragged
    ``lengths`` applied."""
    if lengths is not None:
        args = _apply_lengths(family, args, lengths)
    return _STREAM_DISPATCH[family][2](*args)


def _stream_dispatch(family: str, batched: bool, args, kwargs, *, tn, td,
                     force_ref, device, residency, depth, lengths=None):
    if family not in _TEMPORAL:
        raise KeyError(f"unknown stream-engine family {family!r}; "
                       f"registered: {stream_families()}")
    if family_temporal(family) == "static" and (residency != "vmem"
                                                or depth is not None):
        raise ValueError(
            "static_gcn has no state to page; residency must be 'vmem'")
    if residency != "vmem" or depth is not None:
        raise NotImplementedError(
            f"state_residency={residency!r}, buffer_depth={depth!r}: the "
            "port keeps every store resident; hbm_paged is ROADMAP.md "
            "queue 1 item 11")
    # tn and td are TPU VMEM tiling knobs: the plan validates them, and the
    # CUDA kernels compute the same function for any value (they take any
    # node count and pad widths to their own micro-tile)
    del tn, td
    dev = resolve_device(device)
    args = to_device(tuple(args), dev)
    kwargs = {k: to_device(v, dev) for k, v in kwargs.items()}
    oracles, launch = _STREAM_DISPATCH[family][:2]
    if batched and lengths is not None:
        args = _apply_lengths(family, args, lengths)
    if force_ref:
        # the one force-ref gate: no kernel wrapper is reachable from here
        return oracles[1 if batched else 0](*args, **kwargs)
    return launch(batched, *args, **kwargs)


def stream_steps(family: str, *args, tn: int = 128, td=None,
                 state_residency: str = "vmem", buffer_depth=None,
                 force_ref: bool = False, device="cuda", **kwargs):
    """One stream of T snapshots through one launch of the family's stream
    engine, on ``device`` ("cuda" by default; "cpu" runs the plain path).

    Family argument lists (the kernels/ref.py oracles' order):
      gcrn    (idx, coef, eidx, x, renumber, mask, h0, c0, wx, wh, b,
               edge_msg=None) -> (outs, hT, cT)
      stacked (idx, coef, eidx, x, renumber, mask, h0, w_gcn, b_gcn, wx,
               wh, b, edge_msg=None) -> (outs, hT)
      evolve  (idx, coef, x, mask, live, weights, b_gcn, gru_wx, gru_wh,
               gru_b, edge_aggs=None) -> (outs, weights_T)
      tgn     (idx, coef, ts, x, renumber, mask, mem0, freq, w_in, wx, wh,
               b) -> (outs, memT)        [T sequences event batches; ts
               carries each lane's event time]
      static_gcn (idx, coef, x, mask, weights, b_gcn, edge_aggs=None)
               -> (outs,)                [T must be 1: fold snapshots onto
               the batch axis]
    """
    return _stream_dispatch(family, False, args, kwargs, tn=tn, td=td,
                            force_ref=force_ref, device=device,
                            residency=state_residency, depth=buffer_depth)


def stream_steps_batched(family: str, *args, tn: int = 128, td=None,
                         lengths=None, state_residency: str = "vmem",
                         buffer_depth=None, force_ref: bool = False,
                         device="cuda", **kwargs):
    """B independent streams in one launch: the ``stream_steps`` argument
    lists with a leading (B, ...) axis on stream arrays and per-stream
    state. ``lengths`` ((B,) ints) runs the launch ragged over T: stream
    b's steps past ``lengths[b]`` are no-ops."""
    return _stream_dispatch(family, True, args, kwargs, tn=tn, td=td,
                            force_ref=force_ref, device=device,
                            residency=state_residency, depth=buffer_depth,
                            lengths=lengths)
