"""Event-driven temporal GNN with node memory (TGN/TGAT lineage).

The "event" temporal contract's model: the stream is a sequence of EVENT
BATCHES (graph/events.PaddedEventBlock: timestamped interactions padded
into the engine's ELL row layout over the batch's touched nodes). Per
batch, every touched node

  1. aggregates its event partners' previous memory (the mean over its
     events in the batch),
  2. aggregates the time encoding ``cos(t * freq_d)`` of its events, with
     learnable log-spaced per-dimension frequencies (the TGAT form),
  3. feeds ``x @ W_in + agg_mem + agg_time`` and its own previous memory
     through a GRU,

and writes the new memory back at its global row only: untouched nodes
carry their memory forward. The recurrent state is the global node-memory
store ``(n_global, hidden)``.

Dataflow levels: baseline (a per-batch PyTorch step) and v3 (the whole
stream in one launch of the TGN stream-engine kernel, csrc/tgn_engine.cu,
ragged over event batches through ``lengths``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.dgnn import DGNNConfig
from repro_torch.core import rnn as R
from repro_torch.core.gcrn import gather_rows, scatter_rows
from repro_torch.graph.events import PaddedEventBlock
from repro_torch.kernels import ops as kops


def init_time_encoding(hidden: int) -> torch.Tensor:
    """Log-spaced frequencies 10^0 .. 10^-4 (the TGAT initialisation),
    learnable thereafter: they live in the params."""
    return 1.0 / (10.0 ** torch.linspace(0.0, 4.0, hidden,
                                         dtype=torch.float32))


class TGNModel:
    stream_family = "tgn"

    def __init__(self, cfg: DGNNConfig, impl: str = "xla",
                 n_global: int = 4096):
        assert cfg.dgnn_type == "event_memory"
        self.cfg = cfg
        self.impl = impl
        self.n_global = n_global

    def init(self, gen: torch.Generator) -> dict:
        """Random parameters from ``gen``, on the CPU."""
        cfg = self.cfg
        scale = 1.0 / math.sqrt(cfg.in_dim)
        return {
            "freq": init_time_encoding(cfg.hidden),
            "w_in": (torch.rand(cfg.in_dim, cfg.hidden, generator=gen) * 2
                     - 1) * scale,
            "gru": R.init_gru(gen, cfg.hidden, cfg.hidden),
        }

    def init_state(self, params: dict, mode: str = "baseline") -> dict:
        dev = params["w_in"].device
        return {"mem": torch.zeros((self.n_global, self.cfg.hidden),
                                   device=dev)}

    def step(self, params: dict, state: dict, blk: PaddedEventBlock, *,
             mode: str = "baseline", force_ref: bool = False):
        """One event batch in plain PyTorch (no kernel, so ``force_ref``
        changes nothing). Returns (new state, masked memory (n_pad, H))."""
        del force_ref
        mem = gather_rows(state["mem"], blk)
        coef = blk.neigh_coef[..., None]
        agg_m = (mem[blk.neigh_idx.long()] * coef).sum(dim=1)
        enc = torch.cos(blk.neigh_ts[..., None] * params["freq"])
        agg_e = (enc * coef).sum(dim=1)
        inp = blk.node_feat @ params["w_in"] + agg_m + agg_e
        m_new = R.gru_cell(params["gru"], inp, mem, fused=mode != "baseline")
        m_new = m_new * blk.node_mask[:, None]
        return {"mem": scatter_rows(state["mem"], blk, m_new)}, m_new

    def stream_args(self, params: dict, state: dict,
                    blocks: PaddedEventBlock) -> tuple:
        """The stream engine's argument list for ``blocks`` (the order of
        kernels/ops.stream_steps)."""
        g = params["gru"]
        return (blocks.neigh_idx, blocks.neigh_coef, blocks.neigh_ts,
                blocks.node_feat, blocks.renumber, blocks.node_mask,
                state["mem"], params["freq"], params["w_in"], g["wx"],
                g["wh"], g["b"])

    def _stream(self, params: dict, state: dict, blocks: PaddedEventBlock,
                batched: bool, tn=128, td="cfg", lengths=None,
                force_ref=False):
        td = self.cfg.stream_td if td == "cfg" else td
        dev = params["w_in"].device
        args = self.stream_args(params, state, blocks)
        if batched:
            outs, mem_T = kops.stream_steps_batched(
                self.stream_family, *args, tn=tn, td=td, lengths=lengths,
                force_ref=force_ref, device=dev)
        else:
            outs, mem_T = kops.stream_steps(
                self.stream_family, *args, tn=tn, td=td, force_ref=force_ref,
                device=dev)
        return {"mem": mem_T}, outs

    def step_stream(self, params: dict, state: dict,
                    blocks_T: PaddedEventBlock, *, tn=128, td="cfg",
                    force_ref=False):
        """V3: a whole (T, ...) event-batch stream through the engine."""
        return self._stream(params, state, blocks_T, batched=False, tn=tn,
                            td=td, force_ref=force_ref)

    def step_stream_batched(self, params: dict, state: dict,
                            blocks_BT: PaddedEventBlock, *, tn=128, td="cfg",
                            lengths=None, force_ref=False):
        """Batched V3: B independent event streams, state leaves
        (B, n_global, H), one launch; ``lengths`` counts event batches."""
        return self._stream(params, state, blocks_BT, batched=True, tn=tn,
                            td=td, lengths=lengths, force_ref=force_ref)
