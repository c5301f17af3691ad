"""Closed-form corrections to a traced step's counts (the counterpart of
``repro.roofline.corrections``; the formulas are the JAX package's).

The JAX package's XLA cost analysis counts a while-loop body ONCE, so it
adds the missing (trips-1) * per-iteration terms of three rolled loops:

  1. q-chunked attention   (S/attn_chunk query chunks),
  2. chunked SSD           (S/ssm_chunk chunks),
  3. chunked cross-entropy (S/loss_chunk chunks).

The port's counter (``roofline.analysis.CostCounter``) sees every trip of
those Python loops, so the port's dry run adds none of the three: they
are itemised in its record beside the one it adds, the flash kernel,
which the trace runs as a shape-only stand-in (``flash_correction``: its
exact closed-form work and traffic from ``kernels/flash_attention.py``
``flops_bytes``). Train steps multiply by 3 (fwd + ~2x bwd).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclass
class Correction:
    flops: float = 0.0
    bytes_hbm: float = 0.0
    detail: dict = None


def _train_mult(shape: ShapeConfig) -> float:
    return 3.0 if shape.kind == "train" else 1.0


def flash_correction(cfg: ModelConfig, shape: ShapeConfig, tp: int,
                     bq: int = 512, bk: int = 512) -> Correction:
    """attn_impl="flash": the kernel runs as a shape-only stand-in in the
    trace (0 cost to the counter); add its exact closed-form work/traffic
    (kernels/flash_attention.py)."""
    from repro_torch.kernels.flash_attention import flops_bytes

    s = shape.seq_len
    b = shape.global_batch
    hq, hkv = cfg.padded_heads(tp), cfg.padded_kv_heads(tp)
    hd = cfg.resolved_head_dim
    n_attn = sum(1 for mx, _ in cfg.layer_kinds() if mx == "attn")
    fb = flops_bytes(b, hq, hkv, s, hd, causal=cfg.causal, bq=bq, bk=bk)
    # train: fwd (2 matmuls/pair) + dkv pass (3) + dq pass (2, w/ recompute
    # shared) => flops x3.5; K/V re-streamed by both bwd passes => bytes x3
    mf = 3.5 if shape.kind == "train" else 1.0
    mb = 3.0 if shape.kind == "train" else 1.0
    return Correction(fb["flops"] * n_attn * mf, fb["bytes"] * n_attn * mb,
                      {"site": "flash_attention", "layers": n_attn,
                       "tile_pairs": fb["tile_pairs"], "bq": bq, "bk": bk})


def attention_correction(cfg: ModelConfig, shape: ShapeConfig, tp: int,
                         attn_chunk: int) -> Correction:
    """Missing q-chunk trips of chunked_attention (full KV per chunk)."""
    s = 1 if shape.is_decode else shape.seq_len
    if s <= attn_chunk:
        return Correction(0.0, 0.0, {})
    b = shape.global_batch
    hq = cfg.padded_heads(tp)
    hkv = cfg.padded_kv_heads(tp)
    hd = cfg.resolved_head_dim
    n_attn = sum(1 for mx, _ in cfg.layer_kinds() if mx == "attn")
    nc = s // attn_chunk
    # per-iteration: scores (2*B*Hq*c*S*hd) + out (same)
    per_iter_flops = 4.0 * b * hq * attn_chunk * s * hd
    # per-iteration bytes: stream K and V (bf16) + q/out chunk
    per_iter_bytes = (2 * b * s * hkv * hd * 2.0) + (2 * b * attn_chunk * hq * hd * 2.0)
    m = _train_mult(shape)
    f = (nc - 1) * per_iter_flops * n_attn * m
    by = (nc - 1) * per_iter_bytes * n_attn * m
    return Correction(f, by, {"site": "attention", "nc": nc, "layers": n_attn})


def ssd_correction(cfg: ModelConfig, shape: ShapeConfig, tp: int) -> Correction:
    """Missing chunk trips of ssd_chunked's per-chunk lax.map."""
    if cfg.ssm_state == 0 or shape.is_decode:
        return Correction(0.0, 0.0, {})
    s = shape.seq_len
    q = cfg.ssm_chunk
    if s <= q:
        return Correction(0.0, 0.0, {})
    b = shape.global_batch
    h, p, n = cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state
    n_ssm = sum(1 for mx, _ in cfg.layer_kinds() if mx == "ssm")
    nc = s // q
    # per-iteration einsums: scores 2*b*q^2*h*n; y_intra 2*b*q^2*h*p;
    # states 2*b*q*h*n*p; (y_inter is outside the map)
    per_iter_flops = 2.0 * b * q * q * h * (n + p) + 2.0 * b * q * h * n * p
    per_iter_bytes = b * q * h * (p + 2 * n / max(h // cfg.ssm_nheads, 1)) * 4.0 + b * q * h * 4.0
    m = _train_mult(shape)
    f = (nc - 1) * per_iter_flops * n_ssm * m
    by = (nc - 1) * per_iter_bytes * n_ssm * m
    return Correction(f, by, {"site": "ssd", "nc": nc, "layers": n_ssm})


def loss_correction(cfg: ModelConfig, shape: ShapeConfig, tp: int,
                    loss_chunk: int) -> Correction:
    """Missing seq-chunk trips of chunked_ce_loss (train only)."""
    if shape.kind != "train":
        return Correction(0.0, 0.0, {})
    s, b = shape.seq_len, shape.global_batch
    c = min(loss_chunk, s)
    nc = s // c
    if nc <= 1:
        return Correction(0.0, 0.0, {})
    vp = cfg.padded_vocab()
    per_iter_flops = 2.0 * b * c * cfg.d_model * vp
    per_iter_bytes = b * c * vp * 4.0 + b * c * cfg.d_model * 2.0
    m = _train_mult(shape)
    return Correction((nc - 1) * per_iter_flops * m,
                      (nc - 1) * per_iter_bytes * m,
                      {"site": "loss", "nc": nc})


def total_corrections(cfg: ModelConfig, shape: ShapeConfig, tp: int,
                      attn_chunk: int, loss_chunk: int,
                      attn_impl: str = "xla", flash_bq: int = 512,
                      flash_bk: int = 512) -> dict:
    if attn_impl == "flash" and not shape.is_decode:
        attn = flash_correction(cfg, shape, tp, flash_bq, flash_bk)
    else:
        attn = attention_correction(cfg, shape, tp, attn_chunk)
    cs = [
        attn,
        ssd_correction(cfg, shape, tp),
        loss_correction(cfg, shape, tp, loss_chunk),
    ]
    return {
        "flops": sum(c.flops for c in cs),
        "bytes_hbm": sum(c.bytes_hbm for c in cs),
        "items": [c.detail for c in cs if c.detail],
    }
