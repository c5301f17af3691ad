"""Generic LM-family model (the counterpart of ``repro.models.lm``):
prefill, KV-cache decode and the training loss on the dense,
attention-only wiring.

Layers are stored STACKED per period position, in the JAX pytree layout:
``params["blocks"]`` is a list over the scan period of dicts whose leaves
carry a leading layer axis, so the weights cross between the packages
structurally (``params.lm_params_from_jax``). The JAX package's scanned and
unrolled forward paths are one Python loop over the layers here.

Training (``loss_fn``): ``backbone(train=True)`` recomputes each layer in
the backward when ``rt.remat`` (``torch.utils.checkpoint``, the JAX
package's ``jax.checkpoint``: only the layer boundaries are kept), and
``chunked_ce_loss`` recomputes each ``rt.loss_chunk`` chunk's logits, so
(B, S, V) never exists. Not ported yet (ROADMAP queue 1, the LM MoE MLP
and Mamba2 mixer): the MoE
and Mamba2 mixers (``init_params`` refuses those architectures), and
sharding.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import resolve_device
from repro_torch.nn import attention as ATT
from repro_torch.nn import mlp as MLP
from repro_torch.nn.layers import (
    ACT_DTYPE,
    bf16_cotangent,
    embed_lookup,
    init_embedding,
    init_lm_head,
    init_rms_norm,
    rms_norm,
    vocab_mask,
)

#: the ROADMAP item of what this module does not run yet
_NOT_PORTED = ("not ported yet (ROADMAP queue 1, the LM MoE MLP and Mamba2 "
               "mixer)")


@dataclass(frozen=True)
class RuntimeConfig:
    """Runtime/distribution choices (orthogonal to the architecture); the
    same fields and defaults as the JAX package's."""

    tp: int = 1                 # model-axis size (drives padding)
    scan_layers: bool = True    # False -> unrolled (dry-run accounting)
    remat: bool = True          # per-layer rematerialization for train
    attn_chunk: int = 2048      # q-chunk for long-sequence attention
    attn_impl: str = "xla"      # "flash" = the flash kernels
    flash_bq: int = 512         # flash q tile
    flash_bk: int = 512         # flash kv tile
    moe_impl: str = "auto"      # "dense" | "ep" | "auto"
    fsdp: bool = False          # shard weights' embed dim over 'data'
    long_ctx: bool = False      # sequence-shard the decode KV cache
    loss_chunk: int = 512       # seq chunk for chunked cross-entropy
    param_dtype: str = "fp32"   # "bf16": every parameter leaf in bf16
    grad_accum: int = 1         # microbatches per step
    moe_cf_send: float = 1.25   # EP dispatch capacity factor (all_to_all)
    moe_cf_local: float = 1.25  # EP local expert-bucket capacity factor
    bwd_bf16: bool = False      # demote the backward residual chain to bf16
    kv_quant: bool = False      # int8 KV cache (decode)


_PARAM_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _param_dtype(rt: RuntimeConfig) -> torch.dtype:
    try:
        return _PARAM_DTYPES[rt.param_dtype]
    except KeyError:
        raise ValueError(f"param_dtype {rt.param_dtype!r}: one of "
                         f"{sorted(_PARAM_DTYPES)}") from None


def _check_ported(cfg: ModelConfig) -> None:
    kinds = set(cfg.layer_kinds())
    if any(mixer != "attn" for mixer, _ in kinds):
        raise NotImplementedError(
            f"{cfg.name}: the Mamba2 (ssm) mixer is {_NOT_PORTED}")
    if any(mlp == "moe" for _, mlp in kinds):
        raise NotImplementedError(
            f"{cfg.name}: the MoE MLP is {_NOT_PORTED}")


# ------------------------------------------------------------- params ----


def _init_layer(generator, cfg: ModelConfig, rt: RuntimeConfig, mlp: str,
                device, dtype):
    kw = dict(device=device, dtype=dtype)
    p = {"norm1": init_rms_norm(cfg.d_model, **kw),
         "attn": ATT.init_attention(generator, cfg, rt.tp, **kw)}
    if mlp != "none":
        p["norm2"] = init_rms_norm(cfg.d_model, **kw)
        p["mlp"] = MLP.init_mlp(generator, cfg.d_model, cfg.d_ff,
                                cfg.n_layers, **kw)
    return p


def init_params(cfg: ModelConfig, rt: RuntimeConfig, generator=None,
                device="cuda") -> dict:
    """Random parameters in the JAX layout (layer leaves stacked per period
    position), in their final dtype (``rt.param_dtype``) on ``device``.

    Each tensor is drawn on ``device`` from ``generator`` (a
    ``torch.Generator`` on that device) one layer at a time and written
    into its stacked leaf, so the peak stays near one fp32 tensor. On the
    ``meta`` device nothing is drawn or allocated (the layout alone). The
    draws are not the JAX package's (its PRNG differs); a comparison
    carries the JAX weights across with ``params.lm_params_from_jax``."""
    _check_ported(cfg)
    device = torch.device(device)
    if device.type != "meta":
        device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device.type if device.type
                                    != "meta" else "cpu").manual_seed(0)
    dtype = _param_dtype(rt)
    kinds = cfg.layer_kinds()
    period = cfg.scan_period()
    nb = cfg.n_layers // period
    kw = dict(device=device, dtype=dtype)
    params: dict[str, Any] = {}
    vp = cfg.padded_vocab()
    params["embed"] = init_embedding(generator, vp, cfg.d_model, **kw)
    if not cfg.tie_embeddings:
        params["head"] = init_lm_head(generator, cfg.d_model, vp, **kw)
    params["final_norm"] = init_rms_norm(cfg.d_model, **kw)
    blocks = []
    for pos in range(period):
        stacked = None
        for b in range(nb):
            _, mlp = kinds[b * period + pos]
            layer = _init_layer(generator, cfg, rt, mlp, device, dtype)
            if stacked is None:
                stacked = _tree_map(lambda t: torch.empty(
                    (nb, *t.shape), dtype=t.dtype, device=t.device), layer)
            if device.type != "meta":
                _tree_zip(lambda dst, src, b=b: dst[b].copy_(src), stacked,
                          layer)
            del layer
        blocks.append(stacked)
    params["blocks"] = blocks
    return params


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_zip(fn, a, b):
    if isinstance(a, dict):
        for k in a:
            _tree_zip(fn, a[k], b[k])
    else:
        fn(a, b)


def _stack(trees: list):
    """Leaves of same-structure trees stacked on a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees, dim=0)


# ------------------------------------------------------------ forward ----


def _layer_slices(stacked, nb: int) -> list:
    """The ``nb`` per-layer trees of a stacked tree, each leaf cut once by
    ``torch.unbind``: under autograd its backward stacks the layers' grads
    once, where indexing ``a[b]`` would write a zero tensor of the whole
    stacked leaf for every slice."""
    if isinstance(stacked, dict):
        per_key = {k: _layer_slices(v, nb) for k, v in stacked.items()}
        return [{k: per_key[k][b] for k in stacked} for b in range(nb)]
    return list(torch.unbind(stacked, 0))


def iter_layers(params: dict, cfg: ModelConfig,
                caches: Optional[list] = None):
    """The layers in order, as ``backbone`` walks them: (period position,
    MLP kind, the layer's parameters, its cache or None), each sliced from
    its stacked leaves."""
    kinds = cfg.layer_kinds()
    period = cfg.scan_period()
    nb = cfg.n_layers // period
    layers = [_layer_slices(params["blocks"][pos], nb)
              for pos in range(period)]
    cache_layers = (None if caches is None else
                    [_layer_slices(caches[pos], nb) for pos in range(period)])
    for b in range(nb):
        for pos in range(period):
            _, mlp = kinds[b * period + pos]
            cache = None if caches is None else cache_layers[pos][b]
            yield pos, mlp, layers[pos][b], cache


def attention_sublayer(pl: dict, cfg: ModelConfig, rt: RuntimeConfig,
                       x: torch.Tensor, positions,
                       cache: Optional[dict] = None):
    """A layer's pre-norm attention: (its update to x, the new cache)."""
    h = rms_norm(x, pl["norm1"], cfg.norm_eps)
    return ATT.attention_block(
        pl["attn"], cfg, h, positions, attn_chunk=rt.attn_chunk, cache=cache,
        long_ctx=rt.long_ctx, attn_impl=rt.attn_impl, flash_bq=rt.flash_bq,
        flash_bk=rt.flash_bk)


def layer_apply(pl: dict, cfg: ModelConfig, rt: RuntimeConfig, mlp: str,
                x: torch.Tensor, positions, cache: Optional[dict] = None):
    """One layer: x plus its attention, then plus its MLP (pre-norm)."""
    y, new_cache = attention_sublayer(pl, cfg, rt, x, positions, cache)
    x = x + y
    if mlp != "none":
        h2 = rms_norm(x, pl["norm2"], cfg.norm_eps)
        x = x + MLP.mlp_block(pl["mlp"], h2)
    return x, new_cache


def backbone(params: dict, cfg: ModelConfig, rt: RuntimeConfig,
             x: torch.Tensor, positions, caches: Optional[list] = None,
             train: bool = False):
    """x: (B, S, D) -> (B, S, D); threads per-layer caches when decoding.
    ``train`` with ``rt.remat``: each layer is recomputed in the backward,
    so only the layer boundaries are kept."""
    _check_ported(cfg)
    period = cfg.scan_period()
    x = x.to(ACT_DTYPE)
    collected: dict[int, list] = {pos: [] for pos in range(period)}
    for pos, mlp, pl, cache in iter_layers(params, cfg, caches):
        if train and rt.remat:
            x, new_cache = checkpoint(layer_apply, pl, cfg, rt, mlp, x,
                                      positions, cache, use_reentrant=False)
        else:
            x, new_cache = layer_apply(pl, cfg, rt, mlp, x, positions, cache)
        if caches is not None:
            collected[pos].append(new_cache)
    if caches is None:
        return x, None
    return x, [_stack(collected[pos]) for pos in range(period)]


def _inputs_to_stream(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    if "embeds" in batch:
        return batch["embeds"].to(ACT_DTYPE)
    return embed_lookup(params["embed"], batch["tokens"])


def _head_weight(params, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["head"]


def logits_fn(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Full logits (only for small S / decode)."""
    w = _head_weight(params, cfg)
    logits = torch.einsum("bsd,dv->bsv", x, w.to(ACT_DTYPE)).float()
    return logits + vocab_mask(w.shape[1], cfg.vocab_size, x.device)


def chunked_ce_loss(params, cfg: ModelConfig, rt: RuntimeConfig, x, targets,
                    mask=None) -> torch.Tensor:
    """Mean cross-entropy over (B, S) without materializing (B, S, V): the
    logits of ``rt.loss_chunk`` positions at a time, each chunk recomputed
    in the backward (its residual is the x chunk)."""
    b, s, d = x.shape
    w = _head_weight(params, cfg)
    vmask = vocab_mask(w.shape[1], cfg.vocab_size, x.device)
    c = min(rt.loss_chunk, s)
    if s % c:
        raise ValueError(f"chunked_ce_loss: S={s} is not a multiple of "
                         f"loss_chunk={c}")
    mk = (torch.ones((b, s), device=x.device) if mask is None
          else mask.float())

    def one(xi, ti, mi):
        lg = torch.einsum("bcd,dv->bcv", xi, w.to(ACT_DTYPE)).float() + vmask
        lse = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, ti.long()[..., None])[..., 0]
        return ((lse - gold) * mi).sum()

    total = 0.0
    for i in range(0, s, c):
        chunk = (x[:, i:i + c], targets[:, i:i + c], mk[:, i:i + c])
        total = total + (checkpoint(one, *chunk, use_reentrant=False)
                         if torch.is_grad_enabled() else one(*chunk))
    return total / torch.clamp_min(mk.sum(), 1.0)


def loss_fn(params, cfg: ModelConfig, rt: RuntimeConfig, batch: dict, *,
            device="cuda") -> torch.Tensor:
    """The training loss of one batch ({"tokens" or "embeds", "targets"[,
    "mask"]}): the backbone with ``train=True``, the final norm, then the
    chunked cross-entropy; differentiable in ``params``. ``rt.bwd_bf16``
    rounds the loss head's cotangent to bf16 before it enters the
    backbone's backward. On the card unless ``device="cpu"``."""
    dev = _batch_device(params, batch, device)
    x = _inputs_to_stream(params, cfg, batch)
    b, s = x.shape[0], x.shape[1]
    positions = torch.arange(s, device=dev).expand(b, s)
    h, _ = backbone(params, cfg, rt, x, positions, train=True)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    if rt.bwd_bf16:
        h = bf16_cotangent(h)
    return chunked_ce_loss(params, cfg, rt, h, batch["targets"],
                           batch.get("mask"))


def _batch_device(params: dict, batch: dict, device) -> torch.device:
    """The device a call runs on (CUDA unless the caller passes "cpu"):
    the parameters and the batch must already be there."""
    dev = resolve_device(device)
    for key, t in (("params['embed']", params["embed"]),
                   *((f"batch[{k!r}]", v) for k, v in batch.items())):
        if t.device.type != dev.type:
            raise ValueError(f"{key} is on {t.device}, the call on {dev}")
    return dev


@torch.inference_mode()
def prefill_step(params, cfg: ModelConfig, rt: RuntimeConfig, batch: dict, *,
                 device="cuda"):
    """Forward pass producing last-position logits (B, 1, V) fp32."""
    dev = _batch_device(params, batch, device)
    x = _inputs_to_stream(params, cfg, batch)
    b, s = x.shape[0], x.shape[1]
    positions = torch.arange(s, device=dev).expand(b, s)
    h, _ = backbone(params, cfg, rt, x, positions, train=False)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return logits_fn(params, cfg, h[:, -1:, :])


def init_caches(cfg: ModelConfig, rt: RuntimeConfig, batch: int, skv: int,
                device="cuda"):
    """Decode caches, stacked per period position (mirrors
    params['blocks']); each "len" is a host-side (n_blocks,) int32."""
    _check_ported(cfg)
    dev = resolve_device(device)
    period = cfg.scan_period()
    nb = cfg.n_layers // period
    caches: list = []
    for _ in range(period):
        one = ATT.init_decode_cache(cfg, batch, skv, rt.tp,
                                    quant=rt.kv_quant, device=dev)
        caches.append(_tree_map(
            lambda a: a[None].expand(nb, *a.shape).clone(), one))
    return caches


@torch.inference_mode()
def decode_step(params, cfg: ModelConfig, rt: RuntimeConfig,
                tokens: torch.Tensor, caches: list, *, device="cuda"):
    """One new token per sequence against the caches. tokens: (B, 1).
    Returns (logits (B, 1, V) fp32, new caches)."""
    dev = _batch_device(params, {"tokens": tokens}, device)
    x = embed_lookup(params["embed"], tokens)
    # position = current cache length, from the first cache with one
    pos = 0
    for c in caches:
        if c is not None and "len" in c:
            pos = int(c["len"][0])
            break
    positions = torch.full((tokens.shape[0], 1), pos, device=dev)
    h, new_caches = backbone(params, cfg, rt, x, positions, caches=caches,
                             train=False)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return logits_fn(params, cfg, h), new_caches
