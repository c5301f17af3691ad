"""Generic LM-family model (the counterpart of ``repro.models.lm``):
prefill, decode from caches and the training loss for the dense, MoE,
SSM, hybrid and encoder-only wirings of ``ModelConfig.layer_kinds()``.

Layers are stored STACKED per period position, in the JAX pytree layout:
``params["blocks"]`` is a list over the scan period of dicts whose leaves
carry a leading layer axis, so the weights cross between the packages
structurally (``params.lm_params_from_jax``). The JAX package's scanned and
unrolled forward paths are one Python loop over the layers here. A
layer's mixer is GQA attention (``nn/attention.py``) or the Mamba2 mixer
(``nn/mamba2.py``); its MLP SwiGLU (``nn/mlp.py``), the MoE MLP
(``nn/moe.py``: dense, or expert-parallel under a mesh) or none. Decode caches mirror the blocks:
a KV cache with a host-side "len" for attention layers, {"conv", "ssm"}
for Mamba2 layers (an SSM-only model has no "len": its decode position
is 0, as in the JAX package, and its mixer reads none).

Training (``loss_fn``): ``backbone(train=True)`` recomputes each layer in
the backward when ``rt.remat`` (``torch.utils.checkpoint``, the JAX
package's ``jax.checkpoint``: only the layer boundaries are kept), and
``chunked_ce_loss`` recomputes each ``rt.loss_chunk`` chunk's logits, so
(B, S, V) never exists.

Under a mesh (``distributed.sharding_ctx(mesh)``, with the parameters
distributed by ``param_axes`` and ``distributed.tree_shardings``) the
model runs on DTensors with the JAX package's ``shard`` calls: the
residual stream on ("batch", "seq_sp", None) (sequence-parallel over
'model'), attention and the MLP tensor-parallel over 'model', the logits
on "vocab"; tokens, positions and the masks the model builds join the
mesh through ``distributed.shard`` / ``replicated``. A ``moe_impl="ep"``
(or ``"auto"`` over a model axis wider than 1) MoE layer exchanges its
tokens over the mesh's 'model' group. ``prefill_step`` and
``decode_step`` run under ``torch.inference_mode`` without a mesh and
under ``torch.no_grad`` with one (DTensor views need version counters).
Without a mesh nothing becomes a DTensor and no value changes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.api import (Axes, current_mesh, gather_fsdp,
                                         in_current_ctx, local_tensor,
                                         replicated, shard)
from repro_torch.kernels.ops import resolve_device
from repro_torch.nn import attention as ATT
from repro_torch.nn import mamba2 as SSM
from repro_torch.nn import mlp as MLP
from repro_torch.nn import moe as MOE
from repro_torch.nn.layers import (
    ACT_DTYPE,
    bf16_cotangent,
    embed_lookup,
    embedding_axes,
    init_embedding,
    init_lm_head,
    init_rms_norm,
    lm_head_axes,
    rms_norm,
    rms_norm_axes,
    silu,
    vocab_mask,
)

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


# ------------------------------------------------------------- params ----


def _init_layer(generator, cfg: ModelConfig, rt: RuntimeConfig, mixer: str,
                mlp: str, device, dtype):
    kw = dict(device=device, dtype=dtype)
    p = {"norm1": init_rms_norm(cfg.d_model, **kw)}
    if mixer == "attn":
        p["attn"] = ATT.init_attention(generator, cfg, rt.tp, **kw)
    else:
        p["ssm"] = SSM.init_mamba(generator, cfg, **kw)
    if mlp != "none":
        p["norm2"] = init_rms_norm(cfg.d_model, **kw)
        if mlp == "dense":
            p["mlp"] = MLP.init_mlp(generator, cfg.d_model, cfg.d_ff,
                                    cfg.n_layers, **kw)
        else:
            p["moe"] = MOE.init_moe(generator, cfg, rt.tp, **kw)
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
            mixer, mlp = kinds[b * period + pos]
            layer = _init_layer(generator, cfg, rt, mixer, mlp, device,
                                dtype)
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


def _layer_axes(cfg: ModelConfig, mixer: str, mlp: str) -> dict:
    ax = {"norm1": rms_norm_axes()}
    if mixer == "attn":
        ax["attn"] = ATT.attention_axes(cfg)
    else:
        ax["ssm"] = SSM.mamba_axes()
    if mlp != "none":
        ax["norm2"] = rms_norm_axes()
        ax["mlp" if mlp == "dense" else "moe"] = (
            MLP.mlp_axes() if mlp == "dense" else MOE.moe_axes(cfg))
    return ax


def param_axes(cfg: ModelConfig, rt: RuntimeConfig) -> dict:
    """The logical-axis tree of ``init_params``'s parameters (the JAX
    package's ``init_params(...)[1]``): ``Axes`` leaves, the stacked
    "layers" axis first on every block leaf. Allocates nothing."""
    kinds = cfg.layer_kinds()
    axes: dict[str, Any] = {"embed": embedding_axes()}
    if not cfg.tie_embeddings:
        axes["head"] = lm_head_axes()
    axes["final_norm"] = Axes(None)
    axes["blocks"] = [
        _tree_map(lambda a: Axes("layers", *a.names),
                  _layer_axes(cfg, *kinds[pos]))
        for pos in range(cfg.scan_period())]
    return axes


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
    h = _gather_seq(rms_norm(x, pl["norm1"], cfg.norm_eps))
    return ATT.attention_block(
        pl["attn"], cfg, h, positions, attn_chunk=rt.attn_chunk, cache=cache,
        long_ctx=rt.long_ctx, attn_impl=rt.attn_impl, flash_bq=rt.flash_bq,
        flash_bk=rt.flash_bk)


def _gather_seq(h):
    """The sequence-parallel residual's all-gather before a sublayer's
    column-parallel projections, made once (each projection would gather
    its own copy; XLA shares one). Without a mesh, ``h``."""
    return shard(h, "batch", None, None)


def _dense_act(cfg: ModelConfig):
    """The dense SwiGLU's silu: in a model with MoE or Mamba2 layers (jamba,
    llama4) ``layers.silu``, which rounds where the JAX package does, as
    those layers' own SwiGLU and gating do, so every sublayer of such a
    model equals the JAX package's bit for bit; elsewhere the fused
    ``F.silu`` (one elementwise kernel where ``layers.silu`` runs five)."""
    return silu if cfg.n_experts or cfg.ssm_state else F.silu


def layer_apply(pl: dict, cfg: ModelConfig, rt: RuntimeConfig, mlp: str,
                x: torch.Tensor, positions, cache: Optional[dict] = None):
    """One layer: x plus its mixer (attention, or Mamba2 where the layer
    holds "ssm"), then plus its MLP (dense or MoE), each pre-norm."""
    if "attn" in pl:
        y, new_cache = attention_sublayer(pl, cfg, rt, x, positions, cache)
    else:
        h = rms_norm(x, pl["norm1"], cfg.norm_eps)
        y, new_cache = SSM.mamba_block(pl["ssm"], cfg, h, state=cache)
    x = x + y
    x = shard(x, "batch", "seq_sp", None)
    if mlp != "none":
        h2 = rms_norm(x, pl["norm2"], cfg.norm_eps)
        if mlp == "dense":
            h2 = _gather_seq(h2)
            y2 = MLP.mlp_block(pl["mlp"], h2, act=_dense_act(cfg))
        else:
            y2 = MOE.moe_block(pl["moe"], cfg, h2, impl=rt.moe_impl,
                               fsdp=rt.fsdp, cf_send=rt.moe_cf_send,
                               cf_local=rt.moe_cf_local)
        x = x + y2
        x = shard(x, "batch", "seq_sp", None)
    return x, new_cache


def backbone(params: dict, cfg: ModelConfig, rt: RuntimeConfig,
             x: torch.Tensor, positions, caches: Optional[list] = None,
             train: bool = False):
    """x: (B, S, D) -> (B, S, D); threads per-layer caches when decoding.
    ``train`` with ``rt.remat``: each layer is recomputed in the backward,
    so only the layer boundaries are kept."""
    period = cfg.scan_period()
    x = shard(x.to(ACT_DTYPE), "batch", "seq_sp", None)
    collected: dict[int, list] = {pos: [] for pos in range(period)}
    for pos, mlp, pl, cache in iter_layers(params, cfg, caches):
        if train and rt.remat:
            x, new_cache = checkpoint(in_current_ctx(layer_apply), pl, cfg,
                                      rt, mlp, x, positions, cache,
                                      use_reentrant=False)
        else:
            x, new_cache = layer_apply(pl, cfg, rt, mlp, x, positions, cache)
        if caches is not None:
            collected[pos].append(new_cache)
    if caches is None:
        return x, None
    return x, [_stack(collected[pos]) for pos in range(period)]


def _inputs_to_stream(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    w = params["embed"]
    if "embeds" in batch:
        return shard(replicated(batch["embeds"], w), "batch", None,
                     None).to(ACT_DTYPE)
    return embed_lookup(w, shard(replicated(batch["tokens"], w), "batch",
                                 None))


def _head_weight(params, cfg: ModelConfig) -> torch.Tensor:
    """The (D, V) head in bf16, its FSDP dim gathered."""
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return gather_fsdp(w.to(ACT_DTYPE), "embed_fsdp", "vocab")


def logits_fn(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Full logits (only for small S / decode)."""
    w = _head_weight(params, cfg)
    logits = torch.einsum("bsd,dv->bsv", x, w).float()
    logits = logits + replicated(vocab_mask(w.shape[1], cfg.vocab_size,
                                            x.device), logits)
    return shard(logits, "batch", None, "vocab")


def chunked_ce_loss(params, cfg: ModelConfig, rt: RuntimeConfig, x, targets,
                    mask=None) -> torch.Tensor:
    """Mean cross-entropy over (B, S) without materializing (B, S, V): the
    logits of ``rt.loss_chunk`` positions at a time, each chunk recomputed
    in the backward (its residual is the x chunk)."""
    b, s, d = x.shape
    x = _gather_seq(x)  # the chunks cut the sequence: whole on each rank
    w = _head_weight(params, cfg)
    vmask = replicated(vocab_mask(w.shape[1], cfg.vocab_size, x.device), x)
    c = min(rt.loss_chunk, s)
    if s % c:
        raise ValueError(f"chunked_ce_loss: S={s} is not a multiple of "
                         f"loss_chunk={c}")
    mk = (replicated(torch.ones((b, s), device=x.device), x) if mask is None
          else shard(replicated(mask, x), "batch", None).float())
    targets = shard(replicated(targets, x), "batch", None)
    cols = replicated(torch.arange(w.shape[1], device=x.device), x)

    def one(xi, ti, mi):
        lg = torch.einsum("bcd,dv->bcv", xi, w).float() + vmask
        lg = shard(lg, "batch", None, "vocab")
        lse = torch.logsumexp(lg, dim=-1)
        if isinstance(lg, DTensor):
            # vocab-sharded: the gold logit as a one-hot sum over each
            # rank's columns (exact: one term is not 0), whose backward
            # stays sharded (a gather's scatters into a whole chunk)
            hot = shard(cols, "vocab") == ti.long()[..., None]
            gold = (lg * hot).sum(-1)
        else:
            gold = torch.gather(lg, -1, ti.long()[..., None])[..., 0]
        return ((lse - gold) * mi).sum()

    total = 0.0
    for i in range(0, s, c):
        chunk = (x[:, i:i + c], targets[:, i:i + c], mk[:, i:i + c])
        total = total + (checkpoint(in_current_ctx(one), *chunk,
                                    use_reentrant=False)
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
    positions = replicated(torch.arange(s, device=dev).expand(b, s), x)
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


def _no_grad():
    """``torch.inference_mode`` without a mesh; ``torch.no_grad`` under
    one (an inference tensor cannot be a DTensor's view)."""
    return torch.no_grad() if current_mesh() is not None \
        else torch.inference_mode()


def prefill_step(params, cfg: ModelConfig, rt: RuntimeConfig, batch: dict, *,
                 device="cuda"):
    """Forward pass producing last-position logits (B, 1, V) fp32 (under a
    mesh a DTensor sharded on "vocab")."""
    with _no_grad():
        dev = _batch_device(params, batch, device)
        x = _inputs_to_stream(params, cfg, batch)
        b, s = x.shape[0], x.shape[1]
        positions = replicated(torch.arange(s, device=dev).expand(b, s), x)
        h, _ = backbone(params, cfg, rt, x, positions, train=False)
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        return logits_fn(params, cfg, h[:, -1:, :])


def init_caches(cfg: ModelConfig, rt: RuntimeConfig, batch: int, skv: int,
                device="cuda"):
    """Decode caches, stacked per period position (mirrors
    params['blocks']): an attention layer's KV cache, whose "len" is a
    host-side (n_blocks,) int32, or a Mamba2 layer's {"conv", "ssm"}."""
    dev = resolve_device(device)
    kinds = cfg.layer_kinds()
    period = cfg.scan_period()
    nb = cfg.n_layers // period
    caches: list = []
    for pos in range(period):
        mixer, _ = kinds[pos]
        if mixer == "attn":
            one = ATT.init_decode_cache(cfg, batch, skv, rt.tp,
                                        quant=rt.kv_quant, device=dev)
        else:
            one = SSM.init_mamba_state(cfg, batch, device=dev)
        caches.append(_tree_map(
            lambda a: a[None].expand(nb, *a.shape).clone(), one))
    return caches


def cache_axes(cfg: ModelConfig, rt: RuntimeConfig) -> list:
    """Logical axes for the cache pytree (for dry-run in_shardings)."""
    kinds = cfg.layer_kinds()
    period = cfg.scan_period()
    kv_ax = "kv_seq_dp" if rt.long_ctx else "kv_seq"
    out = []
    for pos in range(period):
        mixer, _ = kinds[pos]
        if mixer == "attn":
            ax = {
                "k": Axes("layers", "batch", kv_ax, "kv_heads", None),
                "v": Axes("layers", "batch", kv_ax, "kv_heads", None),
                "len": Axes("layers"),
            }
            if rt.kv_quant:
                ax["k_s"] = Axes("layers", "batch", kv_ax, "kv_heads")
                ax["v_s"] = Axes("layers", "batch", kv_ax, "kv_heads")
            out.append(ax)
        else:
            out.append({
                "conv": Axes("layers", "batch", None, "conv_dim"),
                "ssm": Axes("layers", "batch", "ssm_heads", None, None),
            })
    return out


def decode_step(params, cfg: ModelConfig, rt: RuntimeConfig,
                tokens: torch.Tensor, caches: list, *, device="cuda"):
    """One new token per sequence against the caches. tokens: (B, 1).
    Returns (logits (B, 1, V) fp32, new caches)."""
    with _no_grad():
        dev = _batch_device(params, {"tokens": tokens}, device)
        x = embed_lookup(params["embed"], shard(
            replicated(tokens, params["embed"]), "batch", None))
        # position = current cache length, from the first cache with one
        # (an SSM-only model has none: its layers use no position); a
        # DTensor cache's "len" is replicated, each rank reads its copy
        pos = 0
        for c in caches:
            if c is not None and "len" in c:
                pos = int(local_tensor(c["len"])[0])
                break
        positions = replicated(torch.full((tokens.shape[0], 1), pos,
                                          device=dev), x)
        h, new_caches = backbone(params, cfg, rt, x, positions,
                                 caches=caches, train=False)
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        return logits_fn(params, cfg, h), new_caches
