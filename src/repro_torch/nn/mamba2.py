"""Mamba2 mixer: chunked SSD (state-space duality) and O(1) decode (the
counterpart of ``repro.nn.mamba2``).

Within a chunk the work is dense (no recurrence); only a small
(heads, P, N) state crosses chunk boundaries through a short scan.

Shapes: x (B, S, D) -> in_proj -> z (B, S, d_inner), xb (B, S, d_inner),
B / C (B, S, G, N), dt (B, S, H). Heads H = d_inner / P (P =
ssm_head_dim). With chunk length Q:
  intra-chunk: Y_intra = (C B^T * decay mask) @ X    (dense, per chunk)
  inter-chunk: states S_c = decay-weighted B X^T, carried by a scan over
               chunks; Y_inter = C @ S_carried.

The chunks run one after another (the JAX package's ``lax.map``), so the
O(Q^2) intra-chunk buffers exist for one chunk at a time. Under autograd
each chunk's intra-chunk work is recomputed in the backward (the JAX
package's ``jax.checkpoint``): only a chunk's inputs and the carried
state are kept, so a layer's backward holds one chunk's O(Q^2) buffers,
not all of them. It nests inside the LM's per-layer recomputation
(``RuntimeConfig.remat``).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.api import Axes, gather_fsdp, replicated, shard
from repro_torch.kernels.ops import resolve_device
from repro_torch.nn import layers as L
from repro_torch.nn.layers import ACT_DTYPE, normal_init, silu


def init_mamba(generator, cfg: ModelConfig, *, device="cuda",
               dtype=torch.float32) -> dict:
    device = resolve_device(device)
    d, di = cfg.d_model, cfg.d_inner
    g, n, h = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    conv_ch = di + 2 * g * n
    d_in_proj = 2 * di + 2 * g * n + h
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    init = lambda shape, scale: normal_init(generator, shape, scale,
                                            device=device, dtype=dtype)
    full = lambda shape, value: torch.full(shape, value, device=device,
                                           dtype=dtype)
    if device.type == "meta":
        dt_bias = torch.empty((h,), device=device, dtype=dtype)
    else:
        # dt bias: softplus^-1 of dt in [1e-3, 1e-1] (mamba2 init)
        u = torch.rand((h,), generator=generator, device=device,
                       dtype=torch.float32)
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                       + math.log(1e-3))
        dt_bias = (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    return {
        "in_proj": init((d, d_in_proj), 0.02),
        "conv_w": init((cfg.ssm_conv, conv_ch), 0.2),
        "conv_b": full((conv_ch,), 0.0),
        "A_log": torch.log(torch.arange(1, h + 1, device=device,
                                        dtype=torch.float32)).to(dtype),
        "D": full((h,), 1.0),
        "dt_bias": dt_bias,
        "ssm_norm": full((di,), 1.0),
        "out_proj": init((di, d), out_scale),
    }


def mamba_axes() -> dict:
    return {
        "in_proj": Axes("embed_fsdp", "ssm_inner"),
        "conv_w": Axes(None, "conv_dim"),
        "conv_b": Axes("conv_dim",),
        "A_log": Axes("ssm_heads",),
        "D": Axes("ssm_heads",),
        "dt_bias": Axes("ssm_heads",),
        "ssm_norm": Axes("ssm_inner",),
        "out_proj": Axes("ssm_inner", "embed_fsdp"),
    }


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    di, g, n = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state
    z = proj[..., :di]
    xbc = proj[..., di: di + di + 2 * g * n]
    dt = proj[..., di + di + 2 * g * n:]
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, then silu. xbc (B, S, C), w (K, C).

    K shifted multiply-adds in xbc's dtype; under ``set_lowmem_norm`` one
    grouped convolution (the JAX package's ``conv_general_dilated``)."""
    k = w.shape[0]
    w = w.to(xbc.dtype)
    if L.LOWMEM_NORM:
        c = xbc.shape[-1]
        out = F.conv1d(F.pad(xbc.transpose(1, 2), (k - 1, 0)),
                       w.T[:, None, :], groups=c)
        return silu(out.transpose(1, 2) + b.to(xbc.dtype))
    s = xbc.shape[1]
    out = xbc * w[k - 1]
    for i in range(1, k):
        shifted = F.pad(xbc, (0, 0, i, 0))[:, :s]
        out = out + shifted * w[k - 1 - i]
    return silu(out + b.to(xbc.dtype))


#: the SSD precision switch (per process, off by default): the state and
#: inter-chunk einsums take bf16 inputs with fp32 accumulation
SSD_BF16 = False


def set_ssd_bf16(v: bool) -> None:
    global SSD_BF16
    SSD_BF16 = bool(v)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 and held in fp32: an fp32 einsum of such
    operands is a bf16 einsum with fp32 accumulation."""
    return t.to(ACT_DTYPE).float()


def _per_chunk(xq, dtq, Bq, Cq, A, mask, rep: int):
    """One chunk: (y_intra (b, q, h, p) fp32, its state (b, h, p, n),
    the cumulative log decay (b, q, h))."""
    cums = torch.cumsum(dtq * A, dim=1)                       # (b,q,h)
    li = cums[:, :, None, :] - cums[:, None, :, :]            # (b,q,q,h)
    # exp of the masked log decay: JAX's where(mask, exp(li), 0), whose
    # unselected exp(li) above the diagonal may overflow and poison a
    # gradient with inf * 0
    decay = torch.exp(li.masked_fill(~mask[None, :, :, None], -math.inf))
    Bh = torch.repeat_interleave(Bq, rep, dim=2)              # (b,q,h,n)
    Ch = torch.repeat_interleave(Cq, rep, dim=2)
    scores = torch.einsum("bqhn,bkhn->bqkh", Ch, Bh).to(ACT_DTYPE)
    ydt = (dtq[..., None] * xq).to(ACT_DTYPE)                 # (b,q,h,p)
    y_intra = torch.einsum("bqkh,bkhp->bqhp", scores * decay.to(ACT_DTYPE),
                           ydt).float()
    decay_to_end = torch.exp(cums[:, -1:, :] - cums)          # (b,q,h)
    if SSD_BF16:
        state = torch.einsum("bqhn,bqh,bqhp->bhpn", _bf16(Bh),
                             _bf16(decay_to_end * dtq), _bf16(xq))
    else:
        state = torch.einsum("bqhn,bqh,bqhp->bhpn", Bh, decay_to_end * dtq,
                             xq)
    return y_intra, state, cums


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int):
    """Chunked SSD scan.

    xh (B, S, H, P), dt (B, S, H) (post-softplus), A (H,) negative,
    Bm / Cm (B, S, G, N). Returns y (B, S, H, P) fp32 and the final state
    (B, H, P, N)."""
    b, s, h, p = xh.shape
    g, n = Bm.shape[2], Bm.shape[3]
    s_orig = s
    if s % chunk:
        # pad to a chunk multiple with dt = 0 steps: decay 1 and update 0,
        # so the final state is untouched; their outputs are cut below
        pad = chunk - s % chunk
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        s = xh.shape[1]
    nc = s // chunk
    rep = h // g
    mask = replicated(torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                            device=xh.device)), xh)
    # chunk-major: one chunk's O(q^2) buffers at a time; ``carry`` is the
    # state entering chunk c (the JAX package's scan over chunks)
    carry = replicated(torch.zeros((b, h, p, n), dtype=torch.float32,
                                   device=xh.device), xh)
    # under autograd a chunk's O(q^2) buffers are rebuilt in the backward:
    # only its inputs are saved (the mask is closed over, as the JAX body
    # closes over it). The body reads no mesh context: its constants join
    # the mesh through ``replicated`` above, keyed to the operand
    per_chunk = functools.partial(_per_chunk, mask=mask, rep=rep)
    ys = []
    for c in range(nc):
        cut = slice(c * chunk, (c + 1) * chunk)
        args = (xh[:, cut], dt[:, cut], Bm[:, cut], Cm[:, cut], A)
        if torch.is_grad_enabled():
            y_intra, state, cums = checkpoint(per_chunk, *args,
                                              use_reentrant=False)
        else:
            y_intra, state, cums = per_chunk(*args)
        # inter-chunk output (no q^2 term): C . entering state . decay
        Ch = torch.repeat_interleave(Cm[:, cut], rep, dim=2)   # (b,q,h,n)
        decay_from_start = torch.exp(cums)                     # (b,q,h)
        if SSD_BF16:
            y_inter = torch.einsum("bqhn,bhpn,bqh->bqhp", _bf16(Ch),
                                   _bf16(carry), _bf16(decay_from_start))
        else:
            y_inter = torch.einsum("bqhn,bhpn,bqh->bqhp", Ch, carry,
                                   decay_from_start)
        ys.append(y_intra + y_inter)
        carry = carry * torch.exp(cums[:, -1, :])[:, :, None, None] + state
    y = torch.cat(ys, dim=1)
    return y[:, :s_orig], carry


def mamba_block(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                state: dict | None = None):
    """Mamba2 sublayer (no norm / residual). Returns (out, new_state).

    Without ``state`` a prefill of the whole sequence, whose new_state is
    the decode handoff; with ``state`` ({"conv": (B, K-1, C), "ssm": (B, H,
    P, N)}) one token's recurrent update. The conv state holds the
    pre-activation taps."""
    di, gn, n, h = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    pp = cfg.ssm_head_dim
    proj = torch.einsum("bsd,de->bse", x, gather_fsdp(
        p["in_proj"].to(ACT_DTYPE), "embed_fsdp", "ssm_inner"))
    proj = shard(proj, "batch", None, "ssm_inner")
    z, xbc, dt = _split_proj(cfg, proj)
    A = -torch.exp(p["A_log"])  # (H,)
    if state is None:
        xbc_raw = xbc
        xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
        xpart = xbc[..., :di]
        Bm = xbc[..., di: di + gn * n].reshape(*xbc.shape[:2], gn, n)
        Cm = xbc[..., di + gn * n:].reshape(*xbc.shape[:2], gn, n)
        dtv = F.softplus(dt.float() + p["dt_bias"])            # (B,S,H)
        xh = xpart.reshape(*xpart.shape[:2], h, pp)
        y, final = ssd_chunked(xh.float(), dtv, A, Bm.float(), Cm.float(),
                               cfg.ssm_chunk)
        y = y + xh.float() * p["D"][:, None]
        new_state = {
            "conv": xbc_raw[:, -(cfg.ssm_conv - 1):, :].to(ACT_DTYPE),
            "ssm": final,
        }
    else:
        window = torch.cat([state["conv"], xbc], dim=1)       # (B,K,C)
        w = p["conv_w"].to(window.dtype)
        conv_out = silu((window * w[None]).sum(dim=1, keepdim=True)
                        + p["conv_b"].to(window.dtype))
        new_conv = window[:, 1:]
        xpart = conv_out[..., :di]
        Bm = conv_out[..., di: di + gn * n].reshape(-1, 1, gn, n)
        Cm = conv_out[..., di + gn * n:].reshape(-1, 1, gn, n)
        dtv = F.softplus(dt.float() + p["dt_bias"])            # (B,1,H)
        xh = xpart.reshape(-1, 1, h, pp).float()
        rep = h // gn
        Bh = torch.repeat_interleave(Bm, rep, dim=2).float()   # (B,1,H,N)
        Ch = torch.repeat_interleave(Cm, rep, dim=2).float()
        dA = torch.exp(dtv[:, 0, :] * A)                       # (B,H)
        ssm = state["ssm"].float()                             # (B,H,P,N)
        upd = torch.einsum("bhn,bhp->bhpn", Bh[:, 0] * dtv[:, 0, :, None],
                           xh[:, 0])
        ssm_new = ssm * dA[:, :, None, None] + upd
        y = torch.einsum("bhn,bhpn->bhp", Ch[:, 0], ssm_new)[:, None]
        y = y + xh * p["D"][:, None]
        new_state = {"conv": new_conv,
                     "ssm": ssm_new.to(state["ssm"].dtype)}
    y = y.to(ACT_DTYPE)
    # gated per-head RMS norm (over a head's P channels)
    yh = y.reshape(*y.shape[:2], h, pp)
    yn = _gated_norm(yh, z, p["ssm_norm"].reshape(h, pp), cfg.norm_eps)
    y = yn.reshape(*yn.shape[:2], di).to(ACT_DTYPE)
    out = torch.einsum("bse,ed->bsd", y, gather_fsdp(
        p["out_proj"].to(ACT_DTYPE), "ssm_inner", "embed_fsdp"))
    return out, new_state


def _gated_norm(yh, z, scale_h, eps):
    """RMSNorm(y * silu(z)) per head (the norm over head_dim only)."""
    zh = z.reshape(yh.shape)
    g = yh * silu(zh.float()).to(yh.dtype)
    gf = g.float()
    var = torch.mean(gf * gf, dim=-1, keepdim=True)
    return (gf * torch.rsqrt(var + eps) * scale_h).to(yh.dtype)


def init_mamba_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device="cuda") -> dict:
    """A zero decode state: the conv taps in the activation dtype, the SSM
    state in ``dtype`` (fp32)."""
    dev = resolve_device(device)
    conv_ch = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch),
                            dtype=ACT_DTYPE, device=dev),
        "ssm": torch.zeros((batch, cfg.ssm_nheads, cfg.ssm_head_dim,
                            cfg.ssm_state), dtype=dtype, device=dev),
    }
