"""Config dataclasses for model architectures and input shapes.

Every assigned architecture gets one module in this package exporting
``CONFIG``; the registry in ``__init__`` collects them. Shapes are global
(the assignment pairs every LM arch with the same 4 shapes).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field


def pad_to(x: int, mult: int) -> int:
    """Smallest multiple of ``mult`` that is >= x."""
    return ((x + mult - 1) // mult) * mult


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class ModelConfig:
    """A generic LM-family architecture description.

    ``family`` selects the high-level wiring:
      dense  - attention + dense MLP every layer
      moe    - attention + MoE MLP (per ``moe_every``)
      ssm    - Mamba2 mixer only (no MLP when d_ff == 0)
      hybrid - Mamba2 + attention interleave (``attn_every``), MoE per
               ``moe_every``
      vlm    - dense backbone, input_mode="embeddings" for train/prefill
      audio  - encoder-only dense backbone, input_mode="embeddings"
    """

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    causal: bool = True
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1  # MoE on layers with index % moe_every == moe_every-1
    n_shared_experts: int = 0
    # SSM (Mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_ngroups: int = 1
    attn_every: int = 0  # hybrid: attention on layers with index % attn_every == attn_offset
    attn_offset: int = 3
    # modality frontend (stub per assignment: embeddings provided directly)
    input_mode: str = "tokens"  # "tokens" | "embeddings"
    # notes for DESIGN/EXPERIMENTS
    source: str = ""

    # ---- derived ----
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def supports_decode(self) -> bool:
        return self.causal

    @property
    def subquadratic(self) -> bool:
        """Whether long_500k decode is admissible.

        Pure full-attention archs are skipped for long_500k per the
        assignment. SSM and hybrid (mostly-SSM) archs run it.
        """
        return self.family in ("ssm", "hybrid")

    def layer_kinds(self) -> list[tuple[str, str]]:
        """Per-layer (mixer, mlp) kinds.

        mixer in {"attn", "ssm"}; mlp in {"dense", "moe", "none"}.
        """
        kinds = []
        for i in range(self.n_layers):
            if self.family == "ssm":
                mixer = "ssm"
            elif self.family == "hybrid":
                mixer = "attn" if (self.attn_every and i % self.attn_every == self.attn_offset) else "ssm"
            else:
                mixer = "attn"
            if self.d_ff == 0:
                mlp = "none"
            elif self.n_experts and (i % self.moe_every == self.moe_every - 1):
                mlp = "moe"
            else:
                mlp = "dense"
            kinds.append((mixer, mlp))
        return kinds

    def scan_period(self) -> int:
        """Layers are scanned in super-blocks of this period (homogeneous
        across blocks). lcm of the interleave patterns."""
        p = 1
        if self.family == "hybrid" and self.attn_every:
            p = math.lcm(p, self.attn_every)
        if self.n_experts and self.moe_every > 1:
            p = math.lcm(p, self.moe_every)
        assert self.n_layers % p == 0, (self.name, p, self.n_layers)
        return p

    # ---- padding for the TP axis (divisibility policy; see DESIGN §5) ----
    def padded_vocab(self, mult: int = 256) -> int:
        return pad_to(self.vocab_size, mult)

    def padded_heads(self, tp: int) -> int:
        return pad_to(self.n_heads, tp) if self.n_heads % tp else self.n_heads

    def padded_kv_heads(self, tp: int) -> int:
        # repeat KV heads up to tp when fewer than tp (standard TP serving)
        if self.n_kv_heads >= tp:
            return pad_to(self.n_kv_heads, tp) if self.n_kv_heads % tp else self.n_kv_heads
        return tp

    def padded_experts(self, tp: int) -> int:
        if not self.n_experts:
            return 0
        return pad_to(self.n_experts, tp) if self.n_experts % tp else self.n_experts

    def param_count(self) -> int:
        """Total parameter count N (exact for our wiring, unpadded dims)."""
        d, hd = self.d_model, self.resolved_head_dim
        total = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d  # lm head
        for mixer, mlp in self.layer_kinds():
            total += d  # pre-mixer norm
            if mixer == "attn":
                total += d * self.n_heads * hd  # q
                total += 2 * d * self.n_kv_heads * hd  # k, v
                total += self.n_heads * hd * d  # o
                if self.qkv_bias:
                    total += (self.n_heads + 2 * self.n_kv_heads) * hd
            else:  # ssm
                di, ng, st, nh = self.d_inner, self.ssm_ngroups, self.ssm_state, self.ssm_nheads
                total += d * (2 * di + 2 * ng * st + nh)  # in_proj
                total += self.ssm_conv * (di + 2 * ng * st)  # conv
                total += 3 * nh  # A_log, D, dt_bias
                total += di  # gated norm
                total += di * d  # out_proj
            if mlp != "none":
                total += d  # pre-mlp norm
            if mlp == "dense":
                total += 3 * d * self.d_ff
            elif mlp == "moe":
                total += self.n_experts * 3 * d * self.d_ff
                total += d * self.n_experts  # router
                total += self.n_shared_experts * 3 * d * self.d_ff
        total += d  # final norm
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top_k experts count)."""
        if not self.n_experts:
            return self.param_count()
        dense_moe_delta = 0
        for _, mlp in self.layer_kinds():
            if mlp == "moe":
                dense_moe_delta += (self.n_experts - self.top_k) * 3 * self.d_model * self.d_ff
        return self.param_count() - dense_moe_delta


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    period = cfg.scan_period()
    changes = dict(
        n_layers=2 * period,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=128,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        n_shared_experts=min(cfg.n_shared_experts, 1),
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16,
        ssm_chunk=8,
        name=cfg.name + "-smoke",
    )
    return dataclasses.replace(cfg, **changes)
