"""Architecture, shape and DGNN registries (copies of ``repro.configs``).

``get_config(name)`` returns the full-size ModelConfig of any of the ten
LM architectures; ``SHAPES`` holds the four input shapes;
``runnable_cells()`` enumerates the (arch x shape) grid with the skip rules
applied. The DGNN configs and datasets are in ``configs/dgnn.py``.
"""
from __future__ import annotations

from repro_torch.configs.base import (
    SHAPES,
    ModelConfig,
    ShapeConfig,
    pad_to,
    reduce_for_smoke,
)
from repro_torch.configs.dgnn import (
    BC_ALPHA,
    DATASETS,
    DGNN_CONFIGS,
    EVOLVEGCN,
    GCRN_M2,
    UCI,
    DatasetConfig,
    DGNNConfig,
)

from repro_torch.configs import (  # noqa: E402  (registry imports)
    deepseek_coder_33b,
    granite_moe_3b,
    hubert_xlarge,
    internvl2_26b,
    jamba_v0p1_52b,
    llama4_maverick_400b,
    mamba2_2p7b,
    phi3_mini_3p8b,
    qwen2p5_14b,
    qwen3_32b,
)

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        mamba2_2p7b,
        deepseek_coder_33b,
        phi3_mini_3p8b,
        qwen2p5_14b,
        qwen3_32b,
        granite_moe_3b,
        llama4_maverick_400b,
        jamba_v0p1_52b,
        internvl2_26b,
        hubert_xlarge,
    )
}


def get_config(name: str) -> ModelConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}") from None


def list_archs() -> list[str]:
    return sorted(ARCHS)


def cell_status(cfg: ModelConfig, shape: ShapeConfig) -> str:
    """'run' or a skip reason."""
    if shape.is_decode and cfg.is_encoder_only:
        return "skip: encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.subquadratic:
        return "skip: long_500k needs sub-quadratic attention (pure full-attention arch)"
    return "run"


def runnable_cells() -> list[tuple[str, str]]:
    out = []
    for a in list_archs():
        for s in SHAPES.values():
            if cell_status(ARCHS[a], s) == "run":
                out.append((a, s.name))
    return out


__all__ = [
    "ARCHS",
    "SHAPES",
    "ModelConfig",
    "ShapeConfig",
    "get_config",
    "list_archs",
    "cell_status",
    "runnable_cells",
    "pad_to",
    "reduce_for_smoke",
    "DGNNConfig",
    "DatasetConfig",
    "EVOLVEGCN",
    "GCRN_M2",
    "BC_ALPHA",
    "UCI",
    "DGNN_CONFIGS",
    "DATASETS",
]
