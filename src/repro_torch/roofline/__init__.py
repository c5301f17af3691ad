from repro_torch.roofline.analysis import (
    HBM_BW,
    NVLINK_BW,
    PEAK_FLOPS,
    CollectiveStats,
    CostCounter,
    Roofline,
    collective_bytes,
    cost_analysis_dict,
    model_flops,
)

__all__ = [
    "HBM_BW", "NVLINK_BW", "PEAK_FLOPS", "CollectiveStats", "CostCounter",
    "Roofline", "collective_bytes", "cost_analysis_dict", "model_flops",
]
