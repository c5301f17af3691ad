"""Published peaks of the cards the benchmark runs on.

NVIDIA's H100 SXM data sheet, dense rates at the full 700 W power limit:
67 TFLOP/s in float32 outside the tensor cores (the engines compute in
fp32 on CUDA cores, TF32 off), 3.35 TB/s of HBM3 bandwidth. A card set
below 700 W runs slower under load; the run records its power limit
beside every share of these peaks.
"""
from __future__ import annotations

H100_SXM = {"fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}

#: peaks by the name ``torch.cuda.get_device_name()`` gives
PEAKS = {"NVIDIA H100 80GB HBM3": H100_SXM}


def peaks_for(kind: str):
    """The card's peaks, or None for a card the table does not hold."""
    return PEAKS.get(kind)


def least_seconds(flops: float, byts: float, peaks: dict) -> float:
    """The least time the card could take for ``flops`` operations and
    ``byts`` bytes: the larger of the compute and the memory bound."""
    return max(flops / peaks["fp32_flops"], byts / peaks["hbm_bytes_per_s"])
