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

__all__ = ["DGNNConfig", "DatasetConfig", "EVOLVEGCN", "GCRN_M2", "BC_ALPHA",
           "UCI", "DGNN_CONFIGS", "DATASETS"]
