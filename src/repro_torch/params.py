"""Parameters and recurrent states carried over from the JAX package.

JAX's PRNG cannot be reproduced in torch, so a comparison of the two
packages feeds both the same parameters: the JAX pytrees, flattened to
numpy (``jax.tree.map(np.asarray, tree)``), become the port's tensors. The
two packages lay out their parameters alike, so the conversion is
structural; it checks every key and shape against the port's own layout.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.dgnn import DGNNConfig
from repro_torch.core.dataflow import build_model


def _convert(ref, src, path: str):
    if isinstance(ref, dict):
        if not isinstance(src, dict) or set(src) != set(ref):
            got = sorted(src) if isinstance(src, dict) else type(src).__name__
            raise ValueError(f"{path or 'params'}: expected keys "
                             f"{sorted(ref)}, got {got}")
        return {k: _convert(ref[k], src[k], f"{path}.{k}" if path else k)
                for k in ref}
    if isinstance(ref, list):
        if not isinstance(src, (list, tuple)) or len(src) != len(ref):
            raise ValueError(f"{path}: expected a list of {len(ref)}")
        return [_convert(r, s, f"{path}[{i}]")
                for i, (r, s) in enumerate(zip(ref, src))]
    a = np.asarray(src)
    if a.shape != tuple(ref.shape):
        raise ValueError(f"{path}: shape {a.shape}, expected "
                         f"{tuple(ref.shape)}")
    return _tensor(a)


def params_from_jax(cfg: DGNNConfig, params_np) -> dict:
    """The JAX model's parameters (numpy leaves) as the port's tensors on
    the CPU, checked against the port's parameter layout for ``cfg``."""
    model = build_model(cfg)
    return _convert(model.init(torch.Generator().manual_seed(0)), params_np,
                    "")


_STATE_KEYS = {"integrated": {"h", "c"}, "stacked": {"h"},
               "weights_evolved": {"weights"}, "event_memory": {"mem"},
               "static": set()}


def state_from_jax(cfg: DGNNConfig, state_np) -> dict:
    """A JAX recurrent state (numpy leaves, any leading batch axis) as the
    port's tensors on the CPU: {"h", "c"} stores for GCRN, {"h"} for the
    stacked DGNN, {"weights"} for EvolveGCN, {"mem"} for TGN and {} for
    the static GCN."""
    keys = _STATE_KEYS.get(cfg.dgnn_type)
    if keys is None:
        raise ValueError(f"no recurrent state layout for dgnn_type "
                         f"{cfg.dgnn_type!r}")
    if set(state_np) != keys:
        raise ValueError(f"state: expected keys {sorted(keys)}, got "
                         f"{sorted(state_np)}")
    return {k: ([_tensor(w) for w in v] if k == "weights" else _tensor(v))
            for k, v in state_np.items()}


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(a), dtype=np.float32))
