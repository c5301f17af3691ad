"""Parameters and recurrent states carried over from the JAX package.

JAX's PRNG cannot be reproduced in torch, so a comparison of the two
packages feeds both the same parameters: the JAX pytrees, flattened to
numpy (``jax.tree.map(np.asarray, tree)``), become the port's tensors. The
two packages lay out their parameters alike, so the conversion is
structural; it checks every key and shape (and, for the LM, dtype) against
the port's own layout.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.dgnn import DGNNConfig
from repro_torch.core.dataflow import build_model
from repro_torch.models.lm import RuntimeConfig, init_params
from repro_torch.optim import tree_leaves


def _convert(ref, src, path: str, leaf=None):
    """``src`` (numpy leaves) as tensors, checked key by key and shape by
    shape against the layout ``ref``; ``leaf(ref, array, path)`` converts a
    leaf (float32 by default)."""
    if isinstance(ref, dict):
        if not isinstance(src, dict) or set(src) != set(ref):
            got = sorted(src) if isinstance(src, dict) else type(src).__name__
            raise ValueError(f"{path or 'params'}: expected keys "
                             f"{sorted(ref)}, got {got}")
        return {k: _convert(ref[k], src[k], f"{path}.{k}" if path else k,
                            leaf) for k in ref}
    if isinstance(ref, list):
        if not isinstance(src, (list, tuple)) or len(src) != len(ref):
            raise ValueError(f"{path}: expected a list of {len(ref)}")
        return [_convert(r, s, f"{path}[{i}]", leaf)
                for i, (r, s) in enumerate(zip(ref, src))]
    a = np.asarray(src)
    if a.shape != tuple(ref.shape):
        raise ValueError(f"{path}: shape {a.shape}, expected "
                         f"{tuple(ref.shape)}")
    return _tensor(a) if leaf is None else leaf(ref, a, path)


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


#: numpy's name of each parameter dtype (bfloat16 is ml_dtypes', which JAX
#: hands out)
_NP_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def _lm_leaf(ref: torch.Tensor, a: np.ndarray, path: str) -> torch.Tensor:
    if a.dtype.name != _NP_NAMES[ref.dtype]:
        raise ValueError(f"{path}: dtype {a.dtype.name}, expected "
                         f"{_NP_NAMES[ref.dtype]}")
    a = np.ascontiguousarray(a)
    if ref.dtype == torch.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def lm_params_from_jax(cfg: ModelConfig, rt: RuntimeConfig,
                       params_np) -> dict:
    """The JAX LM's parameters (``repro.models.init_params(...)[0]`` with
    numpy leaves) as the port's tensors on the CPU, every key, shape and
    dtype checked against the port's own layout for (cfg, rt), which is
    built on the ``meta`` device (no allocation, at any width)."""
    return _convert(init_params(cfg, rt, device="meta"), params_np, "",
                    _lm_leaf)


def _moment(a, shape, path: str):
    """One moment leaf: an array (fp32 / bf16) or an int8 {"q", "scale"}
    dict, as tensors on the CPU."""
    if isinstance(a, dict):
        if set(a) != {"q", "scale"}:
            raise ValueError(f"{path}: expected keys ['q', 'scale'], got "
                             f"{sorted(a)}")
        q, scale = np.asarray(a["q"]), np.asarray(a["scale"])
        if q.dtype != np.int8 or q.shape != (tuple(shape) or (1,)):
            raise ValueError(f"{path}: q {q.dtype} {q.shape}, expected int8 "
                             f"{tuple(shape)}")
        return {"q": torch.from_numpy(q.copy()),
                "scale": _tensor(scale)}
    a = np.asarray(a)
    if a.shape != tuple(shape):
        raise ValueError(f"{path}: shape {a.shape}, expected {tuple(shape)}")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)
                                .copy()).view(torch.bfloat16)
    return _tensor(a)


def opt_state_from_jax(params_np, opt_np) -> dict:
    """A JAX optimizer state (``repro.optim.init_opt_state`` or a step's
    result, numpy leaves: float32 / bfloat16 arrays, or int8 {"q", "scale"}
    dicts) as the port's (``repro_torch.optim``) on the CPU: the flat "m"
    and "v" lists, checked leaf by leaf against the shapes of ``params_np``
    (the parameters, numpy, in the JAX package's order of leaves), and the
    step as a host int32 scalar."""
    shapes = [np.shape(a) for a in tree_leaves(params_np)]
    out = {}
    for key in ("m", "v"):
        got = opt_np[key]
        if len(got) != len(shapes):
            raise ValueError(f"opt[{key!r}]: {len(got)} leaves, the "
                             f"parameters {len(shapes)}")
        out[key] = [_moment(a, s, f"opt[{key!r}][{i}]")
                    for i, (a, s) in enumerate(zip(got, shapes))]
    out["step"] = torch.tensor(int(np.asarray(opt_np["step"])),
                               dtype=torch.int32)
    return out
