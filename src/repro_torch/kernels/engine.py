"""Build, bind and launch the hand-written CUDA kernels.

Eight kernels, one source each under ``csrc/``: the stream engines of the
three dense-snapshot families (``gcrn_engine.cu``, ``evolve_engine.cu``,
``stacked_engine.cu``), of the event-driven TGN (``tgn_engine.cu``) and of
the static GCN (``static_engine.cu``), all level v3; the V2 fused steps
(``gcrn_step.cu``, ``stacked_step.cu``); and the ELL SpMM of the
message-passing stage (``ell_spmm.cu``, ``impl="pallas"``). Each source is compiled by ``nvcc``
at first use into a shared library with a plain C interface, keyed by a
hash of the sources and flags, under ``build/repro_torch/`` at the
checkout root (``REPRO_TORCH_BUILD_DIR`` overrides it), and loaded with
``ctypes``.

Each wrapper takes packed tensors (kernels/ops.py packs them):

* on CPU tensors it runs the kernel's plain PyTorch version (kernels/ref.py);
* on CUDA tensors it checks them, allocates outputs and scratch, launches
  the kernel on the current stream and counts the launch in ``LAUNCHES``;
  a build or launch error raises, and nothing falls back to the plain path;
* any other device raises.

Index tensors are range-checked before a launch (one device sync).
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path

import torch

from repro_torch.kernels import ref as _ref

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("gcrn_engine", "evolve_engine", "stacked_engine", "tgn_engine",
           "static_engine", "gcrn_step", "stacked_step", "ell_spmm")

#: the kernels' register micro-tile: each thread owns this many node rows
#: (and, in the evolve kernel, this many columns of W). The kernels take
#: any node count; the evolve kernel needs its square width D to be a
#: multiple of it, which kernels/ops.py pads to.
ROW_ALIGN = 8
#: a CTA's shared memory on Hopper (227 KB)
SMEM_LIMIT = 232448

#: launches per kernel since the last ``reset_launches()``; only a real
#: kernel launch counts, never the plain path
LAUNCHES = {name: 0 for name in KERNELS}

_LIBS: dict = {}
_LOCK = threading.Lock()
BUILD_LOG: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA stream-engine kernels are built from "
            f"{CSRC} at first use and need the CUDA toolkit")
    return path


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return build_dir() / f"lib{name}_{_digest(name)}.so"


def build(names=KERNELS) -> dict:
    """Compile the named kernels that are not built yet, one ``nvcc`` per
    source, all running at once. Returns {name: library path}; raises if
    any compile fails. The compiler's output (``-Xptxas -v``: registers,
    shared memory, spills) lands in ``BUILD_LOG``."""
    nvcc = _nvcc()
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = _lib_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: _lib_path(name) for name in names}


#: C signature of each kernel library: (pointer arguments of ``<name>_launch``
#: before its ints, its int arguments, int arguments of ``<name>_smem_bytes``
#: or 0 where the kernel uses no dynamic shared memory); the stream pointer
#: comes last
_SIGNATURES = {
    "gcrn_engine": (15, 8, 3),
    "evolve_engine": (13, 6, 2),
    "stacked_engine": (15, 9, 4),
    "tgn_engine": (13, 7, 3),
    "static_engine": (9, 5, 2),
    "gcrn_step": (12, 4, 3),
    "stacked_step": (12, 5, 4),
    "ell_spmm": (6, 6, 0),
}


def _library(name: str):
    """The loaded kernel library, built first if needed. Raises where the
    card or the toolkit is missing."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{name}: no CUDA device; the kernel runs only on the card "
                "(pass CPU tensors for the plain PyTorch version)")
        lib = ctypes.CDLL(str(build((name,))[name]))
        vp, i = ctypes.c_void_p, ctypes.c_int
        n_ptr, n_int, n_smem = _SIGNATURES[name]
        launch = getattr(lib, f"{name}_launch")
        launch.argtypes = [vp] * n_ptr + [i] * n_int + [vp]
        launch.restype = i
        if n_smem:
            smem = getattr(lib, f"{name}_smem_bytes")
            smem.argtypes = [i] * n_smem
            smem.restype = ctypes.c_size_t
        err = getattr(lib, f"{name}_error_string")
        err.argtypes, err.restype = [i], ctypes.c_char_p
        _LIBS[name] = lib
        return lib


def _check(name: str, device, **tensors) -> None:
    for key, (t, dtype) in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: {key} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def _check_index(name: str, key: str, t, bound: int) -> None:
    """Index tensors come from the host's ingest; an out-of-range id would
    read outside a buffer in the kernel, so check before the launch."""
    lo, hi = torch.aminmax(t)
    if int(lo) < 0 or int(hi) >= bound:
        raise ValueError(f"{name}: {key} ids span [{int(lo)}, {int(hi)}], "
                         f"outside [0, {bound})")


def _check_smem(name: str, smem: int, dims: str) -> None:
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: {dims} need {smem} bytes of shared "
                         f"memory, over {SMEM_LIMIT}")


def _stream_ptr():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _launch(name: str, lib, *args) -> None:
    code = getattr(lib, f"{name}_launch")(*args)
    if code != 0:
        msg = getattr(lib, f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {code})")
    LAUNCHES[name] += 1


def _device_kind(name: str, t: torch.Tensor) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"{name}: tensors on {t.device} are not supported "
                     "(cuda runs the kernel, cpu the plain version)")


# ------------------------------------------------------------- gcrn ----

def gcrn_plain(idx, coef, eidx, x, rowg, mask, h0, c0, wx, wh, b, emsg=None):
    """The GCRN kernel's function in plain PyTorch, on the same packed
    inputs: ``rowg`` is the global row per node, ``G`` (the store height)
    on padding rows."""
    ren = torch.where(rowg < h0.shape[1], rowg, -1)
    return _ref.gcrn_stream_batched_ref(idx, coef, eidx, x, ren, mask, h0,
                                        c0, wx, wh, b, emsg)


def gcrn_engine(idx, coef, eidx, x, rowg, mask, h0, c0, wx, wh, b, emsg=None):
    """GC-LSTM over B streams of T steps in one launch.

    idx/eidx (B, T, n, k) int32, coef (B, T, n, k), x (B, T, n, din),
    rowg (B, T, n) int32 (G drops), mask (B, T, n), h0/c0 (B, G, H),
    wx (din, 4H), wh (H, 4H), b (4H,), emsg (B, T, e, din) or None; all
    float tensors float32, H a multiple of 4. Returns (outs (B, T, n, H), hT, cT)."""
    name = "gcrn_engine"
    if _device_kind(name, x) == "cpu":
        return gcrn_plain(idx, coef, eidx, x, rowg, mask, h0, c0, wx, wh, b,
                          emsg)
    B, T, n, k = idx.shape
    din, (G, H) = x.shape[-1], h0.shape[1:]
    f32, i32 = torch.float32, torch.int32
    _check(name, x.device, idx=(idx, i32), coef=(coef, f32), eidx=(eidx, i32),
           x=(x, f32), rowg=(rowg, i32), mask=(mask, f32), h0=(h0, f32),
           c0=(c0, f32), wx=(wx, f32), wh=(wh, f32), b=(b, f32),
           emsg=(emsg, f32))
    if (coef.shape != idx.shape or eidx.shape != idx.shape
            or x.shape[:3] != (B, T, n) or rowg.shape != (B, T, n)
            or mask.shape != (B, T, n) or h0.shape != (B, G, H)
            or c0.shape != (B, G, H) or wx.shape != (din, 4 * H)
            or wh.shape != (H, 4 * H) or b.shape != (4 * H,)
            or (emsg is not None and (emsg.shape[:2] != (B, T)
                                      or emsg.shape[3] != din))):
        raise ValueError(f"{name}: inconsistent shapes")
    _check_index(name, "idx", idx, n)
    _check_index(name, "rowg", rowg, G + 1)
    if emsg is not None:
        _check_index(name, "eidx", eidx, emsg.shape[2])
    if H % 4:
        raise ValueError(f"{name}: H={H} must be a multiple of 4 (the "
                         "store rows move as float4)")
    lib = _library(name)
    _check_smem(name, lib.gcrn_engine_smem_bytes(k, din, H),
                f"k={k}, din={din}, H={H}")
    e = 0 if emsg is None else emsg.shape[2]
    outs = torch.empty((B, T, n, H), dtype=f32, device=x.device)
    hT, cT = h0.clone(), c0.clone()
    h_rows = torch.empty((B, n, H), dtype=f32, device=x.device)
    c_rows = torch.empty_like(h_rows)
    with torch.cuda.device(x.device):
        _launch(name, lib, _ptr(idx), _ptr(coef), _ptr(eidx), _ptr(x),
                _ptr(rowg), _ptr(mask), _ptr(wx), _ptr(wh), _ptr(b),
                _ptr(emsg), _ptr(outs), _ptr(hT), _ptr(cT), _ptr(h_rows),
                _ptr(c_rows), B, T, n, k, din, H, G, e, _stream_ptr())
    return outs, hT, cT


# ----------------------------------------------------------- evolve ----

def evolve_plain(idx, coef, x, mask, live, w0, bg, gwx, gwh, gb, eagg=None):
    """The EvolveGCN kernel's function in plain PyTorch, on the same packed
    inputs (every layer one square width D)."""
    L = w0.shape[1]
    ea = None if eagg is None else [eagg[:, :, l] for l in range(L)]
    outs, wT = _ref.evolve_stream_batched_ref(
        idx, coef, x, mask, live, [w0[:, l] for l in range(L)],
        list(bg), list(gwx), list(gwh), list(gb), ea)
    return outs, torch.stack(wT, dim=1)


def evolve_engine(idx, coef, x, mask, live, w0, bg, gwx, gwh, gb, eagg=None):
    """L-layer GCN with matrix-GRU-evolved weights over B streams of T
    steps in one launch.

    idx (B, T, n, k) int32, coef (B, T, n, k), x (B, T, n, D),
    mask (B, T, n), live (B, T) int32, w0 (B, L, D, D), bg (L, D),
    gwx/gwh (L, D, 3D), gb (L, 3D), eagg (B, T, L, n, D) or None; D a
    multiple of ``ROW_ALIGN``. Returns (outs (B, T, n, D), wT (B, L, D, D))."""
    name = "evolve_engine"
    if _device_kind(name, x) == "cpu":
        return evolve_plain(idx, coef, x, mask, live, w0, bg, gwx, gwh, gb,
                            eagg)
    B, T, n, k = idx.shape
    L, D = w0.shape[1], w0.shape[2]
    f32, i32 = torch.float32, torch.int32
    _check(name, x.device, idx=(idx, i32), coef=(coef, f32), x=(x, f32),
           mask=(mask, f32), live=(live, i32), w0=(w0, f32), bg=(bg, f32),
           gwx=(gwx, f32), gwh=(gwh, f32), gb=(gb, f32), eagg=(eagg, f32))
    if (coef.shape != idx.shape or x.shape != (B, T, n, D)
            or mask.shape != (B, T, n) or live.shape != (B, T)
            or w0.shape != (B, L, D, D) or bg.shape != (L, D)
            or gwx.shape != (L, D, 3 * D) or gwh.shape != (L, D, 3 * D)
            or gb.shape != (L, 3 * D)
            or (eagg is not None and eagg.shape != (B, T, L, n, D))):
        raise ValueError(f"{name}: inconsistent shapes")
    _check_index(name, "idx", idx, n)
    if D % ROW_ALIGN:
        raise ValueError(f"{name}: D={D} must be a multiple of {ROW_ALIGN}")
    lib = _library(name)
    _check_smem(name, lib.evolve_engine_smem_bytes(k, D), f"k={k}, D={D}")
    outs = torch.empty((B, T, n, D), dtype=f32, device=x.device)
    wT = w0.clone()
    act = torch.empty((B, 2, n, D), dtype=f32, device=x.device)
    with torch.cuda.device(x.device):
        _launch(name, lib, _ptr(idx), _ptr(coef), _ptr(x), _ptr(mask),
                _ptr(live), _ptr(bg), _ptr(gwx), _ptr(gwh), _ptr(gb),
                _ptr(eagg), _ptr(outs), _ptr(wT), _ptr(act), B, T, n, k, L,
                D, _stream_ptr())
    return outs, wT


# ---------------------------------------------------------- stacked ----

def stacked_plain(idx, coef, eidx, x, rowg, mask, h0, wg, bg, wx, wh, b,
                  emsg=None):
    """The stacked kernel's function in plain PyTorch, on the same packed
    inputs (``rowg`` as for ``gcrn_plain``)."""
    ren = torch.where(rowg < h0.shape[1], rowg, -1)
    return _ref.stacked_stream_batched_ref(idx, coef, eidx, x, ren, mask, h0,
                                           wg, bg, wx, wh, b, emsg)


def stacked_engine(idx, coef, eidx, x, rowg, mask, h0, wg, bg, wx, wh, b,
                   emsg=None):
    """The last GCN layer and the GRU over B streams of T steps in one
    launch.

    idx/eidx (B, T, n, k) int32, coef (B, T, n, k), x (B, T, n, din) (the
    last layer's input), rowg (B, T, n) int32 (G drops), mask (B, T, n),
    h0 (B, G, H), wg (din, dmid), bg (dmid,), wx (dmid, 3H), wh (H, 3H),
    b (3H,), emsg (B, T, e, din) or None; all float tensors float32, H a
    multiple of 4. Returns (outs (B, T, n, H), hT (B, G, H))."""
    name = "stacked_engine"
    if _device_kind(name, x) == "cpu":
        return stacked_plain(idx, coef, eidx, x, rowg, mask, h0, wg, bg, wx,
                             wh, b, emsg)
    B, T, n, k = idx.shape
    din, dmid, (G, H) = x.shape[-1], wg.shape[-1], h0.shape[1:]
    f32, i32 = torch.float32, torch.int32
    _check(name, x.device, idx=(idx, i32), coef=(coef, f32), eidx=(eidx, i32),
           x=(x, f32), rowg=(rowg, i32), mask=(mask, f32), h0=(h0, f32),
           wg=(wg, f32), bg=(bg, f32), wx=(wx, f32), wh=(wh, f32),
           b=(b, f32), emsg=(emsg, f32))
    if (coef.shape != idx.shape or eidx.shape != idx.shape
            or x.shape[:3] != (B, T, n) or rowg.shape != (B, T, n)
            or mask.shape != (B, T, n) or h0.shape != (B, G, H)
            or wg.shape != (din, dmid) or bg.shape != (dmid,)
            or wx.shape != (dmid, 3 * H) or wh.shape != (H, 3 * H)
            or b.shape != (3 * H,)
            or (emsg is not None and (emsg.shape[:2] != (B, T)
                                      or emsg.shape[3] != din))):
        raise ValueError(f"{name}: inconsistent shapes")
    _check_index(name, "idx", idx, n)
    _check_index(name, "rowg", rowg, G + 1)
    if emsg is not None:
        _check_index(name, "eidx", eidx, emsg.shape[2])
    if H % 4:
        raise ValueError(f"{name}: H={H} must be a multiple of 4 (the "
                         "store rows move as float4)")
    lib = _library(name)
    _check_smem(name, lib.stacked_engine_smem_bytes(k, din, dmid, H),
                f"k={k}, din={din}, dmid={dmid}, H={H}")
    e = 0 if emsg is None else emsg.shape[2]
    outs = torch.empty((B, T, n, H), dtype=f32, device=x.device)
    hT = h0.clone()
    h_rows = torch.empty((B, n, H), dtype=f32, device=x.device)
    with torch.cuda.device(x.device):
        _launch(name, lib, _ptr(idx), _ptr(coef), _ptr(eidx), _ptr(x),
                _ptr(rowg), _ptr(mask), _ptr(wg), _ptr(bg), _ptr(wx),
                _ptr(wh), _ptr(b), _ptr(emsg), _ptr(outs), _ptr(hT),
                _ptr(h_rows), B, T, n, k, din, dmid, H, G, e, _stream_ptr())
    return outs, hT


# -------------------------------------------------------------- tgn ----

def tgn_plain(gidx, coef, ts, x, rowg, mask, mem0, freq, w_in, wx, wh, b):
    """The TGN kernel's function in plain PyTorch, on the same packed
    inputs: partners read straight from the store by their global row
    ``gidx``, each node's own row by ``rowg`` (``G`` on padding rows,
    which read zeros and drop their write). Under the event contract
    (every live lane names a touched row of its batch) this is
    kernels/ref.py tgn_stream_batched_ref."""
    G = mem0.shape[1]
    store = mem0.clone()
    outs = []
    for t in range(gidx.shape[1]):
        ren = torch.where(rowg[:, t] < G, rowg[:, t], -1)
        c = coef[:, t][..., None]
        own = _ref._gather_rows(store, ren, mask[:, t])
        agg_m = (_ref._take_rows(store, gidx[:, t]) * c).sum(dim=-2)
        agg_e = (torch.cos(ts[:, t][..., None] * freq) * c).sum(dim=-2)
        inp = x[:, t] @ w_in + agg_m + agg_e
        m_new = _ref.fused_gru(inp, own, wx, wh, b) * mask[:, t][..., None]
        _ref._scatter_rows_(store, ren, m_new)
        outs.append(m_new)
    return torch.stack(outs, dim=1), store


def tgn_engine(gidx, coef, ts, x, rowg, mask, mem0, freq, w_in, wx, wh, b):
    """TGN node memory over B streams of T event batches in one launch.

    gidx (B, T, n, k) int32 global row of each event lane's partner,
    coef/ts (B, T, n, k) (lane weight, event time), x (B, T, n, din),
    rowg (B, T, n) int32 (G drops), mask (B, T, n), mem0 (B, G, H),
    freq (H,), w_in (din, H), wx/wh (H, 3H), b (3H,); all float tensors
    float32, H a multiple of 4. Returns (outs (B, T, n, H), memT (B, G, H))."""
    name = "tgn_engine"
    if _device_kind(name, x) == "cpu":
        return tgn_plain(gidx, coef, ts, x, rowg, mask, mem0, freq, w_in, wx,
                         wh, b)
    B, T, n, k = gidx.shape
    din, (G, H) = x.shape[-1], mem0.shape[1:]
    f32, i32 = torch.float32, torch.int32
    _check(name, x.device, gidx=(gidx, i32), coef=(coef, f32), ts=(ts, f32),
           x=(x, f32), rowg=(rowg, i32), mask=(mask, f32), mem0=(mem0, f32),
           freq=(freq, f32), w_in=(w_in, f32), wx=(wx, f32), wh=(wh, f32),
           b=(b, f32))
    if (coef.shape != gidx.shape or ts.shape != gidx.shape
            or x.shape[:3] != (B, T, n) or rowg.shape != (B, T, n)
            or mask.shape != (B, T, n) or mem0.shape != (B, G, H)
            or freq.shape != (H,) or w_in.shape != (din, H)
            or wx.shape != (H, 3 * H) or wh.shape != (H, 3 * H)
            or b.shape != (3 * H,)):
        raise ValueError(f"{name}: inconsistent shapes")
    _check_index(name, "gidx", gidx, G)
    _check_index(name, "rowg", rowg, G + 1)
    if H % 4:
        raise ValueError(f"{name}: H={H} must be a multiple of 4 (the "
                         "store rows move as float4)")
    lib = _library(name)
    _check_smem(name, lib.tgn_engine_smem_bytes(k, din, H),
                f"k={k}, din={din}, H={H}")
    outs = torch.empty((B, T, n, H), dtype=f32, device=x.device)
    memT = mem0.clone()
    with torch.cuda.device(x.device):
        _launch(name, lib, _ptr(gidx), _ptr(coef), _ptr(ts), _ptr(x),
                _ptr(rowg), _ptr(mask), _ptr(freq), _ptr(w_in), _ptr(wx),
                _ptr(wh), _ptr(b), _ptr(outs), _ptr(memT), B, T, n, k, din,
                H, G, _stream_ptr())
    return outs, memT


# ----------------------------------------------------------- static ----

def _check_static_t(idx) -> None:
    T = idx.shape[1]
    if T != 1:
        raise ValueError(
            f"static family runs with T == 1, got T={T}: a static-GCN "
            "'stream' has no recurrence — fold independent snapshots onto "
            "the batch axis instead (core.gcn.StaticGCN.step_stream does)")


def static_plain(idx, coef, x, mask, w, bg, eagg=None):
    """The static-GCN kernel's function in plain PyTorch, on the same
    packed inputs (every layer one square width D)."""
    ea = None if eagg is None else [eagg[:, :, l] for l in range(w.shape[0])]
    (outs,) = _ref.static_gcn_stream_batched_ref(idx, coef, x, mask, list(w),
                                                 list(bg), ea)
    return outs


def static_engine(idx, coef, x, mask, w, bg, eagg=None):
    """L-layer GCN over B independent snapshot slots (T = 1) in one launch,
    one CTA a slot.

    idx (B, 1, n, k) int32, coef (B, 1, n, k), x (B, 1, n, D),
    mask (B, 1, n), w (L, D, D) and bg (L, D) shared by the slots,
    eagg (B, 1, L, n, D) or None; float tensors float32. Returns
    outs (B, 1, n, D)."""
    name = "static_engine"
    _check_static_t(idx)
    if _device_kind(name, x) == "cpu":
        return static_plain(idx, coef, x, mask, w, bg, eagg)
    B, T, n, k = idx.shape
    L, D = w.shape[0], w.shape[-1]
    f32, i32 = torch.float32, torch.int32
    _check(name, x.device, idx=(idx, i32), coef=(coef, f32), x=(x, f32),
           mask=(mask, f32), w=(w, f32), bg=(bg, f32), eagg=(eagg, f32))
    if (coef.shape != idx.shape or x.shape != (B, T, n, D)
            or mask.shape != (B, T, n) or w.shape != (L, D, D)
            or bg.shape != (L, D)
            or (eagg is not None and eagg.shape != (B, T, L, n, D))):
        raise ValueError(f"{name}: inconsistent shapes")
    _check_index(name, "idx", idx, n)
    lib = _library(name)
    _check_smem(name, lib.static_engine_smem_bytes(k, D), f"k={k}, D={D}")
    outs = torch.empty((B, T, n, D), dtype=f32, device=x.device)
    act = torch.empty((B, 2, n, D), dtype=f32, device=x.device)
    with torch.cuda.device(x.device):
        _launch(name, lib, _ptr(idx), _ptr(coef), _ptr(x), _ptr(mask),
                _ptr(w), _ptr(bg), _ptr(eagg), _ptr(outs), _ptr(act), B, n,
                k, L, D, _stream_ptr())
    return outs


# ----------------------------------------- per-step kernels: V2, SpMM ----
# The per-step kernels take microseconds, so their wrappers split in two:
# ``prepare`` checks the tensors (index ranges included), allocates the
# outputs and marshals the C arguments; ``launch`` launches what was
# prepared (again, if called again: it overwrites the same outputs).
# chip_smoke.py times ``launch`` alone.

@dataclass(frozen=True)
class Prepared:
    """A per-step kernel launch, ready to go: its library, its C arguments
    (on the stream current at ``prepare``), the outputs it writes, and the
    input tensors whose memory the arguments point at (held here)."""

    name: str
    lib: object
    args: tuple
    result: object
    inputs: tuple


def launch(p: Prepared):
    """Launch a prepared kernel; returns its outputs."""
    _launch(p.name, p.lib, *p.args)
    return p.result


def prepare(name: str, *args, **kwargs) -> Prepared:
    """Check, allocate and marshal one launch of the per-step kernel
    ``name`` ("gcrn_step", "stacked_step" or "ell_spmm") on CUDA tensors,
    with that wrapper's arguments."""
    return _PREPARE[name](*args, **kwargs)


def gcrn_step_plain(idx, coef, eidx, x, h, c, wx, wh, b, emsg=None):
    """The V2 GC-LSTM step kernel's function in plain PyTorch."""
    return _ref.dgnn_fused_step(idx, coef, eidx, x, h, c, wx, wh, b, emsg)


def gcrn_step(idx, coef, eidx, x, h, c, wx, wh, b, emsg=None):
    """One GC-LSTM step of one snapshot, aggregation to LSTM update.

    idx/eidx (n, k) int32, coef (n, k), x (n, din), h/c (n, H),
    wx (din, 4H), wh (H, 4H), b (4H,), emsg (e, din) or None; float tensors
    float32. Returns (h', c'), each (n, H), unmasked."""
    if _device_kind("gcrn_step", x) == "cpu":
        return gcrn_step_plain(idx, coef, eidx, x, h, c, wx, wh, b, emsg)
    return launch(_prepare_gcrn_step(idx, coef, eidx, x, h, c, wx, wh, b,
                                     emsg))


def _prepare_gcrn_step(idx, coef, eidx, x, h, c, wx, wh, b, emsg=None) -> Prepared:
    name = "gcrn_step"
    n, k = idx.shape
    din, H = x.shape[-1], h.shape[-1]
    f32, i32 = torch.float32, torch.int32
    _check(name, x.device, idx=(idx, i32), coef=(coef, f32), eidx=(eidx, i32),
           x=(x, f32), h=(h, f32), c=(c, f32), wx=(wx, f32), wh=(wh, f32),
           b=(b, f32), emsg=(emsg, f32))
    if (coef.shape != idx.shape or eidx.shape != idx.shape
            or x.shape != (n, din) or h.shape != (n, H) or c.shape != (n, H)
            or wx.shape != (din, 4 * H) or wh.shape != (H, 4 * H)
            or b.shape != (4 * H,)
            or (emsg is not None and (emsg.dim() != 2
                                      or emsg.shape[1] != din))):
        raise ValueError(f"{name}: inconsistent shapes")
    _check_index(name, "idx", idx, n)
    if emsg is not None:
        _check_index(name, "eidx", eidx, emsg.shape[0])
    lib = _library(name)
    _check_smem(name, lib.gcrn_step_smem_bytes(k, din, H),
                f"k={k}, din={din}, H={H}")
    h_out = torch.empty((n, H), dtype=f32, device=x.device)
    c_out = torch.empty_like(h_out)
    with torch.cuda.device(x.device):
        args = (_ptr(idx), _ptr(coef), _ptr(eidx), _ptr(x), _ptr(h), _ptr(c),
                _ptr(wx), _ptr(wh), _ptr(b), _ptr(emsg), _ptr(h_out),
                _ptr(c_out), n, k, din, H, _stream_ptr())
    return Prepared(name, lib, args, (h_out, c_out),
                    (idx, coef, eidx, x, h, c, wx, wh, b, emsg))


def stacked_step_plain(idx, coef, eidx, x, h, wg, bg, wx, wh, b, emsg=None):
    """The V2 GCN -> GRU step kernel's function in plain PyTorch."""
    return _ref.stacked_fused_step(idx, coef, eidx, x, h, wg, bg, wx, wh, b,
                                   emsg)


def stacked_step(idx, coef, eidx, x, h, wg, bg, wx, wh, b, emsg=None):
    """One GCN -> GRU step of one snapshot: aggregation, linear node
    transform, GRU against each node's own h.

    idx/eidx (n, k) int32, coef (n, k), x (n, din), h (n, H),
    wg (din, dmid), bg (dmid,), wx (dmid, 3H), wh (H, 3H), b (3H,),
    emsg (e, din) or None; float tensors float32. Returns h' (n, H),
    unmasked."""
    if _device_kind("stacked_step", x) == "cpu":
        return stacked_step_plain(idx, coef, eidx, x, h, wg, bg, wx, wh, b,
                                  emsg)
    return launch(_prepare_stacked_step(idx, coef, eidx, x, h, wg, bg, wx,
                                        wh, b, emsg))


def _prepare_stacked_step(idx, coef, eidx, x, h, wg, bg, wx, wh, b,
                          emsg=None) -> Prepared:
    name = "stacked_step"
    n, k = idx.shape
    din, dmid, H = x.shape[-1], wg.shape[-1], h.shape[-1]
    f32, i32 = torch.float32, torch.int32
    _check(name, x.device, idx=(idx, i32), coef=(coef, f32), eidx=(eidx, i32),
           x=(x, f32), h=(h, f32), wg=(wg, f32), bg=(bg, f32), wx=(wx, f32),
           wh=(wh, f32), b=(b, f32), emsg=(emsg, f32))
    if (coef.shape != idx.shape or eidx.shape != idx.shape
            or x.shape != (n, din) or h.shape != (n, H)
            or wg.shape != (din, dmid) or bg.shape != (dmid,)
            or wx.shape != (dmid, 3 * H) or wh.shape != (H, 3 * H)
            or b.shape != (3 * H,)
            or (emsg is not None and (emsg.dim() != 2
                                      or emsg.shape[1] != din))):
        raise ValueError(f"{name}: inconsistent shapes")
    _check_index(name, "idx", idx, n)
    if emsg is not None:
        _check_index(name, "eidx", eidx, emsg.shape[0])
    lib = _library(name)
    _check_smem(name, lib.stacked_step_smem_bytes(k, din, dmid, H),
                f"k={k}, din={din}, dmid={dmid}, H={H}")
    out = torch.empty((n, H), dtype=f32, device=x.device)
    with torch.cuda.device(x.device):
        args = (_ptr(idx), _ptr(coef), _ptr(eidx), _ptr(x), _ptr(h), _ptr(wg),
                _ptr(bg), _ptr(wx), _ptr(wh), _ptr(b), _ptr(emsg), _ptr(out),
                n, k, din, dmid, H, _stream_ptr())
    return Prepared(name, lib, args, out,
                    (idx, coef, eidx, x, h, wg, bg, wx, wh, b, emsg))


def ell_spmm_plain(idx, coef, eidx, x, emsg=None):
    """The ELL SpMM kernel's function in plain PyTorch."""
    return _ref.ell_spmm(idx, coef, eidx, x, emsg)


def ell_spmm(idx, coef, eidx, x, emsg=None):
    """out[..., v, :] = sum_s coef[..., v, s] * (x[..., idx[..., v, s], :]
    + emsg[..., eidx[..., v, s], :]) over L independent graphs.

    idx/eidx (..., n, k) int32, coef (..., n, k), x (..., nx, d),
    emsg (..., e, d) or None; the leading axes are shared (at most 65535
    graphs); float tensors float32. Returns (..., n, d)."""
    if _device_kind("ell_spmm", x) == "cpu":
        return ell_spmm_plain(idx, coef, eidx, x, emsg)
    return launch(_prepare_ell_spmm(idx, coef, eidx, x, emsg))


def _prepare_ell_spmm(idx, coef, eidx, x, emsg=None) -> Prepared:
    name = "ell_spmm"
    lead, (n, k) = idx.shape[:-2], idx.shape[-2:]
    nx, d = x.shape[-2:]
    f32, i32 = torch.float32, torch.int32
    _check(name, x.device, idx=(idx, i32), coef=(coef, f32), eidx=(eidx, i32),
           x=(x, f32), emsg=(emsg, f32))
    if (coef.shape != idx.shape or eidx.shape != idx.shape
            or x.shape[:-2] != lead
            or (emsg is not None and (emsg.shape[:-2] != lead
                                      or emsg.shape[-1] != d))):
        raise ValueError(f"{name}: inconsistent shapes")
    L = math.prod(lead)
    if L > 65535:
        raise ValueError(f"{name}: {L} graphs in one launch, over 65535")
    _check_index(name, "idx", idx, nx)
    if emsg is not None:
        _check_index(name, "eidx", eidx, emsg.shape[-2])
    lib = _library(name)
    e = 0 if emsg is None else emsg.shape[-2]
    out = torch.empty((*lead, n, d), dtype=f32, device=x.device)
    with torch.cuda.device(x.device):
        args = (_ptr(idx), _ptr(coef), _ptr(eidx), _ptr(x), _ptr(emsg),
                _ptr(out), L, n, k, nx, e, d, _stream_ptr())
    return Prepared(name, lib, args, out, (idx, coef, eidx, x, emsg))


_PREPARE = {"gcrn_step": _prepare_gcrn_step,
            "stacked_step": _prepare_stacked_step,
            "ell_spmm": _prepare_ell_spmm}
