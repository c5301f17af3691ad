"""Build, bind and launch the hand-written CUDA kernels.

Nineteen kernels from twelve sources under ``csrc/``: the stream engines of
the three dense-snapshot families (``gcrn_engine.cu``, ``evolve_engine.cu``,
``stacked_engine.cu``), of the event-driven TGN (``tgn_engine.cu``) and of
the static GCN (``static_engine.cu``), all level v3; the paged variants of
the four stateful engines (``<family>_engine_paged``, hbm_paged residency:
the same source compiled with its paging flag, the t-1 state staged
through a ring of td-wide windows); the V2 fused steps (``gcrn_step.cu``,
``stacked_step.cu``); the ELL SpMM of the message-passing stage
(``ell_spmm.cu``, ``impl="pallas"``); the fused GRU and LSTM cells
(``fused_rnn.cu``); EvolveGCN-O's edge terms, in the layout its engine
reads (``edge_terms.cu``); and the LM scaffold's flash attention: the
forward, with and without the logsumexp rows (``flash_attention.cu``), and
the backward's dK / dV and dQ passes (``flash_attention_bwd.cu``); their
wrappers and plain versions are in kernels/flash_attention.py. Each source is
compiled by ``nvcc`` at first use into a shared library with a plain C
interface, keyed by a hash of the sources and flags, under
``build/repro_torch/`` at the checkout root (``REPRO_TORCH_BUILD_DIR``
overrides it), and loaded with ``ctypes``.

Each wrapper takes packed tensors (kernels/ops.py packs them):

* on CPU tensors it runs the kernel's plain PyTorch version (kernels/ref.py,
  or the ``*_plain`` functions here);
* on CUDA tensors it checks them, allocates outputs and scratch, launches
  the kernel on the current stream and counts the launch in ``LAUNCHES``;
  a build or launch error raises, and nothing falls back to the plain path;
* any other device raises.

No kernel has a gradient of its own (as the JAX package's Pallas kernels,
which ``jax.grad`` refuses): every wrapper, on either device, raises where
autograd is on and a float input requires grad (``refuse_grad``); the
plain and ``force_ref`` paths stay differentiable. Only the flash
attention has a backward, as kernels of its own (``flash_mha``).

A stream engine's shared memory is estimated here (``smem_bytes``, equal to
each library's own ``<name>_smem_bytes``; for the cluster engines a CTA's)
and a launch over the card's 227 KB is refused on either device, with the
JAX package's hint: page the store, or shrink td. Index tensors are
range-checked before a launch (one device sync).

The four stateful stream engines (GCRN, EvolveGCN, stacked and TGN;
resident and paged) run one stream on a thread-block cluster of
``CLUSTER`` CTAs, each owning a slice of the state's columns;
``engine_cluster_config`` mirrors that launch and
``library_engine_cluster_config`` reads the launcher's own (card only). They
take any number of node rows a step: a CTA walks a step's tiles in chunks
of ``CHUNK_ROWS``. ``step_plan`` mirrors the launches of the V2 steps
(GC-LSTM and GCN -> GRU, whose unit slices share a row tile's aggregation,
and the stacked step's node transform, on a cluster of ``CLUSTER`` CTAs)
and of the ELL SpMM; ``library_step_plan`` reads the launchers' own (card
only). The static GCN engine runs a slot on a cluster of ``CLUSTER`` CTAs,
each owning a column slice of every layer at the layer's true width;
``static_plan`` mirrors its launch, ``library_static_plan`` reads the
launcher's (card only).

Two hooks serve the static checker (repro_torch.analysis). Inside
``recording_launches()`` every stream-engine launcher assembles its launch
(checks, outputs, scratch, the C arguments) on CPU or CUDA tensors alike
and records it instead of running it. And the eight stateful engine
variants take ``proto=True``: the launch then writes a protocol log of its
rings' issues and waits (and EvolveGCN's W planes), returned as a
``ProtoLog`` after the results; on CPU tensors the log is its plain
version, ``protocol_plain``. The main path passes neither.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import math
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from repro_torch import obs as _obs
from repro_torch.kernels import ref as _ref

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("gcrn_engine", "evolve_engine", "stacked_engine", "tgn_engine",
           "static_engine", "gcrn_step", "stacked_step", "ell_spmm",
           "gcrn_engine_paged", "evolve_engine_paged", "stacked_engine_paged",
           "tgn_engine_paged", "fused_gru", "fused_lstm", "flash_attention",
           "flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "edge_terms")
#: the source (``csrc/<source>.cu``, one library) of each kernel
SOURCE = {**{name: name for name in KERNELS[:8]},
          **{f"{family}_engine_paged": f"{family}_engine"
             for family in ("gcrn", "evolve", "stacked", "tgn")},
          "fused_gru": "fused_rnn", "fused_lstm": "fused_rnn",
          "flash_attention": "flash_attention",
          "flash_fwd": "flash_attention",
          "flash_bwd_dkv": "flash_attention_bwd",
          "flash_bwd_dq": "flash_attention_bwd",
          "edge_terms": "edge_terms"}

#: the multiple kernels/ops.py rounds the square width D of the evolve and
#: static packs up to: the evolve kernel needs it (its GRU's gwx / gwh
#: slabs are whole rows of it, and a cluster of 8 CTAs then splits D
#: evenly). The kernels take any node count.
ROW_ALIGN = 8
#: a CTA's shared memory on Hopper (227 KB)
SMEM_LIMIT = 232448
#: the kernels' node tile: rows a tile, floats between a k-major tile's columns
TILE_ROWS = 32
TILE_STRIDE = TILE_ROWS + 4
#: the cluster engines (gcrn_engine.cu, evolve_engine.cu, stacked_engine.cu,
#: tgn_engine.cu, both variants):
#: CTAs a cluster (one stream; a constant, so a stream's bits never depend
#: on the batch it rides in), threads a CTA, rows a paged window's TMA box
#: holds at most, the slots of the EvolveGCN GRU's gwx / gwh ring and the
#: rows of each, and the bytes of slack that align a CTA's shared memory
#: to 128
CLUSTER, CLUSTER_THREADS, BOX_ROWS, ALIGN_SLACK = 8, 256, 256, 128
GW_SLOTS, GW_ROWS = 2, 8
#: a stacked / TGN cluster CTA of at most this many units splits its GRU's K
#: loop over two threads an item, which exchange their sums through this
#: many floats of shared memory
SPLIT_UNITS = CLUSTER_THREADS // (2 * TILE_ROWS // 4)
SPLIT_FLOATS = TILE_ROWS // 4 * SPLIT_UNITS * 3 * 4
#: the resident EvolveGCN CTA's matrix-GRU threads, beside its
#: CLUSTER_THREADS GCN threads, and the 4-column groups each carries (12
#: sums a group wait in shared memory between its gwx and gwh passes)
GRU_THREADS, GRU_GROUPS = 128, 4
#: words of a cluster CTA's bitmask of live node tiles, and so the rows of
#: the chunks a step's tiles are walked in (any n is taken)
LIVE_WORDS = 64
CHUNK_ROWS = LIVE_WORDS * 32 * 32
CLUSTER_ENGINES = ("gcrn_engine", "gcrn_engine_paged", "evolve_engine",
                   "evolve_engine_paged", "stacked_engine",
                   "stacked_engine_paged", "tgn_engine", "tgn_engine_paged")
#: paging-ring depths (hbm_paged buffer_depth); the kernels reserve an
#: mbarrier for each of the deepest ring's slots
RING_DEPTHS = (1, 2, 4)
RING_BAR_BYTES = 8 * max(RING_DEPTHS)
#: the bf16 flash forward's launch (``flash_attention.cu``): q rows a CTA
#: (two consumer warpgroups of 64 rows), keys a kv tile, slots of its k / v
#: ring, threads a CTA (a producer warpgroup and the two consumers) and
#: head_dim as its tiles hold it (two 64-column swizzle atoms)
FLASH_Q_ROWS, FLASH_KV_ROWS, FLASH_STAGES = 128, 128, 2
FLASH_THREADS, FLASH_HEAD_DIM = 384, 128
#: the bf16 flash backward's launches (``flash_attention_bwd.cu``), both
#: passes: a CTA's fixed rows (kv rows for dK / dV, q rows for dQ; two
#: consumer warpgroups of 64), the rows of the tiles its ring streams (q /
#: dO, or k / v) and the ring's slots; threads and head_dim as the forward
FLASH_BWD_CTA_ROWS, FLASH_BWD_TILE_ROWS, FLASH_BWD_STAGES = 128, 64, 3
FLASH_BWD_KINDS = ("dkv", "dq")
#: the V2 steps' launch (``gcrn_step.cu``, ``stacked_step.cu``): a CTA owns
#: TILE_ROWS rows and STEP_UNITS hidden units (all gates) on STEP_THREADS
#: threads, one K split a warp; its weight columns arrive STEP_CHUNK K rows
#: a slot through a ring of STEP_STAGES slots; the CLUSTER unit slices of a
#: row tile share its aggregation
STEP_UNITS, STEP_THREADS, STEP_CHUNK, STEP_STAGES = 8, 256, 64, 3
#: a cluster CTA's slice of a tile product (``slice_tile.cuh``: the stacked
#: step's node transform, the static engine's layers): output columns a
#: pass, and the floats of its 8 K splits' partial sums
PASS_COLS = 16
PASS_PART = STEP_THREADS // 32 * TILE_ROWS * PASS_COLS
#: layers whose true widths a static-engine launch takes (more run at the
#: square width D)
STATIC_MAX_LAYERS = 32
#: the ELL SpMM's launch (``ell_spmm.cu``): threads a CTA; a row takes a
#: warp, or half of one where it is at most 16 vectors wide
SPMM_THREADS = 256
#: the edge-term kernel's launch (``edge_terms.cu``): rows a CTA, and the
#: layers a launch takes (its parameters hold each layer's w_edge pointer
#: and width)
EDGE_ROWS, EDGE_MAX_LAYERS = 32, 32

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


def _digest(source: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (CSRC / f"{source}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(source: str) -> Path:
    return build_dir() / f"lib{source}_{_digest(source)}.so"


def build(names=KERNELS) -> dict:
    """Compile the sources of the named kernels that are not built yet, one
    ``nvcc`` per source, all running at once. Returns {name: library
    path}; raises if any compile fails. The compiler's output (``-Xptxas
    -v``: registers, shared memory, spills) is kept beside each library
    (``lib<source>_<digest>.log``) and lands in ``BUILD_LOG``, by source,
    for a library built earlier too; a library without its log is built
    again."""
    nvcc = _nvcc()
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for source in dict.fromkeys(SOURCE[name] for name in names):
        lib = _lib_path(source)
        if lib.exists() and lib.with_suffix(".log").exists():
            BUILD_LOG[source] = lib.with_suffix(".log").read_text()
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{source}.cu")]
        procs[source] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True),
                         tmp, lib)
    failed = []
    for source, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[source] = log
        if proc.returncode != 0:
            failed.append(f"{source}:\n{log}")
            continue
        # the log first: a library on disk always has its log beside it
        tmp_log = tmp.with_suffix(".log")
        tmp_log.write_text(log)
        os.replace(tmp_log, lib.with_suffix(".log"))
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: _lib_path(SOURCE[name]) for name in names}


#: C signature of each kernel library: (pointer arguments of ``<name>_launch``
#: before its ints, its int arguments, int arguments of ``<name>_smem_bytes``
#: or 0 where the kernel uses no dynamic shared memory); the stream pointer
#: comes last
_SIGNATURES = {
    "gcrn_engine": (16, 8, 4),
    "evolve_engine": (15, 6, 3),
    "stacked_engine": (16, 9, 4),
    "tgn_engine": (15, 7, 3),
    "static_engine": (10, 5, 2),
    "gcrn_step": (12, 4, 3),
    "stacked_step": (12, 5, 4),
    "ell_spmm": (6, 6, 0),
    "gcrn_engine_paged": (16, 10, 6),
    "evolve_engine_paged": (16, 8, 4),
    "stacked_engine_paged": (16, 11, 6),
    "tgn_engine_paged": (15, 9, 6),
    "fused_gru": (6, 3, 2),
    "fused_lstm": (8, 3, 2),
    "flash_attention": (5, 7, 0),
    "flash_fwd": (5, 7, 0),
    "flash_bwd_dkv": (8, 7, 0),
    "flash_bwd_dq": (7, 7, 0),
    "edge_terms": (7, 7, 4),
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
    with _obs.span("check", site=key):
        lo, hi = torch.aminmax(t)
        with _obs.sync(lo.device, key):
            lo, hi = int(lo), int(hi)
    if lo < 0 or hi >= bound:
        raise ValueError(f"{name}: {key} ids span [{lo}, {hi}], "
                         f"outside [0, {bound})")


def _check_smem(name: str, smem: int, dims: str) -> None:
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: {dims} need {smem} bytes of shared "
                         f"memory, over {SMEM_LIMIT}")


# ------------------------------------------------------ shared memory ----

def _ring(depth: int, rows: int, td: int) -> int:
    """Bytes of a paging ring of ``depth`` (rows, td) slots and its
    mbarriers."""
    return 4 * depth * rows * td + RING_BAR_BYTES


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _slice_max(width: int) -> int:
    """The widest of a ``width``-wide state's CLUSTER column slices."""
    return -(-width // CLUSTER)


def slice_bounds(width: int) -> list:
    """The CLUSTER + 1 bounds of the column slices of a ``width``-wide state:
    CTA r of a cluster owns columns [bounds[r], bounds[r + 1])."""
    return [r * width // CLUSTER for r in range(CLUSTER + 1)]


def _gcrn_cta(k, din, H, n, ring=None):
    """Bytes of a GCRN cluster CTA: two k-major [agg_x | agg_h] tiles, its
    units' weights and bias, the ELL lanes, the tile's mask and row ids and
    the step's live-tile bits, and either (resident) the step's gathered
    t-1 h and c rows of its units where they fit (``gcrn_rows_in_smem``) or,
    paged, the tile's own c rows and a ring (``ring`` = (td, depth)) whose
    slot holds a window of up to BOX_ROWS gathered h rows and the tile's 32
    c rows, td wide."""
    K, hm = din + H, _slice_max(H)
    floats = (2 * K * TILE_STRIDE + K * hm * 4 + hm * 4 + 3 * TILE_ROWS * k
              + 3 * TILE_ROWS + LIVE_WORDS)
    if ring is None:
        rows = 4 * 2 * n * _round_up(hm, 4)
        base = ALIGN_SLACK + 4 * floats
        return base + rows if base + rows <= SMEM_LIMIT else base
    td, depth = ring
    wr = min(BOX_ROWS, _round_up(n, 8))
    return (ALIGN_SLACK + 4 * (floats + hm * TILE_STRIDE)
            + _ring(depth, wr + TILE_ROWS, td))


def gcrn_rows_in_smem(k: int, din: int, H: int, n: int) -> bool:
    """Does the resident GCRN CTA keep the step's gathered t-1 h and c rows
    of its units (2 n x its unit slice) in shared memory? Where they do not
    fit beside the rest it keeps them in per-CTA global scratch, as the
    paged variant does (at H 128, din 64, k 27: up to n 911 in shared
    memory); the sums are the same either way."""
    return smem_bytes("gcrn_engine", k=k, din=din, H=H, n=n) > \
        _gcrn_cta(k, din, H, 0)


def _evolve_cta(k, L, D, ring=None):
    """Bytes of an EvolveGCN cluster CTA: the GRU's GW_SLOTS slabs of
    GW_ROWS rows of gwx and gwh (and their mbarriers), two k-major aggregate
    tiles, the ELL lanes, the tile's mask and the step's live-tile bits,
    and either its columns of every W_l in two planes and its GRU threads'
    parked x sums (resident) or, paged, a ring (``ring`` = (td, depth)) of
    (D, td) windows of them."""
    floats = (GW_SLOTS * 2 * GW_ROWS * 3 * D + 2 * D * TILE_STRIDE
              + 2 * TILE_ROWS * k + 3 * TILE_ROWS + LIVE_WORDS)
    base = ALIGN_SLACK + 4 * floats + 8 * GW_SLOTS
    if ring is None:
        return (base + 4 * L * 2 * D * _round_up(_slice_max(D), 4)
                + 4 * GRU_THREADS * 12 * GRU_GROUPS)
    td, depth = ring
    box = min(D, BOX_ROWS)
    return base + _ring(depth, -(-D // box) * box, td)


def _choose(place):
    """(bytes, own weights in shared memory) of a stacked / TGN cluster CTA
    laid out by ``place(nbuf, wsmem)``: two tile buffers where they fit
    (else one), then the own weights where they fit beside them (else they
    are read from global memory)."""
    nbuf = 2 if place(2, False) <= SMEM_LIMIT else 1
    with_w = place(nbuf, True)
    return (with_w, True) if with_w <= SMEM_LIMIT else (place(nbuf, False),
                                                        False)


def _stacked_place(k, din, dmid, H, ring, nbuf, wsmem):
    """Bytes of a stacked cluster CTA: nbuf k-major [agg | nt | h] tiles
    (nt's columns, at least as many as hold the tile's ELL lanes and lane
    counts), with ``wsmem`` its columns of Wg and bg and its units' GRU
    weights and bias, the GRU's exchange of split sums (a CTA of at most
    SPLIT_UNITS units), a tile's mask and row ids for each buffer and the
    live-tile bits;
    paged, a ring (``ring`` = (td, depth)) of the tile's 32 rows x td."""
    hm, mm = _slice_max(H), _slice_max(dmid)
    ntc = max(dmid, -(-(3 * TILE_ROWS * k + TILE_ROWS) // TILE_STRIDE))
    floats = (nbuf * (din + ntc + H) * TILE_STRIDE + 4 * TILE_ROWS
              + LIVE_WORDS + (SPLIT_FLOATS if hm <= SPLIT_UNITS else 0))
    if wsmem:
        floats += din * mm + mm + (dmid + H) * hm * 3 + hm * 3
    if ring:
        td, depth = ring
        floats += depth * TILE_ROWS * td
    floats = _round_up(floats, 2) + (RING_BAR_BYTES // 4 if ring else 0)
    return ALIGN_SLACK + 4 * floats


def _stacked_cta(k, din, dmid, H, ring=None):
    return _choose(lambda nbuf, w: _stacked_place(k, din, dmid, H, ring,
                                                  nbuf, w))[0]


def stacked_weights_in_smem(k: int, din: int, dmid: int, H: int,
                            ring=None) -> bool:
    """Does a stacked cluster CTA hold its columns of Wg and its units' GRU
    weights in shared memory (``ring`` = (td, depth) for the paged one)?
    Past their room it reads them from global memory, the same sums (at k
    27, din 64, dmid 128: up to H 208)."""
    return _choose(lambda nbuf, w: _stacked_place(k, din, dmid, H, ring,
                                                  nbuf, w))[1]


def _tgn_place(k, din, H, n, ring, nbuf, wsmem):
    """Bytes of a TGN cluster CTA: the tile's features, nbuf k-major
    [inp | own] tiles, with ``wsmem`` its columns of W_in and its units' GRU
    weights and bias, the GRU's exchange of split sums (a CTA of at most
    SPLIT_UNITS units), its frequencies, the ELL lanes (local id, coef, time;
    resident also the global row), a tile's mask for each buffer, the lane
    counts and the live-tile bits; paged, the own columns' partner sums and
    a ring (``ring`` = (td, depth)) whose slot holds a window of up to
    BOX_ROWS gathered rows and the tile's 32 rows, td wide."""
    hm = _slice_max(H)
    floats = ((din + nbuf * 2 * H) * TILE_STRIDE + hm
              + (3 if ring else 4) * TILE_ROWS * k + 3 * TILE_ROWS
              + LIVE_WORDS + (SPLIT_FLOATS if hm <= SPLIT_UNITS else 0))
    if wsmem:
        floats += din * hm + 2 * H * hm * 3 + hm * 3
    if ring:
        td, depth = ring
        wr = min(BOX_ROWS, _round_up(n, 8))
        floats += hm * TILE_STRIDE + depth * (wr + TILE_ROWS) * td
    floats = _round_up(floats, 2) + (RING_BAR_BYTES // 4 if ring else 0)
    return ALIGN_SLACK + 4 * floats


def _tgn_cta(k, din, H, n=0, ring=None):
    return _choose(lambda nbuf, w: _tgn_place(k, din, H, n, ring, nbuf,
                                              w))[0]


def tgn_weights_in_smem(k: int, din: int, H: int, n: int = 0,
                        ring=None) -> bool:
    """Does a TGN cluster CTA hold its columns of W_in and its units' GRU
    weights in shared memory (``ring`` = (td, depth) for the paged one, its
    window rows set by n)? Past their room it reads them from global
    memory, the same sums (at k 22, din 64: up to H 180 resident)."""
    return _choose(lambda nbuf, w: _tgn_place(k, din, H, n, ring, nbuf,
                                              w))[1]


def _gcrn_step_smem(din: int, H: int) -> int:
    """Bytes of a gcrn_step CTA: its (TILE_ROWS, din + H rounded up to 8,
    + 4) activation tile and its weight ring, or the partial sums of its
    STEP_THREADS / 32 K splits where more."""
    tile = TILE_ROWS * (_round_up(din + H, 8) + 4)
    ring = STEP_STAGES * STEP_CHUNK * 4 * STEP_UNITS
    red = STEP_THREADS // 32 * 4 * TILE_ROWS * STEP_UNITS
    return 4 * max(tile + ring, red)


def _k_cols(width: int) -> int:
    """Columns of a ``slice_tile.cuh`` tile over a K range of ``width``: a
    multiple of 32 (whole float4s for each of 8 K splits)."""
    return _round_up(width, 32)


def _stacked_step_place(din: int, dmid: int, H: int, wg_smem: bool) -> int:
    """Bytes of a stacked_step CTA: its row-major agg tile (din rounded up
    to 32, + 4 a row), its [nt | h] tile (dmid and H rounded up to 8, + 4),
    its weight ring (3 gates) and, with ``wg_smem``, its Wg column slice
    (din rounded up to 32 rows x the widest nt slice rounded up to
    PASS_COLS); or the GRU's partial sums where more."""
    tiles = TILE_ROWS * (_k_cols(din) + 4 + _round_up(dmid, 8)
                         + _round_up(H, 8) + 4)
    ring = STEP_STAGES * STEP_CHUNK * 3 * STEP_UNITS
    wg = _k_cols(din) * _round_up(_slice_max(dmid), PASS_COLS) if wg_smem \
        else 0
    red = STEP_THREADS // 32 * 4 * TILE_ROWS * STEP_UNITS
    return 4 * max(tiles + ring + wg, red)


def stacked_step_wg_in_smem(din: int, dmid: int, H: int) -> bool:
    """Does a stacked_step CTA hold its Wg column slice in shared memory?
    Past its room it reads it from global memory (L2), the same sums."""
    return _stacked_step_place(din, dmid, H, True) <= SMEM_LIMIT


def _static_place(D: int, w_smem: bool, rows: int) -> int:
    """Bytes of a static-engine cluster CTA: two row-major buffers of a
    pass's ``rows`` (D rounded up to 32, + 4 a row), the partial sums of a
    product pass for each of its tiles, the live-tile bits, its bias slice
    and, with ``w_smem``, its W_l column slice (D rounded up to 32 rows x
    the widest slice rounded up to PASS_COLS)."""
    ldw = _round_up(_slice_max(D), PASS_COLS)
    floats = (2 * rows * (_k_cols(D) + 4) + rows // TILE_ROWS * PASS_PART
              + LIVE_WORDS + ldw)
    if w_smem:
        floats += _k_cols(D) * ldw
    return 4 * floats


def _static_variant(D: int) -> tuple:
    """(W slice in shared memory, rows a pass) of a static-engine launch at
    D: two tiles a pass with the W slice where both fit, else without it,
    else one tile a pass without it."""
    for w_smem, rows in ((True, 2 * TILE_ROWS), (False, 2 * TILE_ROWS)):
        if _static_place(D, w_smem, rows) <= SMEM_LIMIT:
            return w_smem, rows
    return False, TILE_ROWS


def static_weights_in_smem(D: int) -> bool:
    """Does a static-engine CTA hold its W_l column slice in shared memory?
    Past its room it reads it from global memory (L2), the same sums (up to
    D 256)."""
    return _static_variant(D)[0]


def static_pass_rows(D: int) -> int:
    """Node rows a static-engine pass aggregates and all-gathers at once:
    two 32-row live tiles (a warp's rows on 4 threads each) up to D 384,
    one past it."""
    return _static_variant(D)[1]


#: each kernel's dynamic shared memory: (argument names of the library's
#: ``<name>_smem_bytes``, in its order; the same function of them)
_SMEM = {
    # a cluster CTA (its units' weights and gathered rows)
    "gcrn_engine": (("k", "din", "H", "n"), _gcrn_cta),
    # a cluster CTA (its columns of every W_l, two planes)
    "evolve_engine": (("k", "L", "D"), _evolve_cta),
    # a cluster CTA (its units' weights where they fit)
    "stacked_engine": (("k", "din", "dmid", "H"), _stacked_cta),
    "tgn_engine": (("k", "din", "H"), _tgn_cta),
    # a cluster CTA (its W_l column slice where it fits); k does not
    # change it
    "static_engine": (("k", "D"),
                      lambda k, D: _static_place(D, *_static_variant(D))),
    # the row-major [agg_x | agg_h] tile and the weight ring, or the K
    # splits' partial sums where more; k does not change it
    "gcrn_step": (("k", "din", "H"), lambda k, din, H: _gcrn_step_smem(din, H)),
    # the agg and [nt | h] tiles, the weight ring and the Wg slice where it
    # fits; k does not change it
    "stacked_step": (("k", "din", "dmid", "H"),
                     lambda k, din, dmid, H: _stacked_step_place(
                         din, dmid, H, stacked_step_wg_in_smem(din, dmid, H))),
    # a cluster CTA; a slot: up to BOX_ROWS gathered h rows and the tile's
    # c rows, td of its own columns
    "gcrn_engine_paged": (("k", "din", "H", "n", "td", "depth"),
                          lambda k, din, H, n, td, depth:
                          _gcrn_cta(k, din, H, n, (td, depth))),
    # a cluster CTA; a slot: a (D, td) window of its columns of W_l, no W
    # buffer
    "evolve_engine_paged": (("k", "D", "td", "depth"),
                            lambda k, D, td, depth:
                            _evolve_cta(k, 1, D, (td, depth))),
    # a cluster CTA; a slot: the tile's 32 rows, td of its own columns
    "stacked_engine_paged": (("k", "din", "dmid", "H", "td", "depth"),
                             lambda k, din, dmid, H, td, depth:
                             _stacked_cta(k, din, dmid, H, (td, depth))),
    # a cluster CTA; a slot: up to BOX_ROWS gathered rows and the tile's 32
    # rows, td of its own columns (no buffer grows with n)
    "tgn_engine_paged": (("k", "din", "H", "n", "td", "depth"),
                         lambda k, din, H, n, td, depth:
                         _tgn_cta(k, din, H, n, (td, depth))),
    # a fixed ring of staged chunks, whatever din and H
    "fused_gru": (("din", "H"), lambda din, H: 29696),
    "fused_lstm": (("din", "H"), lambda din, H: 33792),
    # every layer's w_edge padded to D, a block's rows' lanes (eidx and
    # coef, k rounded up to odd a row) and their aggregates
    "edge_terms": (("k", "De", "L", "D"),
                   lambda k, De, L, D: 4 * (L * De * D + 2 * EDGE_ROWS
                                            * (k | 1) + EDGE_ROWS * De)),
}


def smem_bytes(name: str, **dims) -> int:
    """Dynamic shared memory of one launch of kernel ``name`` at ``dims``
    (the arguments of its ``<name>_smem_bytes``: some of k, din, dmid, H, D,
    L, n, td, depth), a CTA's for the cluster engines. It equals the
    library's own figure (``library_smem_bytes``, on the card). No estimate
    grows with the store height G: the stores stay in global memory."""
    args, fn = _SMEM[name]
    return fn(*(dims[a] for a in args))


def library_smem_bytes(name: str, **dims) -> int:
    """The kernel library's own ``<name>_smem_bytes`` at ``dims`` (needs the
    card: the library is built and loaded)."""
    args, _ = _SMEM[name]
    return int(getattr(_library(name), f"{name}_smem_bytes")(
        *(dims[a] for a in args)))


def _weights_in_smem(name: str, dims: dict) -> bool:
    """The stacked / TGN cluster CTA's weights flag at ``dims``."""
    ring = (dims["td"], dims["depth"]) if name.endswith("paged") else None
    if name.startswith("stacked"):
        return stacked_weights_in_smem(dims["k"], dims["din"], dims["dmid"],
                                       dims["H"], ring)
    return tgn_weights_in_smem(dims["k"], dims["din"], dims["H"],
                               dims.get("n", 0), ring)


def engine_cluster_config(name: str, B: int, **dims) -> dict:
    """The launch of cluster engine ``name`` (one of ``CLUSTER_ENGINES``)
    over B streams at ``dims`` (those of ``smem_bytes``): CTAs a cluster,
    CTAs, threads a CTA (the resident EvolveGCN's GRU threads included), a
    CTA's dynamic shared memory, and the column slice
    [lo, hi) of each CTA (``slices``: hidden units for GCRN, stacked and
    TGN, columns of W for EvolveGCN; ``x_slices``: GCRN's and the stacked
    engine's input columns); for stacked and TGN ``weights_smem``, whether
    a CTA holds its weights in shared memory. It equals the launcher's own
    (``library_engine_cluster_config``, on the card)."""
    if name not in CLUSTER_ENGINES:
        raise ValueError(f"{name!r} is not a cluster engine "
                         f"({', '.join(CLUSTER_ENGINES)})")
    width = dims["D"] if name.startswith("evolve") else dims["H"]
    bounds = slice_bounds(width)
    threads = CLUSTER_THREADS + (GRU_THREADS if name == "evolve_engine"
                                 else 0)
    cfg = {"cluster": CLUSTER, "ctas": B * CLUSTER,
           "threads": threads, "smem": smem_bytes(name, **dims),
           "slices": list(zip(bounds[:-1], bounds[1:]))}
    if name.startswith(("gcrn", "stacked")):
        xb = slice_bounds(dims["din"])
        cfg["x_slices"] = list(zip(xb[:-1], xb[1:]))
    if name.startswith(("stacked", "tgn")):
        cfg["weights_smem"] = _weights_in_smem(name, dims)
    return cfg


def library_engine_cluster_config(name: str, B: int, **dims) -> dict:
    """``engine_cluster_config`` as the library's launcher builds it (its
    ``<name>_cluster_config``; needs the card), with ``max_active_clusters``:
    the clusters of this launch the card holds at once
    (cudaOccupancyMaxActiveClusters; -1 where the query failed)."""
    args, _ = _SMEM[name]
    fn = getattr(_library(name), f"{name}_cluster_config")
    fn.argtypes = [ctypes.c_int] * (1 + len(args)) + [
        ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * (8 + 2 * CLUSTER))()
    code = fn(B, *(dims[a] for a in args), out)
    if code:
        raise ValueError(f"{name}_cluster_config refused {dims} (cudaError "
                         f"{code})")
    C = out[0]
    b = list(out[5:6 + C])
    cfg = {"cluster": C, "ctas": out[1], "threads": out[2], "smem": out[3],
           "slices": list(zip(b[:-1], b[1:])),
           "max_active_clusters": out[4]}
    if name.startswith(("gcrn", "stacked")):
        xb = list(out[6 + C:7 + 2 * C])
        cfg["x_slices"] = list(zip(xb[:-1], xb[1:]))
    if name.startswith(("stacked", "tgn")):
        cfg["weights_smem"] = bool(out[7 + 2 * C])
    return cfg


def library_ctas(name: str, Bs: int, H: int) -> int:
    """CTAs of one GRU / LSTM cell launch over ``Bs`` rows and ``H``
    hidden units, from the grid its launcher builds (the library's
    ``<name>_ctas``; needs the card)."""
    fn = getattr(_library(name), f"{name}_ctas")
    fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_int
    return int(fn(Bs, H))


#: the arguments of each per-step kernel's ``<name>_plan``, in its order
_PLAN_ARGS = {"gcrn_step": ("n", "k", "din", "H"),
              "stacked_step": ("n", "k", "din", "dmid", "H"),
              "ell_spmm": ("L", "n", "d", "aligned")}


def step_plan(name: str, **dims) -> dict:
    """The launch of per-step kernel ``name`` at ``dims``: "gcrn_step" over
    n rows (k, din, H), "stacked_step" over n rows (k, din, dmid, H),
    "ell_spmm" over L graphs of n rows d wide (``aligned``: x, emsg and the
    output start on 16 bytes). Its CTAs, threads a CTA and dynamic shared
    memory; for the V2 steps their row tiles, unit slices (padded to whole
    clusters: a 1-D grid of both, the slices of a tile neighbours) and CTAs
    a cluster, for stacked_step also whether its Wg slice sits in shared
    memory (``wg_smem``); for the ELL SpMM its grid (row blocks, graphs),
    the rows a CTA, the threads a row and the floats a vector. It equals the
    launcher's own (``library_step_plan``, on the card)."""
    if name in ("gcrn_step", "stacked_step"):
        n, H = dims["n"], dims["H"]
        tiles = -(-n // TILE_ROWS)
        slices = _round_up(-(-H // STEP_UNITS), CLUSTER)
        args = {a: dims[a] for a in _SMEM[name][0]}
        plan = {"tiles": tiles, "slices": slices, "ctas": tiles * slices,
                "cluster": CLUSTER, "threads": STEP_THREADS,
                "smem": smem_bytes(name, **args)}
        if name == "stacked_step":
            plan["wg_smem"] = stacked_step_wg_in_smem(dims["din"],
                                                      dims["dmid"], H)
        return plan
    if name == "ell_spmm":
        d = dims["d"]
        vec = 4 if d % 4 == 0 and dims["aligned"] else 1
        row_threads = 16 if d // vec <= 16 else 32
        rows = SPMM_THREADS // row_threads
        grid = (-(-dims["n"] // rows), dims["L"])
        return {"grid": grid, "ctas": grid[0] * grid[1],
                "threads": SPMM_THREADS, "smem": 0, "rows": rows,
                "row_threads": row_threads, "vec": vec}
    raise ValueError(f"{name!r} has no step plan ({', '.join(_PLAN_ARGS)})")


def library_step_plan(name: str, **dims) -> dict:
    """``step_plan`` as the library's launcher builds it (its
    ``<name>_plan``; needs the card)."""
    args = _PLAN_ARGS[name]
    fn = getattr(_library(name), f"{name}_plan")
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 7)()
    fn(*(int(dims[a]) for a in args), out)
    if name in ("gcrn_step", "stacked_step"):
        plan = {"tiles": out[0], "slices": out[1], "ctas": out[2],
                "cluster": out[5], "threads": out[3], "smem": out[4]}
        if name == "stacked_step":
            plan["wg_smem"] = bool(out[6])
        return plan
    return {"grid": (out[0], out[1]), "ctas": out[2], "threads": out[3],
            "smem": 0, "rows": out[4], "row_threads": out[5], "vec": out[6]}


def static_plan(B: int, k: int, D: int, widths) -> dict:
    """The static engine's launch over B slots of square width D with the
    layers' true widths ``widths`` (L + 1: din_0, dout_0 = din_1, ...,
    dout_{L-1}; past STATIC_MAX_LAYERS layers every width is D): a cluster
    of CLUSTER CTAs a slot, its CTAs, threads a CTA, dynamic shared memory,
    whether a CTA holds its W_l slice in shared memory (``weights_smem``),
    the layers whose true widths a launch takes (``max_layers``), the node
    rows a pass aggregates at once (``pass_rows``), the widths the kernel
    runs (``widths``) and the output columns [lo, hi) each CTA owns at each
    layer (``slices``). The first seven equal the launcher's own
    (``library_static_plan``, on the card)."""
    widths = list(widths)
    if len(widths) > STATIC_MAX_LAYERS + 1:
        widths = [D] * len(widths)
    return {"cluster": CLUSTER, "ctas": B * CLUSTER,
            "threads": CLUSTER_THREADS,
            "smem": smem_bytes("static_engine", k=k, D=D),
            "weights_smem": static_weights_in_smem(D),
            "max_layers": STATIC_MAX_LAYERS,
            "pass_rows": static_pass_rows(D), "widths": widths,
            "slices": [list(zip(bounds[:-1], bounds[1:]))
                       for bounds in map(slice_bounds, widths[1:])]}


def library_static_plan(B: int, k: int, D: int) -> dict:
    """The launcher's own (its ``static_engine_plan``; needs the card):
    ``static_plan``'s cluster, CTAs, threads, shared memory, weights flag,
    layers taken and rows a pass."""
    fn = _library("static_engine").static_engine_plan
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 7)()
    fn(B, k, D, out)
    return {"cluster": out[0], "ctas": out[1], "threads": out[2],
            "smem": out[3], "weights_smem": bool(out[4]),
            "max_layers": out[5], "pass_rows": out[6]}


def flash_config(bh: int, s: int, d: int) -> dict:
    """The bf16 flash forward's launch for q (bh, s, d): its tiles, ring,
    threads, dynamic shared memory (1024 bytes of alignment slack, the q
    tile, the ring's k and v tiles, an mbarrier for q and four a slot) and
    grid (q heads, q tiles). It equals the launcher's own
    (``library_flash_config``, on the card)."""
    if d % 8 or not 0 < d <= FLASH_HEAD_DIM:
        raise ValueError(f"flash: head_dim {d} must be a multiple of 8 up to "
                         f"{FLASH_HEAD_DIM}")
    tiles = 2 * FLASH_HEAD_DIM * (FLASH_Q_ROWS
                                  + 2 * FLASH_STAGES * FLASH_KV_ROWS)
    return {"q_rows": FLASH_Q_ROWS, "kv_rows": FLASH_KV_ROWS,
            "stages": FLASH_STAGES, "threads": FLASH_THREADS,
            "smem": 1024 + tiles + 8 * (1 + 4 * FLASH_STAGES),
            "grid": (bh, -(-s // FLASH_Q_ROWS))}


def library_flash_config(bh: int, s: int) -> dict:
    """``flash_config`` as the library's launcher builds it for both entry
    points (its ``flash_fwd_config``; needs the card)."""
    fn = _library("flash_fwd").flash_fwd_config
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 7)()
    fn(bh, s, out)
    return {"q_rows": out[0], "kv_rows": out[1], "stages": out[2],
            "threads": out[3], "smem": out[4], "grid": (out[5], out[6])}


def flash_bwd_config(bh: int, s: int, d: int, group: int, kind: str,
                     skv: int | None = None) -> dict:
    """The bf16 flash backward's launch of pass ``kind`` ("dkv" or "dq")
    for q (bh, s, d) and k / v (bh / group, skv, d), skv = s unless given:
    its tiles (q_rows, kv_rows: the CTA's fixed tile and the streamed one),
    ring, threads, dynamic shared memory (1024 bytes of alignment slack,
    the two fixed tiles, each slot's two streamed tiles, dK / dV's slots
    also their q rows' lse and delta, an mbarrier for the fixed tiles and
    two a slot) and grid: (kv heads, kv tiles) for dkv, (q heads, q tiles)
    for dq. It equals the launcher's own (``library_flash_bwd_config``, on
    the card)."""
    if kind not in FLASH_BWD_KINDS:
        raise ValueError(f"flash bwd: kind {kind!r} is not one of "
                         f"{FLASH_BWD_KINDS}")
    if d % 8 or not 0 < d <= FLASH_HEAD_DIM:
        raise ValueError(f"flash bwd: head_dim {d} must be a multiple of 8 "
                         f"up to {FLASH_HEAD_DIM}")
    if not (group > 0 and bh % group == 0):
        raise ValueError(f"flash bwd: {bh} q heads do not split into "
                         f"groups of {group}")
    skv = s if skv is None else skv
    cta, tile, stages = (FLASH_BWD_CTA_ROWS, FLASH_BWD_TILE_ROWS,
                         FLASH_BWD_STAGES)
    tiles = 2 * FLASH_HEAD_DIM * (2 * cta + 2 * stages * tile)
    stats = 2 * 4 * tile * stages if kind == "dkv" else 0
    smem = 1024 + tiles + stats + 8 * (1 + 2 * stages)
    if kind == "dkv":
        rows, grid = (tile, cta), (bh // group, -(-skv // cta))
    else:
        rows, grid = (cta, tile), (bh, -(-s // cta))
    return {"q_rows": rows[0], "kv_rows": rows[1], "stages": stages,
            "threads": FLASH_THREADS, "smem": smem, "grid": grid}


def library_flash_bwd_config(bh: int, s: int, group: int, kind: str,
                             skv: int | None = None) -> dict:
    """``flash_bwd_config`` as the library's launcher builds it (its
    ``flash_bwd_config``; needs the card)."""
    fn = _library("flash_bwd_dkv").flash_bwd_config
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 7)()
    code = fn(FLASH_BWD_KINDS.index(kind), bh, s, s if skv is None else skv,
              group, out)
    if code:
        raise ValueError(f"flash_bwd_config refused kind {kind!r}, bh {bh}, "
                         f"group {group} (cudaError {code})")
    return {"q_rows": out[0], "kv_rows": out[1], "stages": out[2],
            "threads": out[3], "smem": out[4], "grid": (out[5], out[6])}


def _check_budget(family: str, residency: str, td, smem: int,
                  limit=None) -> None:
    """Refuse a stream-engine launch whose shared memory is over the card's
    227 KB, with the JAX package's hint (its budget is the TPU's 16 MiB of
    VMEM, so the two packages refuse at different sizes) and, where given,
    a callable that names the limit at these dims."""
    if smem > SMEM_LIMIT:
        hint = ("shrink td" if residency == "hbm_paged" else
                "page the state store with plan(state_residency="
                "'hbm_paged', td=...)")
        raise ValueError(
            f"family {family!r} ({residency}, td={td}) needs {smem} bytes of "
            f"shared memory, over the {SMEM_LIMIT}-byte budget — {hint}"
            + (f" ({limit()})" if limit else ""))


def evolve_resident_max_d(k: int, L: int) -> int:
    """The widest D (a multiple of ROW_ALIGN) whose resident EvolveGCN CTA
    fits the card at k lanes and L layers: it holds two planes of its
    columns of every W_l (at k 27: D 216 at L 1, D 184 at L 2)."""
    d = 0
    while smem_bytes("evolve_engine", k=k, L=L, D=d + ROW_ALIGN) <= \
            SMEM_LIMIT:
        d += ROW_ALIGN
    return d


def _check_ring(name: str, td, depth) -> None:
    """A paged engine's window width and ring depth: td a positive multiple
    of ``ROW_ALIGN`` (a window's rows move as 16-byte copies: bulk copies
    of rows, or TMA boxes in the cluster engines), depth one of
    ``RING_DEPTHS``."""
    if not (isinstance(td, int) and td > 0 and td % ROW_ALIGN == 0):
        raise ValueError(f"{name}: td={td!r} must be a positive multiple of "
                         f"{ROW_ALIGN}")
    if depth not in RING_DEPTHS:
        raise ValueError(f"{name}: depth={depth!r} must be one of "
                         f"{RING_DEPTHS}")


def _windows(cols: int, td: int) -> list:
    """The td-wide column windows of ``cols`` columns, in the ring's order
    (the last one narrower where td does not divide cols)."""
    return [slice(c, min(c + td, cols)) for c in range(0, cols, td)]


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


def refuse_grad(name: str, *inputs) -> None:
    """Raise where autograd would record a call of kernel ``name``: the
    kernel writes its outputs through a raw pointer, so they would carry no
    gradient (a silent zero). Inputs that are not tensors are skipped."""
    if torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.is_floating_point() and t.requires_grad
            for t in inputs):
        raise NotImplementedError(
            f"{name}: the kernel has no gradient (an input requires grad); "
            "run it under torch.no_grad(), or take the plain path "
            "(force_ref=True, impl='xla')")


def _device_kind(name: str, t: torch.Tensor) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"{name}: tensors on {t.device} are not supported "
                     "(cuda runs the kernel, cpu the plain version)")


# ------------------------------------------- recording and the log ----
# The static checker's two views of a stream-engine launch: the launch as
# its wrapper assembles it (``recording_launches``), and the protocol log
# a launch writes on the card where it is given one (``proto=True``), or
# its plain version (``protocol_plain``).

#: each thread's list that ``recording_launches`` appends to (None: its
#: launches run); per thread, so a recording never takes another thread's
#: launches (the serve layer's device loop)
_RECORDING = threading.local()


def _recorder():
    return getattr(_RECORDING, "launches", None)

#: the state stores among a stream engine's C arguments (keyed by family),
#: each with its place in the wrapper's result: the kernel evolves the
#: store in place, and the wrapper returns that very tensor
STORE_ARGS = {"gcrn": {"h_store": 1, "c_store": 2}, "evolve": {"w": 1},
              "stacked": {"h_store": 1}, "tgn": {"store": 1}, "static": {}}


@dataclass(frozen=True)
class RecordedLaunch:
    """One stream-engine launch as its wrapper assembled it: the kernel
    ``name``, the ``dims`` (those of ``smem_bytes``) and the shared memory
    ``smem`` it budget-checked, its cluster launch (``engine_cluster_config``;
    None for the static engine), the C launch's pointer arguments by name in
    their order (``args``: tensors, None for a null pointer; the static
    engine's host widths a list) and its int arguments (``ints``), what the
    wrapper returns (``result``, a tuple) and the wrapper's own arguments
    (``call``: positional, keyword), with which the launch runs again."""

    name: str
    dims: dict
    smem: int
    cluster: object
    args: dict
    ints: dict
    result: tuple
    call: tuple


@contextlib.contextmanager
def recording_launches():
    """Record the stream-engine launches made inside the block instead of
    running them. Each launcher checks and assembles its launch on CPU and
    CUDA tensors alike (shapes, index ranges, the shared-memory budget,
    outputs and scratch, the C arguments), appends a ``RecordedLaunch`` to
    the list this yields and returns its unwritten outputs; nothing is
    built, launched or counted in ``LAUNCHES``. It holds for the calling
    thread only. Only the static checker installs it (repro_torch.analysis's
    contract pass)."""
    prev, _RECORDING.launches = _recorder(), []
    try:
        yield _RECORDING.launches
    finally:
        _RECORDING.launches = prev


def _plain_path(name: str, t: torch.Tensor) -> bool:
    """Does the wrapper run its plain version? For CPU tensors, unless a
    recording is on."""
    return _device_kind(name, t) == "cpu" and _recorder() is None


#: the protocol log (``csrc/cluster_common.cuh``, namespace proto): int32, a
#: header (rows appended, an overflow flag, the capacity in rows, padding),
#: then rows of PROTO_ROW ints (cta, ring, seq, slot, parity, window, event,
#: padding)
PROTO_HEADER, PROTO_ROW = 8, 8
#: its rings: the paged state ring, EvolveGCN's GRU slab ring, the W planes
#: read (and the final copy) and written
RING_STATE, RING_GRU, RING_PLANE_READ, RING_PLANE_WRITE = 0, 1, 2, 3
#: its events
EV_ISSUE, EV_WAIT, EV_READ, EV_WRITE, EV_FINAL = 0, 1, 2, 3, 4


@dataclass(frozen=True)
class ProtoLog:
    """The protocol log of one stream-engine launch. ``rows`` (R, 7) int64:
    (cta, ring, seq, slot, parity, window, event), grouped by (cta, ring),
    each group in its logging thread's order; ``count`` the rows appended
    (past ``capacity`` they were dropped, and ``overflow`` is set). What
    the launch's data needs, from ``protocol_plain``: the depth of each
    ring it has (``depth``), the lengths of each (cta, ring)'s sweeps in
    order (``sweeps``), EvolveGCN's planes a layer (``planes``: 2 resident,
    1 paged, in place; None for the families that hold none) and its live
    steps (``live``, (B, T) bool), and the launch's B, T and L."""

    name: str
    rows: np.ndarray
    count: int
    capacity: int
    overflow: bool
    depth: dict
    sweeps: dict
    planes: object
    live: object
    B: int
    T: int
    L: int


def _sweep_rows(cta: int, ring: int, depth: int, lengths) -> list:
    """A ring's rows over its sweeps, as its issuing thread logs them: a
    sweep of m entries issues its first depth, then after waiting each
    entry issues the one depth further on; entry s of the ring (over all
    sweeps) sits in slot s % depth with parity (s / depth) & 1."""
    rows, s0 = [], 0

    def row(seq, w, ev):
        rows.append((cta, ring, seq, seq % depth, (seq // depth) & 1, w, ev))

    for m in lengths:
        for i in range(min(depth, m)):
            row(s0 + i, i, EV_ISSUE)
        for i in range(m):
            row(s0 + i, i, EV_WAIT)
            if i + depth < m:
                row(s0 + i + depth, i + depth, EV_ISSUE)
        s0 += m
    return rows


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _plane_rows(cta: int, paged: bool, L: int, live_b) -> list:
    """EvolveGCN's W-plane rows of one CTA over steps whose live flags are
    ``live_b``: each step reads each layer's plane, a live step writes the
    other one (paged: the one plane, its pages, in place), and the launch
    returns the plane written last. Reads and the final rows are the GCN's
    thread 0's, writes the GRU's first thread's."""
    reads, writes, cur = [], [], 0
    for t, on in enumerate(live_b):
        for l in range(L):
            plane = 0 if paged else (cur >> l) & 1
            reads.append((cta, RING_PLANE_READ, t, plane, 0, l, EV_READ))
            if on:
                writes.append((cta, RING_PLANE_WRITE, t,
                               plane if paged else plane ^ 1, 0, l, EV_WRITE))
        if on and not paged:
            cur ^= (1 << L) - 1
    reads += [(cta, RING_PLANE_READ, len(live_b), 0 if paged else
               (cur >> l) & 1, 0, l, EV_FINAL) for l in range(L)]
    return reads + writes


def protocol_plain(name: str, mask, *, width: int, td=None, depth=None,
                   L: int = 1, live=None) -> ProtoLog:
    """The protocol log that cluster engine ``name`` writes for a launch
    over ``mask`` (B, T, n): ``width`` the state's (H; EvolveGCN's D), the
    paged ring's window width ``td`` and ``depth``, EvolveGCN's layers ``L``
    and live steps ``live`` (B, T). Each CTA's sweeps follow from its column
    slice and each step's live tiles (a chunk of ``CHUNK_ROWS`` rows at a
    time): GCRN and TGN issue (own column windows) x (BOX_ROWS-row windows
    of the gathered rows) a live tile, stacked its own column windows;
    EvolveGCN its column windows of each W_l a live tile and, on a live
    step, once more for the matrix-GRU, whose gwx / gwh slabs stream
    through a GW_SLOTS-deep ring of their own (resident too), and it logs
    each step's read and write of each layer's W plane and the plane it
    returns. A resident GCRN, stacked or TGN launch logs nothing."""
    if name not in CLUSTER_ENGINES:
        raise ValueError(f"{name!r} writes no protocol log "
                         f"({', '.join(CLUSTER_ENGINES)})")
    family, paged = name.split("_")[0], name.endswith("_paged")
    m = (torch.as_tensor(mask).detach().cpu() != 0).numpy()
    B, T, n = m.shape
    tiles = _ceil(n, TILE_ROWS)
    per_tile = np.pad(m, ((0, 0), (0, 0), (0, tiles * TILE_ROWS - n)))
    per_tile = per_tile.reshape(B, T, tiles, TILE_ROWS).any(-1)
    chunk = CHUNK_ROWS // TILE_ROWS
    # live tiles of each (b, t) in each chunk of tiles
    counts = [[[int(per_tile[b, t, q:q + chunk].sum())
                for q in range(0, tiles, chunk)] for t in range(T)]
              for b in range(B)]
    bounds = slice_bounds(width)
    live_np = None if live is None else (
        torch.as_tensor(live).detach().cpu() > 0).numpy()
    rows, sweeps, depths = [], {}, {}
    if paged:
        depths[RING_STATE] = depth
    if family == "evolve":
        depths[RING_GRU] = GW_SLOTS
    wr = min(BOX_ROWS, _round_up(n, 8))
    for b in range(B):
        for r in range(CLUSTER):
            cta, ws = b * CLUSTER + r, bounds[r + 1] - bounds[r]
            state, gru = [], []
            ncw = _ceil(ws, td) if paged else 0
            nw = ncw * (_ceil(n, wr) if family in ("gcrn", "tgn") else 1)
            for t in range(T):
                if family != "evolve":
                    state += [c * nw for c in counts[b][t]]
                    continue
                for l in range(L):
                    if paged:
                        state += [c * ncw for c in counts[b][t]]
                    if not live_np[b, t]:
                        continue
                    if paged:  # the GRU's sweep of the column windows
                        state.append(ncw)
                        for cw in range(ncw):
                            ncg = _ceil(min(td, ws - cw * td), 4)
                            gru.append(_ceil(_ceil(ncg, 2) * width,
                                             CLUSTER_THREADS)
                                       * (width // GW_ROWS))
                    else:
                        items = _ceil(_ceil(ws, 4), GRU_GROUPS) * width
                        gru.append(_ceil(items, GRU_THREADS) * 2
                                   * _ceil(width, 2 * GW_ROWS))
            for ring, lengths in ((RING_STATE, state), (RING_GRU, gru)):
                lengths = [x for x in lengths if x > 0]
                if lengths:
                    sweeps[(cta, ring)] = tuple(lengths)
                    rows += _sweep_rows(cta, ring, depths[ring], lengths)
            if family == "evolve":
                rows += _plane_rows(cta, paged, L, live_np[b])
    arr = np.asarray(rows, dtype=np.int64).reshape(-1, 7)
    order = np.lexsort((np.arange(len(arr)), arr[:, 1], arr[:, 0]))
    return ProtoLog(name, arr[order], len(arr), len(arr), False, depths,
                    sweeps, (1 if paged else 2) if family == "evolve" else
                    None, live_np if family == "evolve" else None, B, T, L)


def _protocol_of(name: str, args: dict, ints: dict) -> ProtoLog:
    """``protocol_plain`` of a launch of engine ``name`` from its C
    arguments."""
    family = name.split("_")[0]
    if family == "evolve":
        width, L = args["w"].shape[2], args["w"].shape[1]
    else:
        width, L = args[next(iter(STORE_ARGS[family]))].shape[-1], 1
    return protocol_plain(name, args["mask"], width=width, td=ints.get("td"),
                          depth=ints.get("depth"), L=L,
                          live=args.get("live"))


def protocol_of(rec: RecordedLaunch) -> ProtoLog:
    """``protocol_plain`` of a recorded launch: the log its kernel writes
    for its data."""
    return _protocol_of(rec.name, rec.args, rec.ints)


def _read_log(plain: ProtoLog, log: torch.Tensor) -> ProtoLog:
    """The log a launch wrote into ``log`` (one device sync), its rows
    grouped by (cta, ring) in the order each group was appended, beside
    what ``plain`` says the launch's data needs."""
    host = log.cpu().numpy().astype(np.int64)
    count, flag, cap = (int(v) for v in host[:3])
    kept = min(count, cap)
    rows = host[PROTO_HEADER:PROTO_HEADER + kept * PROTO_ROW].reshape(
        kept, PROTO_ROW)[:, :7]
    order = np.lexsort((np.arange(kept), rows[:, 1], rows[:, 0]))
    return dataclasses.replace(plain, rows=rows[order], count=count,
                               capacity=cap,
                               overflow=bool(flag) or count > cap)


def _dispatch(name: str, dims: dict, smem: int, args: dict, ints: dict,
              result: tuple, call: tuple, proto: bool = False):
    """The end of a stream-engine launcher: inside ``recording_launches``
    record the assembled launch and return its (unwritten) ``result``;
    otherwise launch it on the current stream of its tensors' card. With
    ``proto`` the launch writes a protocol log (``args["proto"]``, which
    the launcher leaves None), sized from its plain version (twice its rows
    and 256 more), returned after the results."""
    recorded = _recorder()
    with _obs.span("launch", kernel=name):
        if recorded is not None:
            recorded.append(RecordedLaunch(
                name, dict(dims), smem,
                engine_cluster_config(name, ints["B"], **dims), dict(args),
                dict(ints), result, call))
            return result
        lib = _library(name)
        device = args["mask"].device
        if proto:
            plain = _protocol_of(name, args, ints)
            cap = 2 * len(plain.rows) + 256
            args["proto"] = torch.zeros(PROTO_HEADER + cap * PROTO_ROW,
                                        dtype=torch.int32, device=device)
            args["proto"][2] = cap
        with torch.cuda.device(device):
            _launch(name, lib, *map(_ptr, args.values()), *ints.values(),
                    _stream_ptr())
    return (*result, _read_log(plain, args["proto"])) if proto else result


def _with_log(name: str, result: tuple, packed: dict, ints: dict,
              proto: bool):
    """A plain version's result, and with ``proto`` the launch's plain
    protocol log (from the packed inputs ``packed``: mask, the state, and
    EvolveGCN's live flags)."""
    return (*result, _protocol_of(name, packed, ints)) if proto else result


# ------------------------------------------------------------- gcrn ----

def gcrn_plain(idx, coef, eidx, x, rowg, mask, h0, c0, wx, wh, b, emsg=None):
    """The GCRN kernel's function in plain PyTorch, on the same packed
    inputs: ``rowg`` is the global row per node, ``G`` (the store height)
    on padding rows."""
    ren = torch.where(rowg < h0.shape[1], rowg, -1)
    return _ref.gcrn_stream_batched_ref(idx, coef, eidx, x, ren, mask, h0,
                                        c0, wx, wh, b, emsg)


def gcrn_paged_plain(idx, coef, eidx, x, rowg, mask, h0, c0, wx, wh, b,
                     emsg=None, *, td, depth):
    """The paged GCRN kernel's function in plain PyTorch, on the packed
    inputs of ``gcrn_plain``: each step gathers its rows, then aggregates
    their t-1 h (agg_h) window by window, td columns at a time, in the
    ring's order; the own c rows are read as they are (staging rows by
    windows moves no value). The ring's ``depth`` does not change the
    function."""
    _check_ring("gcrn_engine_paged", td, depth)
    G, H = h0.shape[1:]
    ren = torch.where(rowg < G, rowg, -1)
    h_store, c_store = h0.clone(), c0.clone()
    wins = _windows(H, td)
    outs = []
    for t in range(idx.shape[1]):
        r, m = ren[:, t], mask[:, t]
        h_rows = _ref._gather_rows(h_store, r, m)
        c_rows = _ref._gather_rows(c_store, r, m)
        lanes = (idx[:, t], coef[:, t], eidx[:, t])
        em = None if emsg is None else emsg[:, t]
        agg_x = _ref.ell_spmm(*lanes, x[:, t], em)
        agg_h = torch.cat([_ref.ell_spmm(*lanes, h_rows[..., w])
                           for w in wins], dim=-1)
        h_new, c_new = _ref.fused_lstm(agg_x, agg_h, c_rows, wx, wh, b)
        h_new, c_new = h_new * m[..., None], c_new * m[..., None]
        _ref._scatter_rows_(h_store, r, h_new)
        _ref._scatter_rows_(c_store, r, c_new)
        outs.append(h_new)
    return torch.stack(outs, dim=1), h_store, c_store


def _gcrn_cuda(name, ring, dims, smem, call, proto, idx, coef, eidx, x,
               rowg, mask, h0, c0, wx, wh, b, emsg):
    """Check the tensors and assemble the GCRN kernel ``name``'s launch
    (``ring``: () resident, (td, depth) paged; ``dims`` / ``smem`` as
    budget-checked), then record or launch it (``_dispatch``)."""
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
    e = 0 if emsg is None else emsg.shape[2]
    outs = torch.empty((B, T, n, H), dtype=f32, device=x.device)
    hT, cT = h0.clone(), c0.clone()
    h_rows = c_rows = None
    if ring or not gcrn_rows_in_smem(k, din, H, n):
        # each CTA's gathered t-1 rows in global memory, its columns
        # contiguous
        h_rows = torch.empty((B * CLUSTER, n, _round_up(_slice_max(H), 4)),
                             dtype=f32, device=x.device)
        c_rows = torch.empty_like(h_rows)
    args = dict(idx=idx, coef=coef, eidx=eidx, x=x, rowg=rowg, mask=mask,
                wx=wx, wh=wh, b=b, emsg=emsg, out=outs, h_store=hT,
                c_store=cT, h_rows=h_rows, c_rows=c_rows, proto=None)
    ints = dict(B=B, T=T, n=n, k=k, din=din, H=H, G=G, e=e,
                **dict(zip(("td", "depth"), ring)))
    return _dispatch(name, dims, smem, args, ints, (outs, hT, cT), call,
                     proto)


def _gcrn_dims(idx, x, h0, **ring) -> dict:
    return dict(k=idx.shape[-1], din=x.shape[-1], H=h0.shape[-1],
                n=idx.shape[2], **ring)


def gcrn_engine(idx, coef, eidx, x, rowg, mask, h0, c0, wx, wh, b, emsg=None,
                *, proto: bool = False):
    """GC-LSTM over B streams of T steps in one launch.

    idx/eidx (B, T, n, k) int32, coef (B, T, n, k), x (B, T, n, din),
    rowg (B, T, n) int32 (G drops), mask (B, T, n), h0/c0 (B, G, H),
    wx (din, 4H), wh (H, 4H), b (4H,), emsg (B, T, e, din) or None; all
    float tensors float32, H a multiple of 4. Returns (outs (B, T, n, H), hT,
    cT), and with ``proto`` the launch's ``ProtoLog`` after them."""
    inputs = (idx, coef, eidx, x, rowg, mask, h0, c0, wx, wh, b, emsg)
    refuse_grad("gcrn_engine", *inputs)
    name = "gcrn_engine"
    dims = _gcrn_dims(idx, x, h0)
    smem = smem_bytes(name, **dims)
    _check_budget("gcrn", "vmem", None, smem)
    if _plain_path(name, x):
        return _with_log(name, gcrn_plain(*inputs),
                         dict(mask=mask, h_store=h0), {}, proto)
    return _gcrn_cuda(name, (), dims, smem, (inputs, {}), proto, *inputs)


def gcrn_engine_paged(idx, coef, eidx, x, rowg, mask, h0, c0, wx, wh, b,
                      emsg=None, *, td: int, depth: int = 2,
                      proto: bool = False):
    """``gcrn_engine`` with its t-1 state paged (hbm_paged): the step's
    gathered rows reach the tile pass through a ``depth``-deep ring of
    td-wide column windows. Same arguments and results, bit-identical on
    the card."""
    inputs = (idx, coef, eidx, x, rowg, mask, h0, c0, wx, wh, b, emsg)
    refuse_grad("gcrn_engine_paged", *inputs)
    name = "gcrn_engine_paged"
    _check_ring(name, td, depth)
    dims = _gcrn_dims(idx, x, h0, td=td, depth=depth)
    smem = smem_bytes(name, **dims)
    _check_budget("gcrn", "hbm_paged", td, smem)
    ring = dict(td=td, depth=depth)
    if _plain_path(name, x):
        return _with_log(name, gcrn_paged_plain(*inputs, **ring),
                         dict(mask=mask, h_store=h0), ring, proto)
    return _gcrn_cuda(name, (td, depth), dims, smem, (inputs, ring), proto,
                      *inputs)


# ----------------------------------------------------------- evolve ----

def evolve_plain(idx, coef, x, mask, live, w0, bg, gwx, gwh, gb, eagg=None):
    """The EvolveGCN kernel's function in plain PyTorch, on the same packed
    inputs (every layer one square width D)."""
    L = w0.shape[1]
    outs, wT = _ref.evolve_stream_batched_ref(
        idx, coef, x, mask, live, [w0[:, l] for l in range(L)],
        list(bg), list(gwx), list(gwh), list(gb), eagg)
    return outs, torch.stack(wT, dim=1)


def evolve_paged_plain(idx, coef, x, mask, live, w0, bg, gwx, gwh, gb,
                       eagg=None, *, td, depth):
    """The paged EvolveGCN kernel's function in plain PyTorch, on the packed
    inputs of ``evolve_plain``: W_l is read in (D, td) column windows, in
    the ring's order; the GCN product's output columns of a window come
    from that window alone, and the matrix-GRU evolves each window's
    columns on their own (its batch is W's columns)."""
    _check_ring("evolve_engine_paged", td, depth)
    T, L, D = idx.shape[1], w0.shape[1], w0.shape[2]
    w = w0.clone()
    wins = _windows(D, td)
    outs = []
    for t in range(T):
        a = x[:, t]
        m = mask[:, t][..., None]
        for l in range(L):
            agg = (_ref._take_rows(a, idx[:, t])
                   * coef[:, t][..., None]).sum(dim=-2)
            if eagg is not None:
                agg = agg + eagg[:, t, l]
            h = torch.cat([agg @ w[:, l, :, s] + bg[l, s] for s in wins],
                          dim=-1)
            if l < L - 1:
                h = torch.relu(h)
            a = h * m
        outs.append(a)
        on = (live[:, t] > 0)[:, None, None]
        for l in range(L):
            new = torch.cat([
                _ref.fused_gru(w[:, l, :, s].transpose(1, 2),
                               w[:, l, :, s].transpose(1, 2), gwx[l], gwh[l],
                               gb[l]).transpose(1, 2) for s in wins], dim=-1)
            w[:, l] = torch.where(on, new, w[:, l])
    return torch.stack(outs, dim=1), w


def _live_tiles(mask):
    """(B, T) int32: the node tiles of TILE_ROWS rows of each step that hold
    a nonzero mask (the kernels' live tiles)."""
    B, T, n = mask.shape
    live = torch.nn.functional.pad(mask != 0, (0, -n % TILE_ROWS))
    return live.view(B, T, -1, TILE_ROWS).any(-1).sum(-1).to(
        torch.int32).contiguous()


def _evolve_cuda(name, ring, dims, smem, call, proto, idx, coef, x, mask,
                 live, w0, bg, gwx, gwh, gb, eagg):
    """Check the tensors and assemble the EvolveGCN kernel ``name``'s launch
    (``ring``: () resident, (td, depth) paged), then record or launch it."""
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
    outs = torch.empty((B, T, n, D), dtype=f32, device=x.device)
    wT = w0.clone()
    # each step's live node tiles: the matrix-GRU threads pace their
    # cluster-barrier arrivals by them
    tiles = _live_tiles(mask)
    act = torch.empty((B, 2, n, D), dtype=f32, device=x.device)
    args = dict(idx=idx, coef=coef, x=x, mask=mask, live=live, tiles=tiles,
                bg=bg, gwx=gwx, gwh=gwh, gb=gb, eagg=eagg, out=outs, w=wT,
                act=act)
    if ring:
        # each CTA's columns of every W_l, its pages in global memory
        args["wpage"] = torch.empty(
            (B, L, CLUSTER, D, _round_up(_slice_max(D), 4)), dtype=f32,
            device=x.device)
    args["proto"] = None
    ints = dict(B=B, T=T, n=n, k=k, L=L, D=D,
                **dict(zip(("td", "depth"), ring)))
    return _dispatch(name, dims, smem, args, ints, (outs, wT), call, proto)


def evolve_engine(idx, coef, x, mask, live, w0, bg, gwx, gwh, gb, eagg=None,
                  *, proto: bool = False):
    """L-layer GCN with matrix-GRU-evolved weights over B streams of T
    steps in one launch.

    idx (B, T, n, k) int32, coef (B, T, n, k), x (B, T, n, D),
    mask (B, T, n), live (B, T) int32, w0 (B, L, D, D), bg (L, D),
    gwx/gwh (L, D, 3D), gb (L, 3D), eagg (B, T, L, n, D) or None; D a
    multiple of ``ROW_ALIGN``. Returns (outs (B, T, n, D), wT (B, L, D, D)),
    and with ``proto`` the launch's ``ProtoLog`` after them."""
    inputs = (idx, coef, x, mask, live, w0, bg, gwx, gwh, gb, eagg)
    refuse_grad("evolve_engine", *inputs)
    name = "evolve_engine"
    k, L = idx.shape[-1], w0.shape[1]
    dims = dict(k=k, L=L, D=w0.shape[2])
    smem = smem_bytes(name, **dims)
    _check_budget("evolve", "vmem", None, smem, lambda: (
        "a resident EvolveGCN CTA holds two planes of its columns of every "
        f"layer's W: at k {k}, L {L} it fits up to D "
        f"{evolve_resident_max_d(k, L)}"))
    if _plain_path(name, x):
        return _with_log(name, evolve_plain(*inputs),
                         dict(mask=mask, live=live, w=w0), {}, proto)
    return _evolve_cuda(name, (), dims, smem, (inputs, {}), proto, *inputs)


def evolve_engine_paged(idx, coef, x, mask, live, w0, bg, gwx, gwh, gb,
                        eagg=None, *, td: int, depth: int = 2,
                        proto: bool = False):
    """``evolve_engine`` with W paged (hbm_paged): each W_l moves through a
    ``depth``-deep ring of (D, td) column windows and no D x D buffer sits in
    shared memory. Same arguments and results, bit-identical on the card."""
    inputs = (idx, coef, x, mask, live, w0, bg, gwx, gwh, gb, eagg)
    refuse_grad("evolve_engine_paged", *inputs)
    name = "evolve_engine_paged"
    _check_ring(name, td, depth)
    dims = dict(k=idx.shape[-1], D=w0.shape[2], td=td, depth=depth)
    smem = smem_bytes(name, **dims)
    _check_budget("evolve", "hbm_paged", td, smem)
    ring = dict(td=td, depth=depth)
    if _plain_path(name, x):
        return _with_log(name, evolve_paged_plain(*inputs, **ring),
                         dict(mask=mask, live=live, w=w0), ring, proto)
    return _evolve_cuda(name, (td, depth), dims, smem, (inputs, ring), proto,
                        *inputs)


# ------------------------------------------------------- edge terms ----

def edge_terms_plain(eidx, coef, feat, n_nodes, w_edge, width: int):
    """The edge-term kernel's function in plain PyTorch: the torch path's
    terms (``ref.evolve_edge_terms``) on rows below ``n_nodes``, zeros on
    the rest, each layer zero-padded to ``width`` and stacked on the
    layer axis."""
    n = eidx.shape[-2]
    live = (torch.arange(n, device=eidx.device)
            < n_nodes[..., None])[..., None]
    return torch.stack([
        torch.nn.functional.pad(torch.where(live, t, 0.0),
                                (0, width - t.shape[-1]))
        for t in _ref.evolve_edge_terms(eidx, coef, feat, w_edge)], dim=-3)


def edge_terms(eidx, coef, feat, n_nodes, w_edge, width: int):
    """EvolveGCN-O's per-layer edge terms, written in the square layout the
    evolve engine reads (``ops._square_layers``), by one launch.

    eidx (..., n, k) int32 ids into each snapshot's edge-feature table
    feat (..., E, De), coef (..., n, k), n_nodes (...) int32, ``w_edge``
    the L layers' edge projections (De, din_l), ``width`` the square width
    D (a multiple of 4, at least every din_l); float tensors float32.
    Returns (..., L, n, D): layer l's term sum_d (sum_j coef[v, j] *
    feat[eidx[v, j], d]) * w_edge_l[d, c] in the columns c < din_l of rows
    v < n_nodes, with ``ref.evolve_edge_terms``' bits; zeros elsewhere.
    The ids are not range-checked on the host, which would block the call
    on the card: the kernel traps on an id outside [0, E), as torch's
    gather asserts."""
    name = "edge_terms"
    refuse_grad(name, eidx, coef, feat, *w_edge)
    if _device_kind(name, feat) == "cpu":
        return edge_terms_plain(eidx, coef, feat, n_nodes, w_edge, width)
    lead, (n, k) = eidx.shape[:-2], eidx.shape[-2:]
    E, De = feat.shape[-2:]
    L = len(w_edge)
    f32, i32 = torch.float32, torch.int32
    _check(name, feat.device, eidx=(eidx, i32), coef=(coef, f32),
           feat=(feat, f32), n_nodes=(n_nodes, i32),
           **{f"w_edge[{l}]": (w, f32) for l, w in enumerate(w_edge)})
    dins = [w.shape[-1] for w in w_edge]
    if (coef.shape != eidx.shape or feat.shape[:-2] != lead
            or n_nodes.shape != lead
            or any(w.shape != (De, c) for w, c in zip(w_edge, dins))):
        raise ValueError(f"{name}: inconsistent shapes")
    if not (1 <= L <= EDGE_MAX_LAYERS and k >= 1 and E >= 1 and De >= 1
            and width % 4 == 0 and 1 <= min(dins)
            and max(dins) <= width):
        raise ValueError(
            f"{name}: L={L} (1 to {EDGE_MAX_LAYERS}), k={k}, E={E}, "
            f"De={De}, widths {dins} within width={width} (a multiple "
            "of 4) are not taken")
    _check_smem(name, smem_bytes(name, k=k, De=De, L=L, D=width),
                f"k={k}, De={De}, L={L}, D={width}")
    out = torch.empty((*lead, L, n, width), dtype=f32, device=feat.device)
    lib = _library(name)
    w_ptrs = (ctypes.c_void_p * L)(*(w.data_ptr() for w in w_edge))
    widths = (ctypes.c_int * L)(*dins)
    with _obs.span("launch", kernel=name), torch.cuda.device(feat.device):
        _launch(name, lib, _ptr(eidx), _ptr(coef), _ptr(feat),
                _ptr(n_nodes), ctypes.cast(w_ptrs, ctypes.c_void_p),
                ctypes.cast(widths, ctypes.c_void_p), _ptr(out),
                math.prod(lead), n, k, E, De, L, width, _stream_ptr())
    return out


# ---------------------------------------------------------- stacked ----

def stacked_plain(idx, coef, eidx, x, rowg, mask, h0, wg, bg, wx, wh, b,
                  emsg=None):
    """The stacked kernel's function in plain PyTorch, on the same packed
    inputs (``rowg`` as for ``gcrn_plain``)."""
    ren = torch.where(rowg < h0.shape[1], rowg, -1)
    return _ref.stacked_stream_batched_ref(idx, coef, eidx, x, ren, mask, h0,
                                           wg, bg, wx, wh, b, emsg)


def stacked_paged_plain(idx, coef, eidx, x, rowg, mask, h0, wg, bg, wx, wh,
                        b, emsg=None, *, td, depth):
    """The paged stacked kernel's function in plain PyTorch: the paged
    kernel stages only each tile's own t-1 rows, window by window, which
    moves no value, so this is ``stacked_plain`` (``td`` and ``depth``
    checked as the kernel's)."""
    _check_ring("stacked_engine_paged", td, depth)
    return stacked_plain(idx, coef, eidx, x, rowg, mask, h0, wg, bg, wx, wh,
                         b, emsg)


def _stacked_cuda(name, ring, dims, smem, call, proto, idx, coef, eidx, x,
                  rowg, mask, h0, wg, bg, wx, wh, b, emsg):
    """Check the tensors and assemble the stacked kernel ``name``'s launch
    (``ring``: () resident, (td, depth) paged), then record or launch it."""
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
    e = 0 if emsg is None else emsg.shape[2]
    outs = torch.empty((B, T, n, H), dtype=f32, device=x.device)
    hT = h0.clone()
    # paged: each CTA's gathered t-1 rows in global memory, its units
    # contiguous
    h_rows = torch.empty((B * CLUSTER, n, _round_up(_slice_max(H), 4)),
                         dtype=f32, device=x.device) if ring else None
    args = dict(idx=idx, coef=coef, eidx=eidx, x=x, rowg=rowg, mask=mask,
                wg=wg, bg=bg, wx=wx, wh=wh, b=b, emsg=emsg, out=outs,
                h_store=hT, h_rows=h_rows, proto=None)
    ints = dict(B=B, T=T, n=n, k=k, din=din, dmid=dmid, H=H, G=G, e=e,
                **dict(zip(("td", "depth"), ring)))
    return _dispatch(name, dims, smem, args, ints, (outs, hT), call, proto)


def _stacked_dims(idx, x, wg, h0, **ring) -> dict:
    return dict(k=idx.shape[-1], din=x.shape[-1], dmid=wg.shape[-1],
                H=h0.shape[-1], **ring)


def stacked_engine(idx, coef, eidx, x, rowg, mask, h0, wg, bg, wx, wh, b,
                   emsg=None, *, proto: bool = False):
    """The last GCN layer and the GRU over B streams of T steps in one
    launch.

    idx/eidx (B, T, n, k) int32, coef (B, T, n, k), x (B, T, n, din) (the
    last layer's input), rowg (B, T, n) int32 (G drops), mask (B, T, n),
    h0 (B, G, H), wg (din, dmid), bg (dmid,), wx (dmid, 3H), wh (H, 3H),
    b (3H,), emsg (B, T, e, din) or None; all float tensors float32, H a
    multiple of 4. Returns (outs (B, T, n, H), hT (B, G, H)), and with
    ``proto`` the launch's ``ProtoLog`` after them."""
    inputs = (idx, coef, eidx, x, rowg, mask, h0, wg, bg, wx, wh, b, emsg)
    refuse_grad("stacked_engine", *inputs)
    name = "stacked_engine"
    dims = _stacked_dims(idx, x, wg, h0)
    smem = smem_bytes(name, **dims)
    _check_budget("stacked", "vmem", None, smem)
    if _plain_path(name, x):
        return _with_log(name, stacked_plain(*inputs),
                         dict(mask=mask, h_store=h0), {}, proto)
    return _stacked_cuda(name, (), dims, smem, (inputs, {}), proto, *inputs)


def stacked_engine_paged(idx, coef, eidx, x, rowg, mask, h0, wg, bg, wx, wh,
                         b, emsg=None, *, td: int, depth: int = 2,
                         proto: bool = False):
    """``stacked_engine`` with its t-1 state paged (hbm_paged): a tile's own
    rows reach it through a ``depth``-deep ring of td-wide column windows.
    Same arguments and results, bit-identical on the card."""
    inputs = (idx, coef, eidx, x, rowg, mask, h0, wg, bg, wx, wh, b, emsg)
    refuse_grad("stacked_engine_paged", *inputs)
    name = "stacked_engine_paged"
    _check_ring(name, td, depth)
    dims = _stacked_dims(idx, x, wg, h0, td=td, depth=depth)
    smem = smem_bytes(name, **dims)
    _check_budget("stacked", "hbm_paged", td, smem)
    ring = dict(td=td, depth=depth)
    if _plain_path(name, x):
        return _with_log(name, stacked_paged_plain(*inputs, **ring),
                         dict(mask=mask, h_store=h0), ring, proto)
    return _stacked_cuda(name, (td, depth), dims, smem, (inputs, ring), proto,
                         *inputs)


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


def tgn_paged_plain(idx, coef, ts, x, rowg, mask, mem0, freq, w_in, wx, wh,
                    b, *, td, depth):
    """The paged TGN kernel's function in plain PyTorch, on the packed
    inputs of ``tgn_engine_paged`` (partners by their local id ``idx``):
    each batch gathers its touched rows' t-1 memory, then aggregates its
    partners' rows from it window by window, td columns at a time, in the
    ring's order (the own rows are read as they are). This is
    kernels/ref.py tgn_stream_batched_ref walked by windows."""
    _check_ring("tgn_engine_paged", td, depth)
    G, H = mem0.shape[1:]
    ren = torch.where(rowg < G, rowg, -1)
    store = mem0.clone()
    wins = _windows(H, td)
    outs = []
    for t in range(idx.shape[1]):
        r, m = ren[:, t], mask[:, t]
        c = coef[:, t][..., None]
        rows = _ref._gather_rows(store, r, m)
        agg_m = torch.cat([(_ref._take_rows(rows[..., w], idx[:, t]) * c)
                           .sum(dim=-2) for w in wins], dim=-1)
        agg_e = (torch.cos(ts[:, t][..., None] * freq) * c).sum(dim=-2)
        inp = x[:, t] @ w_in + agg_m + agg_e
        m_new = _ref.fused_gru(inp, rows, wx, wh, b) * m[..., None]
        _ref._scatter_rows_(store, r, m_new)
        outs.append(m_new)
    return torch.stack(outs, dim=1), store


def _local_ids(gidx, rowg, G: int):
    """Each lane's partner as a local id of its batch: the row v whose
    global row rowg[v] is the lane's gidx (0 where no row of the batch is:
    a lane off the event contract, or a coef-0 one), int32."""
    B, T, n, k = gidx.shape
    rows = rowg.reshape(B * T, n).long()
    rows = torch.where(rows < G, rows, torch.full_like(rows, -1))
    srt, order = torch.sort(rows, dim=-1)
    want = gidx.reshape(B * T, n * k).long()
    pos = torch.searchsorted(srt, want).clamp_(max=n - 1)
    hit = torch.gather(srt, -1, pos) == want
    lid = torch.where(hit, torch.gather(order, -1, pos),
                      torch.zeros_like(pos))
    return lid.to(torch.int32).reshape(B, T, n, k).contiguous()


def _tgn_cuda(name, ring, dims, smem, call, proto, lane, coef, ts, x, rowg,
              mask, mem0, freq, w_in, wx, wh, b, lid=None):
    """Check the tensors and assemble the TGN kernel ``name``'s launch
    (``ring``: () resident with ``lane`` the partners' global rows and
    ``lid`` their local ids, derived from ``lane`` and ``rowg`` where None;
    (td, depth) paged with ``lane`` their local ids), then record or launch
    it."""
    B, T, n, k = lane.shape
    din, (G, H) = x.shape[-1], mem0.shape[1:]
    f32, i32 = torch.float32, torch.int32
    _check(name, x.device, **{"idx" if ring else "gidx": (lane, i32)},
           coef=(coef, f32), ts=(ts, f32),
           x=(x, f32), rowg=(rowg, i32), mask=(mask, f32), mem0=(mem0, f32),
           freq=(freq, f32), w_in=(w_in, f32), wx=(wx, f32), wh=(wh, f32),
           b=(b, f32))
    if (coef.shape != lane.shape or ts.shape != lane.shape
            or x.shape[:3] != (B, T, n) or rowg.shape != (B, T, n)
            or mask.shape != (B, T, n) or mem0.shape != (B, G, H)
            or freq.shape != (H,) or w_in.shape != (din, H)
            or wx.shape != (H, 3 * H) or wh.shape != (H, 3 * H)
            or b.shape != (3 * H,)):
        raise ValueError(f"{name}: inconsistent shapes")
    if ring:
        _check_index(name, "idx", lane, n)
    else:
        _check_index(name, "gidx", lane, G)
    _check_index(name, "rowg", rowg, G + 1)
    if H % 4:
        raise ValueError(f"{name}: H={H} must be a multiple of 4 (the "
                         "store rows move as float4)")
    outs = torch.empty((B, T, n, H), dtype=f32, device=x.device)
    memT = mem0.clone()
    if ring:
        lanes = dict(lid=lane)
    else:
        # the partners' local ids beside their global rows: the resident
        # kernel sums them in the paged kernel's row windows
        if lid is None:
            lid = _local_ids(lane, rowg, G)
        else:
            _check(name, x.device, idx=(lid, i32))
            if lid.shape != lane.shape:
                raise ValueError(f"{name}: inconsistent shapes")
            _check_index(name, "idx", lid, n)
        lanes = dict(gidx=lane, lid=lid)
    args = dict(**lanes, coef=coef, ts=ts, x=x, rowg=rowg, mask=mask,
                freq=freq, w_in=w_in, wx=wx, wh=wh, b=b, out=outs,
                store=memT)
    if ring:
        # each CTA's gathered t-1 rows in global memory, its units contiguous
        args["rows"] = torch.empty(
            (B * CLUSTER, n, _round_up(_slice_max(H), 4)), dtype=f32,
            device=x.device)
    args["proto"] = None
    ints = dict(B=B, T=T, n=n, k=k, din=din, H=H, G=G,
                **dict(zip(("td", "depth"), ring)))
    return _dispatch(name, dims, smem, args, ints, (outs, memT), call, proto)


def tgn_engine(gidx, coef, ts, x, rowg, mask, mem0, freq, w_in, wx, wh, b,
               *, idx=None, proto: bool = False):
    """TGN node memory over B streams of T event batches in one launch.

    gidx (B, T, n, k) int32 global row of each event lane's partner,
    coef/ts (B, T, n, k) (lane weight, event time), x (B, T, n, din),
    rowg (B, T, n) int32 (G drops), mask (B, T, n), mem0 (B, G, H),
    freq (H,), w_in (din, H), wx/wh (H, 3H), b (3H,); all float tensors
    float32, H a multiple of 4. ``idx`` (B, T, n, k) int32: each lane's
    partner as its local id, where the caller has it (the kernel sums
    partners in the paged kernel's row windows; found from gidx and rowg
    where None; the plain version needs none). Returns (outs (B, T, n,
    H), memT (B, G, H)), and with ``proto`` the launch's ``ProtoLog`` after
    them."""
    inputs = (gidx, coef, ts, x, rowg, mask, mem0, freq, w_in, wx, wh, b)
    refuse_grad("tgn_engine", *inputs)
    name = "tgn_engine"
    dims = dict(k=gidx.shape[-1], din=x.shape[-1], H=mem0.shape[-1])
    smem = smem_bytes(name, **dims)
    _check_budget("tgn", "vmem", None, smem)
    if _plain_path(name, x):
        return _with_log(name, tgn_plain(*inputs),
                         dict(mask=mask, store=mem0), {}, proto)
    return _tgn_cuda(name, (), dims, smem, (inputs, {"idx": idx}), proto,
                     *inputs, lid=idx)


def tgn_engine_paged(idx, coef, ts, x, rowg, mask, mem0, freq, w_in, wx, wh,
                     b, *, td: int, depth: int = 2, proto: bool = False):
    """``tgn_engine`` with its memory paged (hbm_paged): each batch gathers
    its touched rows, and partners (by their local id ``idx`` (B, T, n, k)
    int32, in place of ``gidx``) and own rows reach the tile pass through a
    ``depth``-deep ring of td-wide column windows. Otherwise the arguments
    and results of ``tgn_engine``, bit-identical on the card under the
    event contract."""
    inputs = (idx, coef, ts, x, rowg, mask, mem0, freq, w_in, wx, wh, b)
    refuse_grad("tgn_engine_paged", *inputs)
    name = "tgn_engine_paged"
    _check_ring(name, td, depth)
    dims = dict(k=idx.shape[-1], din=x.shape[-1], H=mem0.shape[-1],
                n=idx.shape[2], td=td, depth=depth)
    smem = smem_bytes(name, **dims)
    _check_budget("tgn", "hbm_paged", td, smem)
    ring = dict(td=td, depth=depth)
    if _plain_path(name, x):
        return _with_log(name, tgn_paged_plain(*inputs, **ring),
                         dict(mask=mask, store=mem0), ring, proto)
    return _tgn_cuda(name, (td, depth), dims, smem, (inputs, ring), proto,
                     *inputs)


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


def _check_widths(name: str, widths, L: int, D: int) -> list:
    """The layers' true widths (L + 1 ints in [1, D]), D throughout for
    None."""
    if widths is None:
        return [D] * (L + 1)
    widths = [int(c) for c in widths]
    if len(widths) != L + 1 or not all(1 <= c <= D for c in widths):
        raise ValueError(f"{name}: widths {widths} are not L + 1 = {L + 1} "
                         f"widths in [1, {D}]")
    return widths


def static_engine(idx, coef, x, mask, w, bg, eagg=None, widths=None):
    """L-layer GCN over B independent snapshot slots (T = 1) in one launch,
    a cluster of CLUSTER CTAs a slot, each owning a column slice of every
    layer.

    idx (B, 1, n, k) int32, coef (B, 1, n, k), x (B, 1, n, D),
    mask (B, 1, n), w (L, D, D) and bg (L, D) shared by the slots,
    eagg (B, 1, L, n, D) or None; float tensors float32. ``widths``: the
    layers' true widths (L + 1: din_0, dout_0 = din_1, ..., dout_{L-1};
    None: D throughout), which the kernel computes alone: x, w, bg and eagg
    must be zero past them, as the square pack leaves them. Returns
    outs (B, 1, n, D), zeros past the last width."""
    refuse_grad("static_engine", idx, coef, x, mask, w, bg, eagg)
    name = "static_engine"
    if _plain_path(name, x):
        _check_static_t(idx)
        _check_widths(name, widths, w.shape[0], w.shape[-1])
        return static_plain(idx, coef, x, mask, w, bg, eagg)
    p = _prepare_static_engine(idx, coef, x, mask, w, bg, eagg, widths=widths)
    return p.result if _recorder() is not None else launch(p)


def _prepare_static_engine(idx, coef, x, mask, w, bg, eagg=None,
                           widths=None) -> Prepared:
    name = "static_engine"
    _check_static_t(idx)
    B, T, n, k = idx.shape
    L, D = w.shape[0], w.shape[-1]
    widths = _check_widths(name, widths, L, D)
    f32, i32 = torch.float32, torch.int32
    _check(name, x.device, idx=(idx, i32), coef=(coef, f32), x=(x, f32),
           mask=(mask, f32), w=(w, f32), bg=(bg, f32), eagg=(eagg, f32))
    if (coef.shape != idx.shape or x.shape != (B, T, n, D)
            or mask.shape != (B, T, n) or w.shape != (L, D, D)
            or bg.shape != (L, D)
            or (eagg is not None and eagg.shape != (B, T, L, n, D))):
        raise ValueError(f"{name}: inconsistent shapes")
    _check_index(name, "idx", idx, n)
    # the library's figure; recorded (no library), the estimate
    recorded = _recorder()
    lib = None if recorded is not None else _library(name)
    smem = (smem_bytes(name, k=k, D=D) if lib is None
            else lib.static_engine_smem_bytes(k, D))
    _check_smem(name, smem, f"k={k}, D={D}")
    outs = torch.empty((B, T, n, D), dtype=f32, device=x.device)
    act = torch.empty((B, 2, n, D), dtype=f32, device=x.device)
    if lib is None:
        recorded.append(RecordedLaunch(
            name, dict(k=k, D=D), smem, None,
            dict(idx=idx, coef=coef, x=x, mask=mask, w=w, bg=bg, eagg=eagg,
                 widths=widths, out=outs, act=act),
            dict(B=B, n=n, k=k, L=L, D=D), (outs,),
            ((idx, coef, x, mask, w, bg, eagg), {"widths": widths})))
        return Prepared(name, None, (), outs, ())
    host_widths = (ctypes.c_int * (L + 1))(*widths)
    with torch.cuda.device(x.device):
        args = (_ptr(idx), _ptr(coef), _ptr(x), _ptr(mask), _ptr(w),
                _ptr(bg), _ptr(eagg),
                ctypes.cast(host_widths, ctypes.c_void_p), _ptr(outs),
                _ptr(act), B, n, k, L, D, _stream_ptr())
    return Prepared(name, lib, args, outs,
                    (idx, coef, x, mask, w, bg, eagg, act, host_widths))


# ----------------------------------------- per-step kernels: V2, SpMM ----
# The per-step kernels take microseconds, so their wrappers (and the static
# engine's, whose one launch a run is timed the same way) split in two:
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
    """Check, allocate and marshal one launch of the kernel ``name``
    ("gcrn_step", "stacked_step", "ell_spmm", "fused_gru", "fused_lstm" or
    "static_engine") on CUDA tensors, with that wrapper's arguments."""
    refuse_grad(name, *args, *kwargs.values())
    return _PREPARE[name](*args, **kwargs)


def gcrn_step_plain(idx, coef, eidx, x, h, c, wx, wh, b, emsg=None):
    """The V2 GC-LSTM step kernel's function in plain PyTorch."""
    return _ref.dgnn_fused_step(idx, coef, eidx, x, h, c, wx, wh, b, emsg)


def gcrn_step(idx, coef, eidx, x, h, c, wx, wh, b, emsg=None):
    """One GC-LSTM step of one snapshot, aggregation to LSTM update.

    idx/eidx (n, k) int32, coef (n, k), x (n, din), h/c (n, H),
    wx (din, 4H), wh (H, 4H), b (4H,), emsg (e, din) or None; float tensors
    float32. Returns (h', c'), each (n, H), unmasked."""
    refuse_grad("gcrn_step", idx, coef, eidx, x, h, c, wx, wh, b, emsg)
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
    refuse_grad("stacked_step", idx, coef, eidx, x, h, wg, bg, wx, wh, b, emsg)
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
    refuse_grad("ell_spmm", idx, coef, eidx, x, emsg)
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



# ------------------------------------------------------ fused RNN cells ----
# Per-call kernels like the V2 steps: ``prepare("fused_gru", ...)`` /
# ``launch`` split them for timing bare launches. The grid is the kernel's
# own (a CTA a tile of rows and hidden units, all gates; ``library_ctas``);
# ``tb``, the TPU kernel's row tile, only sets which batches are taken, as
# the JAX kernel asserts.

def _check_tb(name: str, Bs: int, tb) -> None:
    """The TPU kernel's row tile: a positive divisor of the batch."""
    if not (isinstance(tb, int) and tb > 0 and Bs % tb == 0):
        raise ValueError(f"{name}: batch {Bs} is not a multiple of the row "
                         f"tile tb={tb!r}")


def fused_gru_plain(x, h, wx, wh, b):
    """The GRU cell kernel's function in plain PyTorch."""
    return _ref.fused_gru(x, h, wx, wh, b)


def fused_gru(x, h, wx, wh, b, *, tb: int = 128):
    """GRU cell over Bs rows: gx = x @ wx + b, gh = h @ wh (r | z | n),
    h' = (1 - z) n + z h.

    x (Bs, din), h (Bs, H), wx (din, 3H), wh (H, 3H), b (3H,), float32;
    Bs a multiple of tb. Returns h' (Bs, H)."""
    refuse_grad("fused_gru", x, h, wx, wh, b)
    _check_tb("fused_gru", x.shape[0], tb)
    if _device_kind("fused_gru", x) == "cpu":
        return fused_gru_plain(x, h, wx, wh, b)
    return launch(_prepare_fused_gru(x, h, wx, wh, b, tb=tb))


def _prepare_fused_gru(x, h, wx, wh, b, *, tb: int = 128) -> Prepared:
    name = "fused_gru"
    (Bs, din), H = x.shape, h.shape[-1]
    _check_tb(name, Bs, tb)
    f32 = torch.float32
    _check(name, x.device, x=(x, f32), h=(h, f32), wx=(wx, f32),
           wh=(wh, f32), b=(b, f32))
    if (h.shape != (Bs, H) or wx.shape != (din, 3 * H)
            or wh.shape != (H, 3 * H) or b.shape != (3 * H,)):
        raise ValueError(f"{name}: inconsistent shapes")
    lib = _library(name)
    out = torch.empty((Bs, H), dtype=f32, device=x.device)
    with torch.cuda.device(x.device):
        args = (_ptr(x), _ptr(h), _ptr(wx), _ptr(wh), _ptr(b), _ptr(out), Bs,
                din, H, _stream_ptr())
    return Prepared(name, lib, args, out, (x, h, wx, wh, b))


def fused_lstm_plain(x, h, c, wx, wh, b):
    """The LSTM cell kernel's function in plain PyTorch."""
    return _ref.fused_lstm(x, h, c, wx, wh, b)


def fused_lstm(x, h, c, wx, wh, b, *, tb: int = 128):
    """LSTM cell over Bs rows: gates = x @ wx + h @ wh + b (i | f | g | o),
    c' = sig(f) c + sig(i) tanh(g), h' = sig(o) tanh(c').

    x (Bs, din), h/c (Bs, H), wx (din, 4H), wh (H, 4H), b (4H,), float32;
    Bs a multiple of tb. Returns (h', c'), each (Bs, H)."""
    refuse_grad("fused_lstm", x, h, c, wx, wh, b)
    _check_tb("fused_lstm", x.shape[0], tb)
    if _device_kind("fused_lstm", x) == "cpu":
        return fused_lstm_plain(x, h, c, wx, wh, b)
    return launch(_prepare_fused_lstm(x, h, c, wx, wh, b, tb=tb))


def _prepare_fused_lstm(x, h, c, wx, wh, b, *, tb: int = 128) -> Prepared:
    name = "fused_lstm"
    (Bs, din), H = x.shape, h.shape[-1]
    _check_tb(name, Bs, tb)
    f32 = torch.float32
    _check(name, x.device, x=(x, f32), h=(h, f32), c=(c, f32), wx=(wx, f32),
           wh=(wh, f32), b=(b, f32))
    if (h.shape != (Bs, H) or c.shape != (Bs, H) or wx.shape != (din, 4 * H)
            or wh.shape != (H, 4 * H) or b.shape != (4 * H,)):
        raise ValueError(f"{name}: inconsistent shapes")
    lib = _library(name)
    h_out = torch.empty((Bs, H), dtype=f32, device=x.device)
    c_out = torch.empty_like(h_out)
    with torch.cuda.device(x.device):
        args = (_ptr(x), _ptr(h), _ptr(c), _ptr(wx), _ptr(wh), _ptr(b),
                _ptr(h_out), _ptr(c_out), Bs, din, H, _stream_ptr())
    return Prepared(name, lib, args, (h_out, c_out), (x, h, c, wx, wh, b))


_PREPARE = {"static_engine": _prepare_static_engine,
            "gcrn_step": _prepare_gcrn_step,
            "stacked_step": _prepare_stacked_step,
            "ell_spmm": _prepare_ell_spmm,
            "fused_gru": _prepare_fused_gru,
            "fused_lstm": _prepare_fused_lstm}
