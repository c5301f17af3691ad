"""Build, bind and launch the hand-written CUDA kernels.

Eighteen kernels from eleven sources under ``csrc/``: the stream engines of
the three dense-snapshot families (``gcrn_engine.cu``, ``evolve_engine.cu``,
``stacked_engine.cu``), of the event-driven TGN (``tgn_engine.cu``) and of
the static GCN (``static_engine.cu``), all level v3; the paged variants of
the four stateful engines (``<family>_engine_paged``, hbm_paged residency:
the same source compiled with its paging flag, the t-1 state staged
through a ring of td-wide windows); the V2 fused steps (``gcrn_step.cu``,
``stacked_step.cu``); the ELL SpMM of the message-passing stage
(``ell_spmm.cu``, ``impl="pallas"``); the fused GRU and LSTM cells
(``fused_rnn.cu``); and the LM scaffold's flash attention: the forward,
with and without the logsumexp rows (``flash_attention.cu``), and the
backward's dK / dV and dQ passes (``flash_attention_bwd.cu``); their
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
of ``CHUNK_ROWS``.
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
           "static_engine", "gcrn_step", "stacked_step", "ell_spmm",
           "gcrn_engine_paged", "evolve_engine_paged", "stacked_engine_paged",
           "tgn_engine_paged", "fused_gru", "fused_lstm", "flash_attention",
           "flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
#: the source (``csrc/<source>.cu``, one library) of each kernel
SOURCE = {**{name: name for name in KERNELS[:8]},
          **{f"{family}_engine_paged": f"{family}_engine"
             for family in ("gcrn", "evolve", "stacked", "tgn")},
          "fused_gru": "fused_rnn", "fused_lstm": "fused_rnn",
          "flash_attention": "flash_attention",
          "flash_fwd": "flash_attention",
          "flash_bwd_dkv": "flash_attention_bwd",
          "flash_bwd_dq": "flash_attention_bwd"}

#: the per-step and stacked / tgn / static kernels' register micro-tile:
#: each thread owns this many node rows. The kernels take any node count;
#: the evolve kernel needs its square width D to be a multiple of it (its
#: GRU's gwx / gwh slabs are whole rows of it, and a cluster of 8 CTAs
#: then splits D evenly), which kernels/ops.py pads to.
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
    "gcrn_engine": (15, 8, 4),
    "evolve_engine": (14, 6, 3),
    "stacked_engine": (15, 9, 4),
    "tgn_engine": (14, 7, 3),
    "static_engine": (9, 5, 2),
    "gcrn_step": (12, 4, 3),
    "stacked_step": (12, 5, 4),
    "ell_spmm": (6, 6, 0),
    "gcrn_engine_paged": (15, 10, 6),
    "evolve_engine_paged": (15, 8, 4),
    "stacked_engine_paged": (15, 11, 6),
    "tgn_engine_paged": (14, 9, 6),
    "fused_gru": (6, 3, 2),
    "fused_lstm": (8, 3, 2),
    "flash_attention": (5, 7, 0),
    "flash_fwd": (5, 7, 0),
    "flash_bwd_dkv": (8, 7, 0),
    "flash_bwd_dq": (7, 7, 0),
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


# ------------------------------------------------------ shared memory ----

def _tile(cols: int) -> int:
    """Bytes of a k-major node tile of ``cols`` columns."""
    return 4 * cols * TILE_STRIDE


def _ell(k: int, words: int) -> int:
    """Bytes of a tile's ELL lanes, ``words`` 4-byte values a lane."""
    return TILE_ROWS * k * 4 * words


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
    "static_engine": (("k", "D"), lambda k, D: _tile(2 * D) + _ell(k, 2)),
    "gcrn_step": (("k", "din", "H"),
                  lambda k, din, H: _tile(din + H) + _ell(k, 3)),
    "stacked_step": (("k", "din", "dmid", "H"),
                     lambda k, din, dmid, H: _tile(din + dmid + H)
                     + _ell(k, 3)),
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


def _gcrn_cuda(name, ring, idx, coef, eidx, x, rowg, mask, h0, c0, wx, wh,
               b, emsg):
    """Check CUDA tensors and launch the GCRN kernel ``name`` (``ring``: ()
    resident, (td, depth) paged)."""
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
    with torch.cuda.device(x.device):
        _launch(name, lib, _ptr(idx), _ptr(coef), _ptr(eidx), _ptr(x),
                _ptr(rowg), _ptr(mask), _ptr(wx), _ptr(wh), _ptr(b),
                _ptr(emsg), _ptr(outs), _ptr(hT), _ptr(cT), _ptr(h_rows),
                _ptr(c_rows), B, T, n, k, din, H, G, e, *ring, _stream_ptr())
    return outs, hT, cT


def gcrn_engine(idx, coef, eidx, x, rowg, mask, h0, c0, wx, wh, b, emsg=None):
    """GC-LSTM over B streams of T steps in one launch.

    idx/eidx (B, T, n, k) int32, coef (B, T, n, k), x (B, T, n, din),
    rowg (B, T, n) int32 (G drops), mask (B, T, n), h0/c0 (B, G, H),
    wx (din, 4H), wh (H, 4H), b (4H,), emsg (B, T, e, din) or None; all
    float tensors float32, H a multiple of 4. Returns (outs (B, T, n, H), hT, cT)."""
    refuse_grad("gcrn_engine", idx, coef, eidx, x, rowg, mask, h0, c0, wx,
                wh, b, emsg)
    name = "gcrn_engine"
    _check_budget("gcrn", "vmem", None, smem_bytes(
        name, k=idx.shape[-1], din=x.shape[-1], H=h0.shape[-1],
        n=idx.shape[2]))
    if _device_kind(name, x) == "cpu":
        return gcrn_plain(idx, coef, eidx, x, rowg, mask, h0, c0, wx, wh, b,
                          emsg)
    return _gcrn_cuda(name, (), idx, coef, eidx, x, rowg, mask, h0, c0, wx,
                      wh, b, emsg)


def gcrn_engine_paged(idx, coef, eidx, x, rowg, mask, h0, c0, wx, wh, b,
                      emsg=None, *, td: int, depth: int = 2):
    """``gcrn_engine`` with its t-1 state paged (hbm_paged): the step's
    gathered rows reach the tile pass through a ``depth``-deep ring of
    td-wide column windows. Same arguments and results, bit-identical on
    the card."""
    refuse_grad("gcrn_engine_paged", idx, coef, eidx, x, rowg, mask, h0,
                c0, wx, wh, b, emsg)
    name = "gcrn_engine_paged"
    _check_ring(name, td, depth)
    _check_budget("gcrn", "hbm_paged", td, smem_bytes(
        name, k=idx.shape[-1], din=x.shape[-1], H=h0.shape[-1],
        n=idx.shape[2], td=td, depth=depth))
    if _device_kind(name, x) == "cpu":
        return gcrn_paged_plain(idx, coef, eidx, x, rowg, mask, h0, c0, wx,
                                wh, b, emsg, td=td, depth=depth)
    return _gcrn_cuda(name, (td, depth), idx, coef, eidx, x, rowg, mask, h0,
                      c0, wx, wh, b, emsg)


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


def _evolve_cuda(name, ring, idx, coef, x, mask, live, w0, bg, gwx, gwh, gb,
                 eagg):
    """Check CUDA tensors and launch the EvolveGCN kernel ``name`` (``ring``:
    () resident, (td, depth) paged)."""
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
    outs = torch.empty((B, T, n, D), dtype=f32, device=x.device)
    wT = w0.clone()
    # each step's live node tiles: the matrix-GRU threads pace their
    # cluster-barrier arrivals by them
    tiles = _live_tiles(mask)
    act = torch.empty((B, 2, n, D), dtype=f32, device=x.device)
    # paged: each CTA's columns of every W_l, its pages in global memory
    pages = (torch.empty((B, L, CLUSTER, D, _round_up(_slice_max(D), 4)),
                         dtype=f32, device=x.device),) if ring else ()
    with torch.cuda.device(x.device):
        _launch(name, lib, _ptr(idx), _ptr(coef), _ptr(x), _ptr(mask),
                _ptr(live), _ptr(tiles), _ptr(bg), _ptr(gwx),
                _ptr(gwh), _ptr(gb), _ptr(eagg), _ptr(outs), _ptr(wT),
                _ptr(act), *(_ptr(t) for t in pages), B, T, n, k, L, D,
                *ring, _stream_ptr())
    return outs, wT


def evolve_engine(idx, coef, x, mask, live, w0, bg, gwx, gwh, gb, eagg=None):
    """L-layer GCN with matrix-GRU-evolved weights over B streams of T
    steps in one launch.

    idx (B, T, n, k) int32, coef (B, T, n, k), x (B, T, n, D),
    mask (B, T, n), live (B, T) int32, w0 (B, L, D, D), bg (L, D),
    gwx/gwh (L, D, 3D), gb (L, 3D), eagg (B, T, L, n, D) or None; D a
    multiple of ``ROW_ALIGN``. Returns (outs (B, T, n, D), wT (B, L, D, D))."""
    refuse_grad("evolve_engine", idx, coef, x, mask, live, w0, bg, gwx,
                gwh, gb, eagg)
    name = "evolve_engine"
    k, L = idx.shape[-1], w0.shape[1]
    _check_budget("evolve", "vmem", None, smem_bytes(
        name, k=k, L=L, D=w0.shape[2]), lambda: (
        "a resident EvolveGCN CTA holds two planes of its columns of every "
        f"layer's W: at k {k}, L {L} it fits up to D "
        f"{evolve_resident_max_d(k, L)}"))
    if _device_kind(name, x) == "cpu":
        return evolve_plain(idx, coef, x, mask, live, w0, bg, gwx, gwh, gb,
                            eagg)
    return _evolve_cuda(name, (), idx, coef, x, mask, live, w0, bg, gwx, gwh,
                        gb, eagg)


def evolve_engine_paged(idx, coef, x, mask, live, w0, bg, gwx, gwh, gb,
                        eagg=None, *, td: int, depth: int = 2):
    """``evolve_engine`` with W paged (hbm_paged): each W_l moves through a
    ``depth``-deep ring of (D, td) column windows and no D x D buffer sits in
    shared memory. Same arguments and results, bit-identical on the card."""
    refuse_grad("evolve_engine_paged", idx, coef, x, mask, live, w0, bg,
                gwx, gwh, gb, eagg)
    name = "evolve_engine_paged"
    _check_ring(name, td, depth)
    _check_budget("evolve", "hbm_paged", td, smem_bytes(
        name, k=idx.shape[-1], D=w0.shape[2], td=td, depth=depth))
    if _device_kind(name, x) == "cpu":
        return evolve_paged_plain(idx, coef, x, mask, live, w0, bg, gwx, gwh,
                                  gb, eagg, td=td, depth=depth)
    return _evolve_cuda(name, (td, depth), idx, coef, x, mask, live, w0, bg,
                        gwx, gwh, gb, eagg)


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


def _stacked_cuda(name, ring, idx, coef, eidx, x, rowg, mask, h0, wg, bg, wx,
                  wh, b, emsg):
    """Check CUDA tensors and launch the stacked kernel ``name`` (``ring``:
    () resident, (td, depth) paged)."""
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
    e = 0 if emsg is None else emsg.shape[2]
    outs = torch.empty((B, T, n, H), dtype=f32, device=x.device)
    hT = h0.clone()
    # paged: each CTA's gathered t-1 rows in global memory, its units
    # contiguous
    h_rows = torch.empty((B * CLUSTER, n, _round_up(_slice_max(H), 4)),
                         dtype=f32, device=x.device) if ring else None
    with torch.cuda.device(x.device):
        _launch(name, lib, _ptr(idx), _ptr(coef), _ptr(eidx), _ptr(x),
                _ptr(rowg), _ptr(mask), _ptr(wg), _ptr(bg), _ptr(wx),
                _ptr(wh), _ptr(b), _ptr(emsg), _ptr(outs), _ptr(hT),
                _ptr(h_rows), B, T, n, k, din, dmid, H, G, e, *ring,
                _stream_ptr())
    return outs, hT


def stacked_engine(idx, coef, eidx, x, rowg, mask, h0, wg, bg, wx, wh, b,
                   emsg=None):
    """The last GCN layer and the GRU over B streams of T steps in one
    launch.

    idx/eidx (B, T, n, k) int32, coef (B, T, n, k), x (B, T, n, din) (the
    last layer's input), rowg (B, T, n) int32 (G drops), mask (B, T, n),
    h0 (B, G, H), wg (din, dmid), bg (dmid,), wx (dmid, 3H), wh (H, 3H),
    b (3H,), emsg (B, T, e, din) or None; all float tensors float32, H a
    multiple of 4. Returns (outs (B, T, n, H), hT (B, G, H))."""
    refuse_grad("stacked_engine", idx, coef, eidx, x, rowg, mask, h0, wg,
                bg, wx, wh, b, emsg)
    name = "stacked_engine"
    _check_budget("stacked", "vmem", None, smem_bytes(
        name, k=idx.shape[-1], din=x.shape[-1], dmid=wg.shape[-1],
        H=h0.shape[-1]))
    if _device_kind(name, x) == "cpu":
        return stacked_plain(idx, coef, eidx, x, rowg, mask, h0, wg, bg, wx,
                             wh, b, emsg)
    return _stacked_cuda(name, (), idx, coef, eidx, x, rowg, mask, h0, wg,
                         bg, wx, wh, b, emsg)


def stacked_engine_paged(idx, coef, eidx, x, rowg, mask, h0, wg, bg, wx, wh,
                         b, emsg=None, *, td: int, depth: int = 2):
    """``stacked_engine`` with its t-1 state paged (hbm_paged): a tile's own
    rows reach it through a ``depth``-deep ring of td-wide column windows.
    Same arguments and results, bit-identical on the card."""
    refuse_grad("stacked_engine_paged", idx, coef, eidx, x, rowg, mask, h0,
                wg, bg, wx, wh, b, emsg)
    name = "stacked_engine_paged"
    _check_ring(name, td, depth)
    _check_budget("stacked", "hbm_paged", td, smem_bytes(
        name, k=idx.shape[-1], din=x.shape[-1], dmid=wg.shape[-1],
        H=h0.shape[-1], td=td, depth=depth))
    if _device_kind(name, x) == "cpu":
        return stacked_paged_plain(idx, coef, eidx, x, rowg, mask, h0, wg,
                                   bg, wx, wh, b, emsg, td=td, depth=depth)
    return _stacked_cuda(name, (td, depth), idx, coef, eidx, x, rowg, mask,
                         h0, wg, bg, wx, wh, b, emsg)


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


def _tgn_cuda(name, ring, lane, coef, ts, x, rowg, mask, mem0, freq, w_in,
              wx, wh, b, lid=None):
    """Check CUDA tensors and launch the TGN kernel ``name`` (``ring``: ()
    resident with ``lane`` the partners' global rows and ``lid`` their
    local ids, derived from ``lane`` and ``rowg`` where None; (td, depth)
    paged with ``lane`` their local ids)."""
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
    lib = _library(name)
    outs = torch.empty((B, T, n, H), dtype=f32, device=x.device)
    memT = mem0.clone()
    if ring:
        # each CTA's gathered t-1 rows in global memory, its units contiguous
        lanes = (lane,)
        scratch = (torch.empty((B * CLUSTER, n, _round_up(_slice_max(H), 4)),
                               dtype=f32, device=x.device),)
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
        lanes, scratch = (lane, lid), ()
    with torch.cuda.device(x.device):
        _launch(name, lib, *(_ptr(t) for t in lanes), _ptr(coef), _ptr(ts),
                _ptr(x), _ptr(rowg), _ptr(mask), _ptr(freq), _ptr(w_in),
                _ptr(wx), _ptr(wh), _ptr(b), _ptr(outs), _ptr(memT),
                *(_ptr(t) for t in scratch), B, T, n, k, din, H, G, *ring,
                _stream_ptr())
    return outs, memT


def tgn_engine(gidx, coef, ts, x, rowg, mask, mem0, freq, w_in, wx, wh, b,
               *, idx=None):
    """TGN node memory over B streams of T event batches in one launch.

    gidx (B, T, n, k) int32 global row of each event lane's partner,
    coef/ts (B, T, n, k) (lane weight, event time), x (B, T, n, din),
    rowg (B, T, n) int32 (G drops), mask (B, T, n), mem0 (B, G, H),
    freq (H,), w_in (din, H), wx/wh (H, 3H), b (3H,); all float tensors
    float32, H a multiple of 4. ``idx`` (B, T, n, k) int32: each lane's
    partner as its local id, where the caller has it (the kernel sums
    partners in the paged kernel's row windows; found from gidx and rowg
    where None; the plain version needs none). Returns (outs (B, T, n,
    H), memT (B, G, H))."""
    refuse_grad("tgn_engine", gidx, coef, ts, x, rowg, mask, mem0, freq,
                w_in, wx, wh, b)
    name = "tgn_engine"
    _check_budget("tgn", "vmem", None, smem_bytes(
        name, k=gidx.shape[-1], din=x.shape[-1], H=mem0.shape[-1]))
    if _device_kind(name, x) == "cpu":
        return tgn_plain(gidx, coef, ts, x, rowg, mask, mem0, freq, w_in, wx,
                         wh, b)
    return _tgn_cuda(name, (), gidx, coef, ts, x, rowg, mask, mem0, freq,
                     w_in, wx, wh, b, lid=idx)


def tgn_engine_paged(idx, coef, ts, x, rowg, mask, mem0, freq, w_in, wx, wh,
                     b, *, td: int, depth: int = 2):
    """``tgn_engine`` with its memory paged (hbm_paged): each batch gathers
    its touched rows, and partners (by their local id ``idx`` (B, T, n, k)
    int32, in place of ``gidx``) and own rows reach the tile pass through a
    ``depth``-deep ring of td-wide column windows. Otherwise the arguments
    and results of ``tgn_engine``, bit-identical on the card under the
    event contract."""
    refuse_grad("tgn_engine_paged", idx, coef, ts, x, rowg, mask, mem0,
                freq, w_in, wx, wh, b)
    name = "tgn_engine_paged"
    _check_ring(name, td, depth)
    _check_budget("tgn", "hbm_paged", td, smem_bytes(
        name, k=idx.shape[-1], din=x.shape[-1], H=mem0.shape[-1],
        n=idx.shape[2], td=td, depth=depth))
    if _device_kind(name, x) == "cpu":
        return tgn_paged_plain(idx, coef, ts, x, rowg, mask, mem0, freq,
                               w_in, wx, wh, b, td=td, depth=depth)
    return _tgn_cuda(name, (td, depth), idx, coef, ts, x, rowg, mask, mem0,
                     freq, w_in, wx, wh, b)


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
    refuse_grad("static_engine", idx, coef, x, mask, w, bg, eagg)
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
    ``name`` ("gcrn_step", "stacked_step", "ell_spmm", "fused_gru" or
    "fused_lstm") on CUDA tensors, with that wrapper's arguments."""
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


_PREPARE = {"gcrn_step": _prepare_gcrn_step,
            "stacked_step": _prepare_stacked_step,
            "ell_spmm": _prepare_ell_spmm,
            "fused_gru": _prepare_fused_gru,
            "fused_lstm": _prepare_fused_lstm}
