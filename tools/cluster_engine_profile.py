#!/usr/bin/env python3
"""Where a stacked / TGN cluster engine's time goes, on one CUDA card.

    python3 tools/cluster_engine_profile.py

Copies src/repro_torch into build/cluster_profile/ (gitignored), turns the
`// PROF_INIT`, `// PROF(i) <phase>` and `// PROF_END` comments of the
copy's stacked_engine.cu and tgn_engine.cu into clock64 marks (thread 0
of the first CTA sums the cycles of phase i up to mark i; a
<source>_profile entry point reads them back), builds the copy and runs
each engine, resident and paged (td 16, depth 2), on the BC-Alpha main
path's B 1 inputs (the 137-step stream; TGN's 176 event batches). Prints
each run's ms (CUDA events, median of 3) and its cycles split by the
phases the comments name. The marks cost a little time of their own; the
kernels the repo ships carry none. Prints the card's name and power limit
first.
"""
import ctypes
import os
import re
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COPY = ROOT / "build" / "cluster_profile"
SOURCES = ("stacked_engine", "tgn_engine")

PRE = """
__device__ unsigned long long g_prof[16];
#define PROF_INIT const bool prof_on = blockIdx.x == 0 && threadIdx.x == 0; \\
  long long _pt = clock64(); unsigned long long _pa[16] = {};
#define PROF(i) if (prof_on) { long long _n = clock64(); _pa[i] += _n - _pt; \\
  _pt = _n; }
#define PROF_END if (prof_on) { for (int _i = 0; _i < 16; ++_i) \\
  g_prof[_i] = _pa[_i]; }
"""
MARK = re.compile(r"^(\s*)// PROF\((\d+)\) (.+)$", re.M)
EDGE = re.compile(r"^(\s*)// (PROF_INIT|PROF_END)$", re.M)


def instrument() -> dict:
    """The profiled copy of the port under build/cluster_profile/src;
    returns {source: [phase name by mark]}."""
    src = COPY / "src"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", src / "repro_torch")
    csrc = src / "repro_torch" / "kernels" / "csrc"
    phases = {}
    for source in SOURCES:
        path = csrc / f"{source}.cu"
        text = path.read_text()
        names = [""] * 16
        for m in MARK.finditer(text):
            names[int(m.group(2))] = m.group(3).strip()
        if len(EDGE.findall(text)) != 2 or not any(names):
            raise RuntimeError(f"{source}.cu: no PROF_INIT / PROF_END pair "
                               "or no PROF(i) marks")
        text = MARK.sub(lambda m: f"{m.group(1)}PROF({m.group(2)})", text)
        text = EDGE.sub(lambda m: f"{m.group(1)}{m.group(2)}", text)
        text = text.replace("namespace {\n", PRE + "namespace {\n", 1)
        text = text.replace(
            'extern "C" {\n',
            'extern "C" {\n'
            f"int {source}_profile(unsigned long long* out) {{\n"
            "  return (int)cudaMemcpyFromSymbol(out, g_prof, "
            "sizeof(g_prof));\n}\n", 1)
        path.write_text(text)
        phases[source] = names
    return phases


def main() -> int:
    phases = instrument()
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(COPY / "lib")
    sys.path[:0] = [str(COPY / "src"), str(ROOT)]
    import torch
    from repro_torch.kernels import engine  # the profiled copy
    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("cluster_engine_profile: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.smi(), flush=True)
    engine.build(SOURCES)
    np_stream, n_global = cs.bc_alpha()
    np_events = cs.bc_alpha_events()
    gen = torch.Generator().manual_seed(cs.SEED)
    for cfg in (cs.STACKED, cs.TGN):
        model = cs.build_model(cfg, n_global=n_global)
        params = cs.ops.to_device(model.init(gen), "cuda")
        family = model.stream_family
        np_s = np_events if cfg is cs.TGN else np_stream
        solo = cs.batch_of(np_s, ((0, np_s.node_mask.shape[0]),))
        resident = cs.kernel_inputs(model, params, solo)
        paged = cs.kernel_inputs(model, params, solo, residency="hbm_paged")
        mask = resident[5]
        n = mask.shape[-1]
        live = torch.nn.functional.pad(mask != 0, (0, -n % 32))
        tiles = int(live.view(*mask.shape[:2], -1, 32).any(-1).sum())
        print(f"{family}: {tiles} live tiles in {mask.shape[1]} steps",
              flush=True)
        names = phases[f"{family}_engine"]
        for label, name, args, ring in (
                ("resident", f"{family}_engine", resident, {}),
                ("paged d2", f"{family}_engine_paged", paged,
                 dict(td=16, depth=2))):
            run = lambda: getattr(engine, name)(*args, **ring)  # noqa: E731
            ms = cs.cuda_ms(run, reps=3)
            out = (ctypes.c_ulonglong * 16)()
            code = getattr(engine._LIBS[name], f"{name.removesuffix('_paged')}"
                           "_profile")(out)
            cs.check(code == 0, f"{name}_profile read back ({code})")
            total = sum(out)
            print(f"{name}: {ms:.3f} ms; cycles of CTA 0 thread 0 over the "
                  f"last call: {total}; " + ", ".join(
                      f"{names[i]} {out[i] / total:.3f}"
                      for i in range(len(names)) if out[i]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
