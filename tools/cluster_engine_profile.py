#!/usr/bin/env python3
"""Where a stacked / TGN cluster engine's or a V2 step's (GC-LSTM, GCN ->
GRU) time goes, on one CUDA card.

    python3 tools/cluster_engine_profile.py

Copies src/repro_torch into build/cluster_profile/ (gitignored), turns the
`// PROF_INIT`, `// PROF(i) <phase>` and `// PROF_END` comments of the
copy's stacked_engine.cu, tgn_engine.cu, gcrn_step.cu, stacked_step.cu
and static_engine.cu into clock64 marks (thread 0 of one CTA, the first
unless a <source>_profile_cta entry point picks another, sums the cycles
of phase i up to mark i; a <source>_profile entry point reads them back),
builds the copy and runs
each engine, resident and paged (td 16, depth 2), on the BC-Alpha main
path's B 1 inputs (the 137-step stream; TGN's 176 event batches), then
gcrn_step and stacked_step on the main path's recorded calls
(chip_smoke.py's ``recorded_step_calls``; CTA 0 is a live tile's), then
static_engine on the main path's 137 slots (profiling the first CTA of
the slot with the most live rows, slot b running on CTAs [8 b, 8 b + 8))
and its wave probe. Prints each engine run's ms (CUDA events, median of 3)
and its cycles split by the phases the comments name; for a V2 step the
cycles of a call, summed over the calls.
The marks cost a little time of their own; the kernels the repo ships
carry none. Prints the card's name and power limit first.
"""
import ctypes
import os
import re
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COPY = ROOT / "build" / "cluster_profile"
SOURCES = ("stacked_engine", "tgn_engine", "gcrn_step", "stacked_step",
           "static_engine")

PRE = """
__device__ unsigned long long g_prof[16];
__device__ unsigned g_prof_cta;
#define PROF_INIT const bool prof_on = blockIdx.x == g_prof_cta && \\
  threadIdx.x == 0; \\
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
            "sizeof(g_prof));\n}\n"
            f"int {source}_profile_cta(unsigned cta) {{\n"
            "  return (int)cudaMemcpyToSymbol(g_prof_cta, &cta, "
            "sizeof(cta));\n}\n", 1)
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
    params = {}
    for cfg in (cs.GCRN_M2, cs.STACKED):
        model = cs.build_model(cfg, n_global=n_global)
        params[cfg.name] = cs.ops.to_device(model.init(gen), "cuda")
    g_calls, s_calls, _ = cs.recorded_step_calls(
        params, n_global, np_stream.to("cuda"), np_stream)
    for name, calls in (("gcrn_step", g_calls), ("stacked_step", s_calls)):
        names = phases[name]
        summed = [0] * 16
        for c in calls:
            getattr(engine, name)(*c)
            torch.cuda.synchronize()
            out = (ctypes.c_ulonglong * 16)()
            code = getattr(engine._LIBS[name], f"{name}_profile")(out)
            cs.check(code == 0, f"{name}_profile read back ({code})")
            summed = [a + b for a, b in zip(summed, out)]
        total = sum(summed)
        print(f"{name}: {len(calls)} main-path calls; cycles of CTA 0 "
              f"thread 0, {total / len(calls):.0f} a call: " + ", ".join(
                  f"{names[i]} {summed[i] / total:.3f}"
                  for i in range(len(names)) if summed[i]), flush=True)
    # the static engine on the main path's 137 slots, profiled on the
    # first CTA of the slot with the most live rows; then its wave probe
    cfg = cs.STATIC_GCN
    model = cs.build_model(cfg, n_global=n_global)
    solo = cs.batch_of(np_stream, ((0, np_stream.node_mask.shape[0]),))
    inp = cs.kernel_inputs(model, cs.ops.to_device(model.init(gen), "cuda"),
                           solo)
    widths = [cfg.in_dim] + [cfg.hidden] * (cfg.n_gnn_layers - 1) + [
        cfg.out_dim]
    rows = inp[3].reshape(inp[3].shape[0], -1).ne(0).sum(-1)
    slot = int(rows.argmax())
    lib = engine._library("static_engine")
    code = lib.static_engine_profile_cta(ctypes.c_uint(slot * engine.CLUSTER))
    cs.check(code == 0, f"static_engine_profile_cta ({code})")
    ms = cs.cuda_ms(lambda: engine.static_engine(*inp, widths=widths), reps=3)
    out = (ctypes.c_ulonglong * 16)()
    code = engine._LIBS["static_engine"].static_engine_profile(out)
    cs.check(code == 0, f"static_engine_profile read back ({code})")
    names, total = phases["static_engine"], sum(out)
    print(f"static_engine: {ms:.3f} ms; cycles of slot {slot}'s CTA 0 "
          f"thread 0 ({int(rows[slot])} live rows, the most) over the last "
          f"call: {total}; " + ", ".join(
              f"{names[i]} {out[i] / total:.3f}"
              for i in range(len(names)) if out[i]), flush=True)
    cs.static_wave_probe(inp, widths)
    return 0


if __name__ == "__main__":
    sys.exit(main())
