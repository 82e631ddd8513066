#!/usr/bin/env python3
"""Where the fused-aggregation kernel spends its cycles, phase by phase.

    python3 tools/profile_fused_agg.py [--bf16] [--out FILE.json]

Builds a copy of nerfloc_tpu_torch/csrc/fused_agg.cu in which consumer
thread 0 of every CTA records clock64() after each consumer barrier (the
shipped kernel carries no instrumentation), launches it at the query shapes
(N=1024 with K=8 and K=1) and at the render shape (N=262144, K=8) for each
tile size, and prints the median cycles of each phase over the first 512
CTAs, labelled with the source line the barrier closes. --bf16 profiles
the bf16 instantiation (mv_agg and nb_feat in bf16). Needs one CUDA card
and nvcc; prints the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "nerfloc_tpu_torch", "csrc", "fused_agg.cu")
MAX_CTAS = 512
MAX_STAMPS = 32


def stamped_source() -> tuple[str, list[str]]:
    """The kernel source with a clock64 stamp after every consumer barrier,
    before the K=1 return and at the end, and a label for each stamp (the
    source line and the code it closes)."""
    src = open(SRC).read()
    src = src.replace("namespace {\n",
                      f"__device__ long long g_stamps[{MAX_CTAS * MAX_STAMPS}];\n\n"
                      "namespace {\n", 1)
    src = src.replace('}  // extern "C"', '''int fused_agg_stamps(long long* host, int clear) {
  if (clear) {
    void* p = nullptr;
    cudaGetSymbolAddress(&p, g_stamps);
    return (int)cudaMemset(p, 0, sizeof(g_stamps));
  }
  return (int)cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));
}
}  // extern "C"''')
    start = src.index("  const int n0 = blockIdx.x * T;")
    end = src.index("\nstruct Plan")
    line0 = src[:start].count("\n") + 1
    lines = src[start:end].rstrip().split("\n")
    assert lines[-1] == "}"
    labels, out = ["start"], []

    def code_before(i):
        """The phase heading (a '// N.' comment) and the last statement
        before line i."""
        code = next((ln.strip() for ln in reversed(lines[:i])
                     if ln.strip() not in ("", "{", "}") and not ln.strip().startswith("//")), "")
        phase = next((ln.strip()[3:] for ln in reversed(lines[:i])
                      if re.match(r"\s*// \d+'?\.", ln)), "")
        return f"[{phase[:32]}] {code[:48]}"

    for i, line in enumerate(lines[:-1]):
        if line.strip() == "return;" and "layer_norm" in " ".join(lines[i - 2:i]):
            out.append(f"    STAMP({len(labels)})")
            labels.append(f"line {line0 + i}: {code_before(i)} (K=1 end)")
        out.append(line)
        if "bar_consumers(kConsThreads);" in line:
            out.append(f"  STAMP({len(labels)})")
            labels.append(f"line {line0 + i}: {code_before(i)}")
    out.append(f"  STAMP({len(labels)})")
    labels.append("end: layer_norm (K>1)")
    out.append("}")
    assert len(labels) <= MAX_STAMPS
    stamp = (f"  long long* stamps = (blockIdx.x < {MAX_CTAS} && tid == 0) ? "
             f"g_stamps + blockIdx.x * {MAX_STAMPS} : nullptr;\n"
             "#define STAMP(i) if (stamps) stamps[i] = clock64();\n  STAMP(0)\n")
    return src[:start] + stamp + "\n".join(out) + "\n" + src[end:], labels


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bf16", action="store_true", help="the bf16 instantiation")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_fused_agg: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from nerfloc_tpu_torch.ops import fused_agg as fa
    from nerfloc_tpu_torch.ops import native
    card = cs.card_line()
    src, labels = stamped_source()
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        cu, so = os.path.join(tmp, "stamped.cu"), os.path.join(tmp, "libstamped.so")
        open(cu, "w").write(src)
        proc = subprocess.run([native.find_nvcc(), *native.NVCC_FLAGS, "-o", so, cu],
                              capture_output=True, text=True)
        if proc.returncode:
            print(proc.stderr, file=sys.stderr)
            return 1
        lib = ctypes.CDLL(so)
    fn = lib.fused_agg_forward
    fn.argtypes = fa.KERNEL_ARGTYPES
    fn.restype = ctypes.c_int
    fa._kernel_fn = lambda: fn
    dev = torch.device("cuda")
    results = []
    print(f"profile_fused_agg on {card}; cycles per CTA, median over the first "
          f"{MAX_CTAS} CTAs")
    for N, K in ((1024, 8), (1024, 1), (cs.RENDER_N, cs.RENDER_K)):
        x = cs.agg_inputs(N, K, 195, 128, seed=K, dev=dev)
        if args.bf16:
            x = cs.agg_inputs_bf16(x)
        for rows in [r for r in fa.TILE_ROWS if r >= K]:
            stamps = np.zeros(MAX_CTAS * MAX_STAMPS, np.int64)
            lib.fused_agg_stamps(stamps.ctypes.data, 1)
            with torch.no_grad():
                fa.launch(**x, rows=rows)
            torch.cuda.synchronize()
            lib.fused_agg_stamps(stamps.ctypes.data, 0)
            grid = min(MAX_CTAS, -(-N // (rows // K)))
            st = stamps.reshape(MAX_CTAS, MAX_STAMPS)[:grid]
            cols = [c for c in range(len(labels)) if (st[:, c] != 0).all()]
            delta = np.median(np.diff(st[:, cols], axis=1), axis=0)
            total = float(np.median(st[:, cols[-1]] - st[:, cols[0]]))
            phases = {labels[c]: float(d) for c, d in zip(cols[1:], delta)}
            results.append({"N": N, "K": K, "rows": rows, "bf16": args.bf16,
                            "total_cycles": total,
                            "phases": phases, "card": card})
            print(f"\nN={N} K={K} rows={rows}: {total:.0f} cycles")
            for name, d in phases.items():
                print(f"  {d:9.0f}  {100 * d / total:5.1f} %  {name}")
        del x
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
