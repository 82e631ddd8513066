#!/usr/bin/env python3
"""Where the fused-aggregation kernel spends its cycles, phase by phase.

    python3 tools/profile_fused_agg.py [--bf16] [--ksteps] [--out FILE.json]

Builds a copy of nerfloc_tpu_torch/csrc/fused_agg.cu in which thread 0 of
every CTA records clock64() after each of its barriers (the consumer
barrier of fused_agg_kernel, the first warpgroup's barrier of
fused_agg_wide, the CTA and cluster barriers of fused_agg_cluster, which
runs the bf16 16-row tiles; the shipped kernel carries no
instrumentation), launches it
at the query shapes (N=1024 with K=8 and K=1) and at the render shape
(N=262144, K=8) for each tile size, and prints the median cycles of each
phase over the first 512 CTAs, labelled with the source line the barrier
closes. --bf16 profiles the bf16 instantiation (mv_agg and nb_feat
in bf16). Needs one CUDA card and nvcc; prints the card's name and power
limit and ptxas's report (registers, spills, wgmma serialization).

--ksteps (with --bf16) splits the cycles of the wide tiles' wgmma products
(`gemm_wide`) at the train (N=65536), refinement (N=32768) and render
(N=262144) shapes, K=8, at the default tile, per ring stage of two k-steps: the full-barrier
wait, the wgmma issue, the stage-end wait_group, the slot releases, and
fc0's block ends (their wait and rounding); thread 0's cycles in each
product's gemm and in its epilogue; and the weight bytes each CTA streams
over its time (the L2 rate the ring achieves).
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
# kernel: (first line of its stamped body, the text after it, its barrier)
KERNELS = {
    "tile": ("  const int n0 = blockIdx.x * T;", "\n// ---- wide bf16 tiles",
             ("bar_consumers(kConsThreads);",)),
    "wide": ("  const int twg = a.T / NWG;", "\n// ---- bf16 cluster tiles", ("bar_wg(wg);",)),
    "cluster": ("  const int t_valid = max(0, min(T, a.N - n0));   // CTAs past N only hold weights",
                "\n// the k-steps of the products a launch runs", ("__syncthreads();", "cluster_sync();")),
}
KSTEP_NAMES = ("ring full wait", "wgmma issue", "stage-end wait_group", "slot release",
               "fc0 block end: wait_group 0 + rounding")


def _replace_once(body: str, anchor: str, new: str) -> str:
    assert body.count(anchor) == 1, anchor
    return body.replace(anchor, new)


def kstep_patch(src: str) -> str:
    """Accumulate, in thread 0 of the first MAX_CTAS CTAs, the cycles of the
    wide tiles' wgmma products in KSTEP_NAMES (slot 7 counts the stages)
    into g_ksteps, fc0 in slots 0-7 of a CTA and the [128, 128] products in
    slots 8-15, and each product's gemm and epilogue cycles into g_spans."""
    acq = "    const unsigned char* ws = reinterpret_cast<const unsigned char*>(ring.acquire());\n"
    start = src.index("__device__ __forceinline__ void gemm_wide(")
    end = src.index("// Y (CoreTile) = act(")
    body = src[start:end]
    body = _replace_once(body, acq, "    ks_t = clock();\n" + acq + "    KS_ADD(0)\n")
    body = _replace_once(body, "        if ((x.fold >> ks) & 1u) {\n",
                         "        if ((x.fold >> ks) & 1u) {\n          KS_ADD(1)\n")
    body = _replace_once(body, "          fold_wide(d, tot, (1u << ks) == first_end);\n",
                         "          fold_wide(d, tot, (1u << ks) == first_end);\n"
                         "          KS_ADD(4)\n")
    body = _replace_once(body, "    wgmma_commit();\n    if (pend) {\n      wgmma_wait<1>();\n"
                         "      ring.release(lane);\n    }\n",
                         "    KS_ADD(1) KS_COUNT\n    wgmma_commit();\n    if (pend) {\n"
                         "      wgmma_wait<1>();\n      KS_ADD(2)\n      ring.release(lane);\n"
                         "      KS_ADD(3)\n    }\n")
    # the cycles accumulate in registers (32-bit clock) and reach device
    # memory once a product, outside the measured spans
    body = body.replace("{\n", "{\n  unsigned ks_acc[8] = {0, 0, 0, 0, 0, 0, 0, 0}, ks_t = 0;\n", 1)
    head, _, _ = body.rstrip().rpartition("\n}")
    body = head + "\n  KS_FLUSH\n}\n\n"
    macros = (f"__device__ long long g_ksteps[{MAX_CTAS * 16}];\n"
              f"#define KS_ON (blockIdx.x < {MAX_CTAS} && threadIdx.x == 0)\n"
              "#define KS_ADD(i) { const unsigned n_ = clock(); ks_acc[i] += n_ - ks_t; ks_t = n_; }\n"
              "#define KS_COUNT ks_acc[7] += 1;\n"
              "#define KS_FLUSH if (KS_ON) { for (int i_ = 0; i_ < 8; ++i_) "
              "g_ksteps[blockIdx.x * 16 + (kTwo ? 0 : 8) + i_] += ks_acc[i_]; }\n")
    src = src[:start] + body + src[end:]
    # thread 0's cycles in each product's gemm and in its epilogue (fc0 in
    # slots 0-1, the [128, 128] products in 2-3)
    src = _replace_once(
        src, "  gemm_wide<kTwo>(d, x, nks, ring, ww, lane);\n  if (in_place) bar_wg(wg);\n"
             "  store_wide(d, Y, bias, nb, act, ww, lane);\n",
        "  const unsigned pw0 = clock();\n  gemm_wide<kTwo>(d, x, nks, ring, ww, lane);\n"
        "  const unsigned pw1 = clock();\n  if (in_place) bar_wg(wg);\n"
        "  store_wide(d, Y, bias, nb, act, ww, lane);\n  const unsigned pw2 = clock();\n"
        "  if (KS_ON) {\n    g_spans[blockIdx.x * 4 + (kTwo ? 0 : 2)] += pw1 - pw0;\n"
        "    g_spans[blockIdx.x * 4 + (kTwo ? 1 : 3)] += pw2 - pw1;\n  }\n")
    macros += f"__device__ long long g_spans[{MAX_CTAS * 4}];\n"
    src = src.replace("namespace {\n", macros + "\nnamespace {\n", 1)
    return src.replace('}  // extern "C"', '''int fused_agg_ksteps(long long* host, int clear) {
  if (clear) {
    void* p = nullptr;
    cudaGetSymbolAddress(&p, g_ksteps);
    return (int)cudaMemset(p, 0, sizeof(g_ksteps));
  }
  return (int)cudaMemcpyFromSymbol(host, g_ksteps, sizeof(g_ksteps));
}
int fused_agg_spans(long long* host, int clear) {
  if (clear) {
    void* p = nullptr;
    cudaGetSymbolAddress(&p, g_spans);
    return (int)cudaMemset(p, 0, sizeof(g_spans));
  }
  return (int)cudaMemcpyFromSymbol(host, g_spans, sizeof(g_spans));
}
}  // extern "C"''')


def sm_clock_mhz() -> float:
    """The card's maximum SM clock (MHz), from nvidia-smi."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    try:
        return float(out.stdout.split()[0])
    except (IndexError, ValueError):
        return float("nan")


def _stamp_body(lines: list[str], line0: int, barriers) -> tuple[list[str], list[str]]:
    """A stamp after every barrier line, before the K=1 return and at the
    end of one kernel's body (lines, ending with its closing brace)."""
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
        if any(b in line and "void " not in line for b in barriers):
            out.append(f"  STAMP({len(labels)})")
            labels.append(f"line {line0 + i}: {code_before(i)}")
    out.append(f"  STAMP({len(labels)})")
    labels.append("end: layer_norm (K>1)")
    out.append("}")
    assert len(labels) <= MAX_STAMPS
    return out, labels


def stamped_source() -> tuple[str, dict]:
    """The kernel source with a clock64 stamp after every barrier of each
    kernel (KERNELS, those the source has), before the K=1 return and at
    the end, and per kernel a label for each stamp (the source line and
    the code it closes)."""
    src = open(SRC).read()
    labels = {}
    for name, (first, after, barriers) in KERNELS.items():
        if first not in src:
            continue
        start = src.index(first)
        end = src.index(after, start) if after in src[start:] else src.index("\nstruct Plan")
        line0 = src[:start].count("\n") + 1
        lines = src[start:end].rstrip().split("\n")
        assert lines[-1] == "}"
        out, labels[name] = _stamp_body(lines, line0, barriers)
        src = src[:start] + "  STAMP(0)\n" + "\n".join(out) + "\n" + src[end:]
    src = src.replace("namespace {\n",
                      f"__device__ long long g_stamps[{MAX_CTAS * MAX_STAMPS}];\n"
                      f"#define STAMP(i) if (blockIdx.x < {MAX_CTAS} && threadIdx.x == 0) "
                      f"g_stamps[blockIdx.x * {MAX_STAMPS} + (i)] = clock64();\n\n"
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
    return src, labels


def kernel_of(fa, rows: int, bf16: bool) -> str:
    if bf16 and fa.tile_cluster(rows, bf16):
        return "cluster"
    return "wide" if bf16 and rows >= fa.WGMMA_ROWS else "tile"


def run_stamped(lib, fa, x, rows: int, N: int, K: int, labels: list[str]):
    """One launch; (median CTA cycles, {phase label: median cycles})."""
    import torch
    stamps = np.zeros(MAX_CTAS * MAX_STAMPS, np.int64)
    lib.fused_agg_stamps(stamps.ctypes.data, 1)
    with torch.no_grad():
        fa.launch(**x, rows=rows)
    torch.cuda.synchronize()
    lib.fused_agg_stamps(stamps.ctypes.data, 0)
    bf16 = x["mv_agg"].dtype == torch.bfloat16
    grid = min(MAX_CTAS, -(-N // fa.tile_samples(rows, K, bf16)))
    st = stamps.reshape(MAX_CTAS, MAX_STAMPS)[:grid]
    cols = [c for c in range(len(labels)) if (st[:, c] != 0).all()]
    delta = np.median(np.diff(st[:, cols], axis=1), axis=0)
    total = float(np.median(st[:, cols[-1]] - st[:, cols[0]]))
    return total, {labels[c]: float(d) for c, d in zip(cols[1:], delta)}


def ksteps(lib, fa, cs, dev, card, labels: dict) -> list:
    """The wgmma products' split and the ring's L2 rate at the three
    K=8 shapes of the train step, the refinement and the render."""
    import torch
    mhz = sm_clock_mhz()
    unit = "stage"
    out = []
    for tag, N in (("train", 65536), ("refine", 32768), ("render", cs.RENDER_N)):
        K = 8
        x = cs.agg_inputs_bf16(cs.agg_inputs(N, K, 195, 128, seed=K, dev=dev))
        rows = fa.tile_plan(N, K, fa._sm_count(dev), bf16=True)[0]
        ks = np.zeros(MAX_CTAS * 16, np.int64)
        spans = np.zeros(MAX_CTAS * 4, np.int64)
        lib.fused_agg_ksteps(ks.ctypes.data, 1)
        lib.fused_agg_spans(spans.ctypes.data, 1)
        cta, phases = run_stamped(lib, fa, x, rows, N, K, labels["wide"])
        lib.fused_agg_ksteps(ks.ctypes.data, 0)
        lib.fused_agg_spans(spans.ctypes.data, 0)
        T = fa.tile_samples(rows, K, True)
        ks = ks.reshape(MAX_CTAS, 2, 8)[:min(MAX_CTAS, -(-N // T))]
        both = ks.sum(axis=1)
        n_ks = both[:, 7]
        split = {name: float(np.median(both[:, i] / n_ks)) for i, name in enumerate(KSTEP_NAMES)}
        per = float(np.median(both[:, :5].sum(axis=1) / n_ks))
        parts = {}
        for part, sub in (("fc0", ks[:, 0]), ("square products", ks[:, 1])):
            parts[part] = {"count": float(np.median(sub[:, 7])),
                           "cycles": float(np.median(sub[:, :5].sum(axis=1))),
                           "split": {name: float(np.median(sub[:, i]))
                                     for i, name in enumerate(KSTEP_NAMES)}}
        _, fin_p = fa.ring_widths(195, 10, 27, 16)
        stream = (fin_p * 128 + 6 * 128 * 128) * 2      # the ring's weight stream per CTA
        rate = stream / cta                              # bytes per cycle per CTA
        grid = min(MAX_CTAS, -(-N // T))
        sp = np.median(spans.reshape(MAX_CTAS, 4)[:grid], axis=0)
        res = {"shape": tag, "N": N, "K": K, "rows": rows, "unit": unit,
               "product_spans": {"fc0 gemm": float(sp[0]), "fc0 epilogue": float(sp[1]),
                                 "[128, 128] gemms": float(sp[2]),
                                 "[128, 128] epilogues": float(sp[3])},
               f"{unit}_cycles": per, f"{unit}_split": split,
               f"{unit}s_per_cta": float(np.median(n_ks)), "cta_cycles": cta, "parts": parts,
               "phases": phases, "weight_bytes_per_cta": stream,
               "l2_bytes_per_cycle_per_cta": rate, "max_sm_clock_mhz": mhz,
               "l2_gb_per_s_per_cta": rate * mhz * 1e6 / 1e9, "card": card}
        out.append(res)
        print(f"\n{tag} N={N} K={K} rows={rows}: {res[f'{unit}s_per_cta']:.0f} wgmma {unit}s "
              f"(thread 0's warpgroup), {per:.0f} cycles each (median over the first "
              f"{MAX_CTAS} CTAs)")
        for name, c in split.items():
            print(f"  {c:8.0f}  {100 * c / per:5.1f} %  {name}")
        for part, v in parts.items():
            print(f"  {part}: {v['count']:.0f} {unit}s, {v['cycles']:.0f} cycles in all: " +
                  ", ".join(f"{name} {c:.0f}" for name, c in v["split"].items()))
        print("  thread 0's cycles in the products' gemms and epilogues (store_wide): " +
              ", ".join(f"{k} {v:.0f}" for k, v in res["product_spans"].items()))
        print(f"  CTA {cta:.0f} cycles; weight stream {stream} B a CTA: {rate:.2f} B/cycle "
              f"a CTA, {res['l2_gb_per_s_per_cta']:.1f} GB/s a CTA at {mhz:.0f} MHz; {card}")
        for name, d in phases.items():
            print(f"  {d:9.0f}  {100 * d / cta:5.1f} %  {name}")
        del x
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bf16", action="store_true", help="the bf16 instantiation")
    ap.add_argument("--ksteps", action="store_true",
                    help="split the bf16 wgmma products' cycles (with --bf16)")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if args.ksteps and not args.bf16:
        ap.error("--ksteps profiles the bf16 instantiation: add --bf16")
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
    if args.ksteps:
        src = kstep_patch(src)
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        cu, so = os.path.join(tmp, "stamped.cu"), os.path.join(tmp, "libstamped.so")
        open(cu, "w").write(src)
        proc = subprocess.run([native.find_nvcc(), *native.NVCC_FLAGS, "-o", so, cu],
                              capture_output=True, text=True)
        if proc.returncode:
            print(proc.stderr, file=sys.stderr)
            return 1
        lib = ctypes.CDLL(so)
    for line in proc.stderr.splitlines():
        if "registers" in line or "spill" in line or "Potential" in line:
            print(f"build report: {line.strip()}")
    fn_ = lib.fused_agg_forward
    fn_.argtypes = fa.KERNEL_ARGTYPES
    fn_.restype = ctypes.c_int
    fa._kernel_fn = lambda: fn_
    dev = torch.device("cuda")
    results = []
    print(f"profile_fused_agg on {card}; cycles per CTA, median over the first "
          f"{MAX_CTAS} CTAs")
    if args.ksteps:
        results = ksteps(lib, fa, cs, dev, card, labels)
    for N, K in () if args.ksteps else ((1024, 8), (1024, 1), (cs.RENDER_N, cs.RENDER_K)):
        x = cs.agg_inputs(N, K, 195, 128, seed=K, dev=dev)
        if args.bf16:
            x = cs.agg_inputs_bf16(x)
        for rows in fa.tile_options(K, args.bf16):
            total, phases = run_stamped(lib, fa, x, rows, N, K,
                                        labels[kernel_of(fa, rows, args.bf16)])
            results.append({"N": N, "K": K, "rows": rows, "bf16": args.bf16,
                            "total_cycles": total, "phases": phases, "card": card})
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
