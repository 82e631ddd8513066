// Fused neighbour aggregation for ConditionalNeRF.query, forward pass.
//
// Replaces the Pallas TPU kernel nerfloc_tpu/ops/fused_agg.py:_kernel
// (entered through fused_neighbor_agg / _fused_fwd_impl). Per sample with K
// neighbours it computes, without writing any intermediate to device memory:
//   off   = (xyz - nb_xyz) / scale                          [K, 3]
//   emb   = [off | sin(off * f_j) | cos(off * f_j)]          (f32 phases)
//   rdiff = [normalize(dir - nb_dir) | dot(dir, nb_dir)]     [K, 4]
//   rdfc  = leaky(leaky(rdiff @ rd_w1 + rd_b1) @ rd_w2 + rd_b2)
//   pf    = base_mlp([nb_feat | emb | rdfc])                 3 layers, leaky
//   q = mv @ wq / sqrt(32); k = pf @ wk; v = pf @ wv         4 heads of 32
//   o = softmax_K(q . k) v;  y = o @ wfc + mv;  out = LayerNorm(y) (eps 1e-6)
// With K = 1 the softmax weight is exactly 1, so o = v and the q and k
// products are skipped.
//
// What bounds it on an H100. Per neighbour row the seven matrix products
// cost ~205 kFLOP against ~0.8 kB of input, so at every shape it is bound
// by operations: by the tensor cores' TF32 rate (which 3xTF32 must spend
// three times), at the query shapes (N=1024, K=8 and K=1) as at the render
// shape (N=262144, K=8, 2.1M rows). Measured (tools/profile_fused_agg.py),
// the products take about two thirds of a CTA's cycles and the CUDA-core
// phases (prologue, attention, LayerNorm) the rest; each k-step's MMAs are
// waited for before the next is issued, so neither reaches its unit's
// peak. The weight stream (~0.55 MB from L2 per CTA) never makes a
// consumer wait.
//
// Design:
// - Products on the tensor cores at f32 accuracy with the 3xTF32 split
//   (big = rna(x), small = rna(x - big); accumulate a_s*b_b + a_b*b_s +
//   a_b*b_b in f32, small terms first): wgmma m64n128k8 with A from
//   registers for 64-row tiles (the render shape), mma.sync m16n8k8 for
//   16/32-row tiles (the query shapes) and the 16-row q and o products.
// - Weights reach shared memory through a ring of 8 KB stages filled by
//   one producer warp with cp.async.bulk and mbarriers (full/empty pairs).
//   The weight stream is the same for every CTA, so the producer runs
//   ahead across layer boundaries and during the prologue. The wrapper
//   packs the weights once per call into the ring's order: for mma.sync
//   in B-fragment order (each lane reads its 8 values of a k-step with two
//   conflict-free 16-byte loads), for wgmma as each k-step's big and small
//   halves in its core-matrix layout (twice the bytes: kept off the query
//   tiles, whose CTAs each stream all weights for only 16-32 rows).
// - Four consumer warps share a tile of 16*MT rows; warp w owns output
//   columns [32w, 32w+32) of every 128-wide product. A tile's
//   activations stay in shared memory; outputs are staged in registers
//   until every warp has read the layer's input, so the x_in region then
//   holds the [rows, 128] tiles A and B. Their row stride (132) and the
//   embedding's are 4 mod 8 floats, so A-fragment loads are free of bank
//   conflicts (the features' odd stride F costs 2-way conflicts in fc0's
//   first k-steps only).
// - Tile rows are 16, 32 or 64 (MT in {1,2,4}), picked by the wrapper
//   from N and K; two CTAs fit on an SM, so one CTA's CUDA-core phases
//   overlap the other's products. (128-row CTAs of two consumer groups,
//   with half the weight traffic per row, were slower at every shape
//   measured.)
// - The embedding phases and sin/cos (accurate sincosf, no fast-math:
//   phases reach 2^9 * |off|), the ray-diff MLP, the K-way softmax (max
//   subtracted), the residual and the LayerNorm stay f32 on the CUDA cores.
// - A tile's neighbour features are one contiguous block in device memory:
//   one cp.async.bulk copies it (rows kept at stride F) while the CUDA
//   cores compute the row geometry and embedding into a second region;
//   fc0 reads its first ceil(F/8) k-steps from the one, the rest from the
//   other.
//
// The bf16 instantiation is the Pallas kernel at dt=bfloat16, which rounds
// to bf16 at every matrix product, bias add, activation and softmax
// weight, and keeps the offsets, phases, softmax sums and LayerNorm in
// f32. It runs in two kernels of its own: fused_agg_wide (tiles of 64 and
// 128 rows) and fused_agg_cluster (16- and 32-row tiles: launches too
// small to fill the card with wide tiles, the query's K = 1 launch among
// them).
// - nb_feat and mv_agg arrive in bf16 and the tile's activations stay
//   bf16 in shared memory (half the device and shared-memory bytes of a
//   row); the weights are rounded to bf16 to nearest even, as astype: by
//   the wrapper into 8 KB ring stages of two k-steps of 16 (wide tiles), or
//   by the cluster tiles' own threads from the f32 parameters.
// - Every product is one bf16 MMA accumulated in f32 (where 3xTF32 spends
//   three): wgmma m64n128k16 for the wide tiles (the ring then holds each
//   k-step's [16, 128] tile in the f32 wgmma layout's core matrices, 8
//   n-rows of 16 bytes, two k-halves 2 KB apart), mma.sync m16n8k16 for
//   the cluster tiles.
// - The CUDA-core phases round where the Pallas kernel does: products to
//   bf16, then the bias added in bf16, leaky ReLU as max(x, bf16(0.01) x)
//   in bf16, the ray-diff MLP from bf16 inputs and weights with f32 sums,
//   q scaled by bf16(1/sqrt(32)), each q.k product rounded before the f32
//   per-head sum, each softmax weight exp(s - max) and 1/sum rounded
//   before they meet v, the attention output rounded; o + mv and the
//   LayerNorm in f32 (XLA computes the Pallas kernel's bf16 sum, cast to
//   f32 at once, in f32). The offsets keep an f32 copy for the phases.
// - fc0 mirrors the Pallas kernel's five block products [feat | off | sin
//   | cos | rdfc]: each block starts on a whole k-step of 16 (zero columns
//   and weight rows between), its product is rounded to bf16 and added to
//   the running bf16 sum, as the plain version (ops/fused_agg.py:
//   kernel_agg) does. At the main width (F=195, 10 bands) this costs no
//   k-step (20 either way). One product rounded once instead was measured
//   0.65x as far from the plain version as bf16 is from f32 (RMS, N=1024,
//   K=8); with the blocks only the f32 sum order differs.
//
// bf16 tiles of 64 and 128 rows (the train, refinement and render shapes,
// N = 32768-262144, K = 8) run fused_agg_wide, written for this
// card. What bounds it: ~221 kFLOP of products per row is ~54 tensor-core
// cycles of an SM, against ~1.3 kB of weights a row at 64 rows a stage and
// some ~20 CUDA-core operations a row for each of the 128 values of each
// product's epilogue, plus the embedding (sin/cos of 30 phases) and the
// ray-diff MLP. The 64-row design before it waited for each k-step's MMA
// (measured ~650 cycles a k-step for ~64 of tensor work) and ran one 64-row
// chain per CTA; its CUDA-core phases left the tensor cores idle. Here:
// - CTAs of NWG = rows / 64 consumer warpgroups and no producer warp. Each
//   warpgroup owns 64 rows (whole samples: 64 / K of them) and runs the
//   chain with its own named barrier; the warpgroups meet only at the
//   weight ring, whose every 8 KB stage all of them read. Two CTAs of 128
//   rows an SM keep the tensor cores busy while a warpgroup builds its
//   inputs, waits or rounds, and each stage serves 128 rows (half the
//   64-row design's L2 stream per row). Each warp releases a slot with an
//   arrival on its empty mbarrier; the arrival that completes the phase
//   refills the slot, stage nst further on, after an acquire fence.
// - Measured on the card and dropped: 256-row tiles of four warpgroups
//   (one CTA an SM; slower than two 128-row CTAs at every shape), a
//   persistent grid (CTAs walking tiles, the next tile's features
//   bulk-copied during the products: one 128-row CTA an SM, ~1.3x slower)
//   and builder warpgroups that build the next tile's inputs while their
//   consumers run the products (~1.1x slower: they halve the consumers an
//   SM). The grid already overlaps one CTA's prologue with the other's
//   products, and each of these gives up that second CTA.
// - The warpgroup and warp indices are read through __shfl_sync, so the
//   compiler sees them warp-uniform: wgmma behind a branch it must take
//   for divergent is serialized (ptxas C7520).
// - Activations live in CoreTile layout (8 x 8 core matrices, K-major), so
//   every product reads A from shared memory through a descriptor, as it
//   reads B: a stage's two k-steps are issued back to back, committed once
//   and waited for (wait_group 1) only when the next stage is in flight;
//   fc0 waits in full only at its five block ends, whose bf16 rounding the
//   Pallas kernel fixes. The epilogues write CoreTile, fenced for the async
//   proxy. Register-sourced A for the features (odd row stride) measured
//   ~3x the cycles a stage of the descriptor form, so the prologue moves
//   each pass of feature rows (bulk-copied into the embedding's region,
//   free until then) into a CoreTile.
// - The epilogues and fc0's block sums round two columns at a time in
//   bf16x2: rounding the f32 sum of two bf16 values to bf16 is the
//   correctly rounded bf16 sum, so the results equal the f32 add and
//   rounding of the plain version bit for bit.
// - The attention runs a warp a sample, lane (key, head), reading 16-byte
//   chunks of K and V rows without bank conflicts; the prologue spreads
//   the ray-diff MLP over two threads a row and interleaves rows for ILP.
// - 128 rows take 110,976 B of shared memory (two CTAs an SM, 3 ring
//   stages); 64 rows three an SM. The timings per tile and shape are in
//   PERF.md.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kHd = 128;             // attention width (4 heads x 32); W pads to it
constexpr int kCons = 4;             // consumer warps (the producer warp is the fifth)
constexpr int kConsThreads = kCons * 32;
constexpr int kHeads = 4;
constexpr int kDk = 32;
constexpr int kLdh = kHd + 4;        // row stride of [rows, 128] tiles (4 mod 8)
constexpr int kKStep = 8;            // MMA depth
// A ring stage holds two k-steps of f32 weights in the mma.sync fragment
// order, or (64-row tiles) one k-step's big and small TF32 tiles in the
// core-matrix layout wgmma reads: 8 KB either way.
constexpr int kStageK = 2;           // k-steps per stage, mma.sync layout
constexpr int kTile = kKStep * kHd;  // floats of one k-step's [8, 128] tile
constexpr int kStageFloats = kStageK * kTile;                   // 2048 floats
constexpr uint32_t kStageBytes = kStageFloats * sizeof(float);  // 8 KB
// wgmma B descriptor strides of the core-matrix layout (no swizzle): core
// matrices are 8 n-rows x 4 k (128 B); k-halves 2 KB apart, n-groups 128 B.
constexpr uint32_t kLbo = 16 * 128;
constexpr uint32_t kSbo = 128;
constexpr int kMaxStages = 8;
constexpr int kMaxRd = 32;           // ray-diff MLP widths (RD1, RD2) held in registers
constexpr int kSmemMax = 232448;     // bytes of shared memory a CTA may use
constexpr int kSmemHalf = 115712;    // ... with two CTAs on an SM (1 KB reserved each)
constexpr float kLeak = 0.01f;
constexpr float kLnEps = 1e-6f;
constexpr long long kSpinLimit = 1LL << 34;  // ~10 s of cycles: a stuck wait traps

using bf16 = __nv_bfloat16;
// bf16 instantiation: [rows, 128] tiles at a row stride of 136 (68 words,
// 4 mod 8: conflict-free A fragments); MMA depth 16; one k-step's [16, 128]
// weight tile is 4 KB, two to a ring stage.
constexpr int kLdhB = kHd + 8;
constexpr int kKStepB = 16;
constexpr int kTileBytesB = kKStepB * kHd * 2;
constexpr float kLeakB = 0.010009765625f;    // bf16(0.01), as the Pallas kernel multiplies

// per element type: MMA depth, row stride of [rows, 128] tiles, and the
// padding of the embedding's row stride (4 mod 8 words either way)
template <typename E>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int kDep = kKStep, kLd = kLdh, kLdePad = 4;
};
template <>
struct Elem<bf16> {
  static constexpr int kDep = kKStepB, kLd = kLdhB, kLdePad = 8;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename E>
__device__ __forceinline__ E from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }
// x rounded to E (round to nearest even), as f32
template <typename E>
__device__ __forceinline__ float rnd(float x) { return to_f(from_f<E>(x)); }
__device__ __forceinline__ float leaky_b(float x) { return fmaxf(x, rnd<bf16>(x * kLeakB)); }

// Products in the order the ring streams them (and the packed buffer holds
// them): fc0 [8 ks0p, 128], then six [128, 128].
enum { kFc0, kFc1, kFc2, kWv, kWk, kWq, kWfc, kProducts };

struct Args {
  const float* xyz;      // [N, 3]
  const float* dir;      // [N, dir_stride], first 3 used
  const void* mv;        // [N, W] of E
  const float* nb_xyz;   // [N, K, 3]
  const float* nb_dir;   // [N, K, 4]
  const void* nb_feat;   // [N, K, F] of E
  const float* scale;    // [1]
  const float* freqs;    // [NF]
  const float* rd_w1; const float* rd_b1;  // [4, RD1], [RD1]
  const float* rd_w2; const float* rd_b2;  // [RD1, RD2], [RD2]
  const void* wpack;                       // packed products of E (ops/fused_agg.py)
  const float* b0; const float* b1; const float* b2;  // [W]
  const float* ln_s; const float* ln_b;    // [W]
  float* out;                              // [N, W]
  int N, K, F, W, NF, RD1, RD2, T, dir_stride;
  int ks_f, ks_e, ks0p, lde, feat_elems, region, q_rows, nst, rdw_floats, off_floats;
  float q_scale;
  int cl_ks;                         // cluster tiles: the k-steps of the products a launch runs
  const float* wmat[kProducts];      // ... and the products' f32 weights ([in, out], fc0's rows permuted)
};

__device__ __forceinline__ float leaky(float x) { return fmaxf(x, kLeak * x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// consumer-only barrier (the producer warp never joins it)
__device__ __forceinline__ void bar_consumers(int nthreads) {
  asm volatile("bar.sync 1, %0;" ::"r"(nthreads) : "memory");
}

// ---- mbarrier ring --------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > kSpinLimit) __trap();  // a phase error faults, never hangs
  }
}

// mbar_arrive, true for the arrival that completes the phase (the state
// before it, which arrive returns, has one arrival pending)
__device__ __forceinline__ bool mbar_arrive_last(uint64_t* bar) {
  uint32_t pending;
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.shared::cta.b64 st, [%1];\n"
      "mbarrier.pending_count.b64 %0, st;\n}"
      : "=r"(pending)
      : "r"(smem_u32(bar))
      : "memory");
  return pending == 1;
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// Consumer side of the ring: stage `it` of the stream sits in slot
// it % nst and completes phase (it / nst) & 1 of its full barrier.
struct Ring {
  float* buf;
  uint64_t* full;
  uint64_t* empty;
  int nst;
  int slot;
  uint32_t phase;

  __device__ __forceinline__ const float* acquire() {
    mbar_wait(full + slot, phase);
    return buf + slot * kStageFloats;
  }
  __device__ __forceinline__ void release(int lane) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + slot);
    if (++slot == nst) {
      slot = 0;
      phase ^= 1u;
    }
  }
};

// ---- 3xTF32 tensor-core products --------------------------------------------

// cvt.rna.tf32.f32 (nearest, ties away from zero) as two integer ops on
// the bit pattern: the same result for every finite x, in fewer issue
// slots than the cvt instruction takes on an H100.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A operand of a product: k-steps [0, nks1) from x1 (row stride ld1,
// columns >= kv1 read as 0), the rest from x2 (stride ld2); nks_c k-steps
// are computed, the ring may hold more (zero padding).
template <typename E>
struct Operand {
  const E* x1;
  int ld1, kv1, nks1;
  const E* x2;
  int ld2, nks_c;
  int blk_end[3];   // bf16 fc0: k-steps ending the off, sin and cos blocks
};

template <typename E>
__device__ __forceinline__ Operand<E> tile_operand(const E* x, int ld) {
  return Operand<E>{x, ld, 1 << 30, 1 << 30, nullptr, 0, kHd / Elem<E>::kDep, {0, 0, 0}};
}

// acc[mt][j] = X[16 mt .. +16, :] @ Wkn[:, 32 wn + 8 j .. +8] for
// mt < mt_n (all MT when kFull, with no branch), with nks k-steps of
// weights streamed through the ring (a multiple of kStageK), with
// mma.sync. kTwo: the operand has two regions. kPre: the ring holds the
// pre-split core-matrix layout of 64-row tiles. Every consumer warp calls
// it for every product, also with mt_n = 0, so that each stage is released
// by all of them.
template <int MT, bool kFull, bool kTwo, bool kPre>
__device__ __forceinline__ void gemm(float (&acc)[MT][4][4], const Operand<float>& x, int mt_n,
                                     int nks, Ring& ring, int wn, int lane) {
  constexpr int kSteps = kPre ? 1 : kStageK;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
  for (int s = 0; s < nks; s += kSteps) {
    const float* ws = ring.acquire();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const int ks = s + kk;
      if (kTwo && ks >= x.nks_c) continue;
      uint32_t bb[8], bs[8];
      if constexpr (kPre) {
        // b0 of n-tile jj: core matrix (k-half 0, n-group jj), row g, col t;
        // lanes read 32 consecutive floats
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int jj = 4 * wn + j;
          bb[2 * j] = __float_as_uint(ws[jj * 32 + lane]);
          bb[2 * j + 1] = __float_as_uint(ws[(16 + jj) * 32 + lane]);
          bs[2 * j] = __float_as_uint(ws[kTile + jj * 32 + lane]);
          bs[2 * j + 1] = __float_as_uint(ws[kTile + (16 + jj) * 32 + lane]);
        }
      } else {
        // n-tiles j = 0, 1 of this warp, then j = 2, 3: 16 bytes a lane,
        // consecutive lanes on consecutive addresses (no bank conflicts)
        const float4* bp = reinterpret_cast<const float4*>(ws + kk * kTile + wn * 256) + lane;
        const float4 p0 = bp[0];
        const float4 p1 = bp[32];
        const float bv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) split_tf32(bv[i], bb[i], bs[i]);
      }
      const bool first = !kTwo || ks < x.nks1;
      const float* base = first ? x.x1 + ks * kKStep : x.x2 + (ks - x.nks1) * kKStep;
      const int ld = first ? x.ld1 : x.ld2;
      const int kv = kTwo && first ? x.kv1 - ks * kKStep : kKStep;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (kFull || mt < mt_n) {
          const float* xr = base + (16 * mt + g) * ld + t;
          const float av[4] = {t < kv ? xr[0] : 0.f, t < kv ? xr[8 * ld] : 0.f,
                               t + 4 < kv ? xr[4] : 0.f, t + 4 < kv ? xr[8 * ld + 4] : 0.f};
          uint32_t ab[4], as[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) split_tf32(av[i], ab[i], as[i]);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_tf32(acc[mt][j], as, bb[2 * j], bb[2 * j + 1]);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_tf32(acc[mt][j], ab, bs[2 * j], bs[2 * j + 1]);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_tf32(acc[mt][j], ab, bb[2 * j], bb[2 * j + 1]);
        }
      }
    }
    ring.release(lane);
  }
}

// ---- wgmma for 64-row tiles ----------------------------------------------

__device__ __forceinline__ uint64_t b_desc(const void* tile) {
  return ((smem_u32(tile) & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(kLbo >> 4) << 16) |
         (static_cast<uint64_t>(kSbo >> 4) << 32);
}

// d[64x128] += a[64x8] (registers, tf32) @ B[8x128] (shared, tf32)
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d = X[64, :] @ Wkn[:, 128] for the four consumer warps as one
// warpgroup: warp w holds rows 16w..16w+15 of A in registers (the mma.sync
// fragment layout), split big/small; each stage's big and small B tiles
// come from the ring. Three wgmma per k-step, small terms first.
template <bool kTwo>
__device__ __forceinline__ void gemm_wg(float (&d)[64], const Operand<float>& x, int nks, Ring& ring,
                                        int warp, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  for (int ks = 0; ks < nks; ++ks) {
    const float* ws = ring.acquire();
    // A loads, fence, commit and wait on every k-step, only the MMAs
    // skipped on fc0's zero padding: faster on an H100 than keeping all of
    // it under the branch
    const bool first = !kTwo || ks < x.nks1;
    const float* base = first ? x.x1 + ks * kKStep : x.x2 + (ks - x.nks1) * kKStep;
    const int ld = first ? x.ld1 : x.ld2;
    const int kv = kTwo && first ? x.kv1 - ks * kKStep : kKStep;
    const float* xr = base + (16 * warp + g) * ld + t;
    const float av[4] = {t < kv ? xr[0] : 0.f, t < kv ? xr[8 * ld] : 0.f,
                         t + 4 < kv ? xr[4] : 0.f, t + 4 < kv ? xr[8 * ld + 4] : 0.f};
    uint32_t ab[4], as[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(av[i], ab[i], as[i]);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    if (!kTwo || ks < x.nks_c) {
      wgmma_tf32(d, as, b_desc(ws));
      wgmma_tf32(d, ab, b_desc(ws + kTile));
      wgmma_tf32(d, ab, b_desc(ws));
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    ring.release(lane);
  }
}

// store() for gemm_wg's accumulators: warp w's rows 16w + g (+8), n-tile j
// at d[4j .. 4j + 3] as in the mma.sync layout.
__device__ __forceinline__ void store_wg(const float (&d)[64], float* Y, int ldy,
                                         const float* __restrict__ bias, int nb, bool act,
                                         float post, int warp, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = j * 8 + 2 * t;
    float bx = 0.f, by = 0.f;
    if (bias != nullptr) {
      if (c < nb) bx = __ldg(bias + c);
      if (c + 1 < nb) by = __ldg(bias + c + 1);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float vx = d[4 * j + 2 * h] + bx;
      float vy = d[4 * j + 2 * h + 1] + by;
      if (act) {
        vx = leaky(vx);
        vy = leaky(vy);
      }
      const int r = 16 * warp + g + 8 * h;
      *reinterpret_cast<float2*>(Y + r * ldy + c) = make_float2(vx * post, vy * post);
    }
  }
}

// Y[r, c] = act(acc + bias[c]) * post for the fragment rows of gemm();
// bias is read for c < nb (zero beyond), so padded columns stay 0.
template <int MT>
__device__ __forceinline__ void store(const float (&acc)[MT][4][4], float* Y, int ldy, int mt_n,
                                      const float* __restrict__ bias, int nb, bool act, float post,
                                      int wn, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    if (mt >= mt_n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = wn * 32 + j * 8 + 2 * t;
      float bx = 0.f, by = 0.f;
      if (bias != nullptr) {
        if (c < nb) bx = __ldg(bias + c);
        if (c + 1 < nb) by = __ldg(bias + c + 1);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float vx = acc[mt][j][2 * h] + bx;
        float vy = acc[mt][j][2 * h + 1] + by;
        if (act) {
          vx = leaky(vx);
          vy = leaky(vy);
        }
        const int r = 16 * mt + g + 8 * h;
        *reinterpret_cast<float2*>(Y + r * ldy + c) = make_float2(vx * post, vy * post);
      }
    }
  }
}

// ---- bf16 tensor-core products (the bf16 instantiation) ---------------------

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two consecutive bf16 (columns c, c + 1 of a row) as one A register, the
// lower column in the low half
__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// the same where the row stride may be odd (the features) and columns
// >= kv read as 0
__device__ __forceinline__ uint32_t ld_pair_masked(const bf16* p, int c, int kv) {
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
  const uint32_t lo = c < kv ? q[0] : 0u;
  const uint32_t hi = c + 1 < kv ? q[1] : 0u;
  return lo | (hi << 16);
}

// Ends the current block of fc0: tot = bf16(tot + bf16(acc)) (tot =
// bf16(acc) for the first block), acc = 0. tot holds bf16 pairs.
template <int MT, int NJ = 4>
__device__ __forceinline__ void fold_block(float (&acc)[MT][NJ][4], uint32_t (&tot)[MT][NJ][2],
                                           bool first) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float a0 = rnd<bf16>(acc[mt][j][2 * h]), a1 = rnd<bf16>(acc[mt][j][2 * h + 1]);
        if (!first) {
          const float2 tf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&tot[mt][j][h]));
          a0 = tf.x + a0;
          a1 = tf.y + a1;
        }
        const __nv_bfloat162 r = __floats2bfloat162_rn(a0, a1);
        tot[mt][j][h] = *reinterpret_cast<const uint32_t*>(&r);
        acc[mt][j][2 * h] = 0.f;
        acc[mt][j][2 * h + 1] = 0.f;
      }
}

// store() for bf16 tiles, rounding as the Pallas kernel's mm() and its
// callers do: the product to bf16, + bf16(bias) in bf16, * post in bf16
// (post is a bf16 value), then leaky ReLU in bf16. Warp wn holds the NJ
// n-tiles of columns [8 NJ wn, 8 NJ (wn + 1)).
template <int MT, int NJ = 4>
__device__ __forceinline__ void store_bf(const float (&acc)[MT][NJ][4], bf16* Y, int mt_n,
                                         const float* __restrict__ bias, int nb, bool act,
                                         float post, int wn, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    if (mt >= mt_n) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = wn * 8 * NJ + j * 8 + 2 * t;
      float bx = 0.f, by = 0.f;
      if (bias != nullptr) {
        if (c < nb) bx = rnd<bf16>(__ldg(bias + c));
        if (c + 1 < nb) by = rnd<bf16>(__ldg(bias + c + 1));
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float vx = rnd<bf16>(acc[mt][j][2 * h]);
        float vy = rnd<bf16>(acc[mt][j][2 * h + 1]);
        vx = rnd<bf16>(rnd<bf16>(vx + bx) * post);
        vy = rnd<bf16>(rnd<bf16>(vy + by) * post);
        if (act) {
          vx = leaky_b(vx);
          vy = leaky_b(vy);
        }
        const int r = 16 * mt + g + 8 * h;
        *reinterpret_cast<__nv_bfloat162*>(Y + r * kLdhB + c) = __floats2bfloat162_rn(vx, vy);
      }
    }
  }
}

// Element (r, c) of a [rows, 128] tile: at row stride ld (RowMajor), or in
// the wide tiles' core-matrix layout (CoreTile: 64 rows, 8 x 8 blocks of 16
// bytes a row, rows of a block 16 bytes apart, blocks of 8 rows 128 bytes
// apart, blocks of 8 columns 1 KB apart; the K-major layout wgmma reads
// through a descriptor).
struct RowMajor {
  int ld;
  __device__ __forceinline__ int operator()(int r, int c) const { return r * ld + c; }
};
struct CoreTile {
  __device__ __forceinline__ int operator()(int r, int c) const {
    return ((c >> 3) << 9) + ((r >> 3) << 6) + ((r & 7) << 3) + (c & 7);
  }
};

// Residual + LayerNorm over the first W (<= 128) columns, one warp per
// sample, the row held in registers (4 values a lane); y of sample t at
// Y[at(t, c)] (RowMajor, or the wide tiles' CoreTile), the residual at row
// stride ldr; the residual sum and the statistics are f32.
template <typename E, typename At>
__device__ __forceinline__ void layer_norm(const Args& a, const E* Y, At at, const E* R, int ldr,
                                           int n0, int t_valid, int warp, int nwarps, int lane) {
  const int W = a.W;
  for (int t = warp; t < t_valid; t += nwarps) {
    const E* res = R + static_cast<size_t>(t) * ldr;
    float v[kHd / 32];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kHd / 32; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < W ? to_f(Y[at(t, c)]) + to_f(res[c]) : 0.f;
      s += v[i];
    }
    const float mean = warp_sum(s) / W;
    float var = 0.f;
#pragma unroll
    for (int i = 0; i < kHd / 32; ++i) {
      const float d = lane + 32 * i < W ? v[i] - mean : 0.f;
      var += d * d;
    }
    const float inv = 1.f / sqrtf(warp_sum(var) / W + kLnEps);
    float* orow = a.out + static_cast<size_t>(n0 + t) * W;
#pragma unroll
    for (int i = 0; i < kHd / 32; ++i) {
      const int c = lane + 32 * i;
      if (c < W) orow[c] = (v[i] - mean) * inv * __ldg(a.ln_s + c) + __ldg(a.ln_b + c);
    }
  }
}

// Lq=1 attention over the K neighbours (f32): one warp per (sample, head),
// lane = dimension; the scores of 8 keys at a time are reduced together
// (online softmax across groups of 8, the max subtracted). o overwrites q
// in place (each lane reads its q before writing its o).
__device__ __forceinline__ void group_scores(float (&sc)[8], float qd, const float* Kt, int ldx,
                                             int K, int t, int k0, int col) {
#pragma unroll
  for (int j = 0; j < 8; ++j) sc[j] = k0 + j < K ? qd * Kt[(t * K + k0 + j) * ldx + col] : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int j = 0; j < 8; ++j) sc[j] += __shfl_xor_sync(0xffffffffu, sc[j], off);
}

__device__ __forceinline__ void attention(float* Q, const float* Kt, const float* Vt, int ldx,
                                          int K, int t_valid, int warp, int nwarps, int lane) {
  for (int task = warp; task < t_valid * kHeads; task += nwarps) {
    const int t = task / kHeads;
    const int col = (task - t * kHeads) * kDk + lane;
    const float qd = Q[t * ldx + col];
    float m = -3.402823466e38f, den = 0.f, o = 0.f;
    for (int k0 = 0; k0 < K; k0 += 8) {
      float sc[8];
      group_scores(sc, qd, Kt, ldx, K, t, k0, col);
      float mc = m;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (k0 + j < K) mc = fmaxf(mc, sc[j]);
      const float rescale = expf(m - mc);
      den *= rescale;
      o *= rescale;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (k0 + j < K) {
          const float e = expf(sc[j] - mc);
          den += e;
          o = fmaf(e, Vt[(t * K + k0 + j) * ldx + col], o);
        }
      }
      m = mc;
    }
    Q[t * ldx + col] = o / den;
  }
}

// One 64/32/16-row product of the f32 chain, Y = act(X @ Wkn + bias):
// wgmma for 64-row tiles and mma.sync otherwise. in_place: Y overwrites the
// operand's region, so every warp must have read it first.
template <int MT, bool kTwo>
__device__ __forceinline__ void product(const Operand<float>& x, int nks, Ring& ring, float* Y,
                                        const float* bias, int nb, bool act, bool in_place,
                                        int warp, int lane) {
  if constexpr (MT == 4) {
    float d[64];
    gemm_wg<kTwo>(d, x, nks, ring, warp, lane);
    if (in_place) bar_consumers(kConsThreads);
    store_wg(d, Y, kLdh, bias, nb, act, 1.f, warp, lane);
  } else {
    float acc[MT][4][4];
    gemm<MT, true, kTwo, false>(acc, x, MT, nks, ring, warp, lane);
    if (in_place) bar_consumers(kConsThreads);
    store<MT>(acc, Y, kLdh, MT, bias, nb, act, 1.f, warp, lane);
  }
}

// Producer: one lane streams every stage the consumers will read, in order
// (kSteps k-steps of depth kDep a stage).
template <int kSteps, int kDep>
__device__ void produce(const Args& a, float* ring_buf, uint64_t* full, uint64_t* empty) {
  int slot = 0;
  uint32_t phase = 0;
  const float* src = static_cast<const float*>(a.wpack);
  for (int p = 0; p < kProducts; ++p) {
    const int nstage = (p == kFc0 ? a.ks0p : kHd / kDep) / kSteps;
    if (a.K == 1 && (p == kWk || p == kWq)) {  // no scores with one neighbour
      src += nstage * kStageFloats;
      continue;
    }
    for (int s = 0; s < nstage; ++s) {
      mbar_wait(empty + slot, phase ^ 1u);
      mbar_expect_tx(full + slot, kStageBytes);
      bulk_load(ring_buf + slot * kStageFloats, src, kStageBytes, full + slot);
      src += kStageFloats;
      if (++slot == a.nst) {
        slot = 0;
        phase ^= 1u;
      }
    }
  }
}

// The f32 instantiation at 16/32/64-row tiles (bf16 launches run the
// cluster and wide tiles).
template <int MT>
__global__ void __launch_bounds__((kCons + 1) * 32, 2) fused_agg_kernel(const Args a) {
  using E = float;
  constexpr int kRows = 16 * MT;           // rows (= T*K, padded) of one CTA
  constexpr bool kWgmma = MT == 4;          // 64-row tiles: wgmma products
  constexpr int kDep = Elem<E>::kDep;       // MMA depth
  constexpr int kLd = Elem<E>::kLd;         // row stride of the [rows, 128] tiles
  constexpr int kVec = 16 / static_cast<int>(sizeof(E));  // elements of 16 bytes
  extern __shared__ __align__(128) float smem[];
  const int K = a.K, F = a.F, W = a.W, T = a.T, NF = a.NF, lde = a.lde;
  const int RD1 = a.RD1, RD2 = a.RD2;

  float* ring_buf = smem;                                             // [nst, 8 KB]
  E* FEAT = reinterpret_cast<E*>(ring_buf + a.nst * kStageFloats);   // [kRows, F] + pad; later A | B
  E* EMB = FEAT + a.feat_elems;                                       // [kRows, lde]
  E* MV = FEAT + a.region;                                            // [q_rows, kLd] (K > 1)
  E* Q = MV + a.q_rows * kLd;                                         // [q_rows, kLd] (K > 1)
  float* RDW = reinterpret_cast<float*>(Q + a.q_rows * kLd);          // ray-diff MLP weights
  uint64_t* full = reinterpret_cast<uint64_t*>(RDW + a.rdw_floats);
  uint64_t* empty = full + kMaxStages;
  uint64_t* feat_bar = empty + kMaxStages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < a.nst; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kCons);
    }
    mbar_init(feat_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (warp == kCons) {
    if (lane == 0) produce<kWgmma ? 1 : kStageK, kDep>(a, ring_buf, full, empty);
    return;
  }

  const int n0 = blockIdx.x * T;
  const int t_valid = min(T, a.N - n0);
  const int rows_valid = t_valid * K;
  // EMB row: [off(3) | sin(3NF) | cos(3NF) | rdfc(RD2) | 0]
  const int off_col = 0;
  const int sin_col = 3;
  const int trig = 3 * NF;
  const int cos_col = sin_col + trig;
  const int rd_col = cos_col + trig;
  const int emb_end = rd_col + RD2;
  const E* mv = static_cast<const E*>(a.mv);

  // 1. neighbour features: the 16-byte-aligned body of the tile's block in
  //    one bulk copy, the < 16 bytes at either end by hand; zeros after the
  //    valid rows (fc0 reads up to kDep ceil(F/kDep) columns of the last
  //    row). The rows start at FX, shifted so that source and copy align alike.
  const E* feat = static_cast<const E*>(a.nb_feat) + static_cast<size_t>(n0) * K * F;
  const int nfeat = rows_valid * F;
  const int head = min(static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(feat) & 15)) & 15) /
                                        sizeof(E)),
                       nfeat);
  const int body = (nfeat - head) & ~(kVec - 1);
  E* FX = FEAT + ((kVec - head) & (kVec - 1));
  if (tid == 0) {
    mbar_expect_tx(feat_bar, body * sizeof(E));
    if (body > 0) bulk_load(FX + head, feat + head, body * sizeof(E), feat_bar);
  }
  if (tid < head) FX[tid] = feat[tid];
  if (tid < nfeat - head - body) FX[head + body + tid] = feat[head + body + tid];
  for (int i = nfeat + tid; i < kRows * F + kDep; i += kConsThreads) FX[i] = from_f<E>(0.f);
  for (int r = warp; r < kRows; r += kCons)
    for (int c = emb_end + lane; c < kDep * a.ks_e; c += 32)
      EMB[r * lde + c] = from_f<E>(0.f);
  // ray-diff MLP weights [rd_w1 | rd_b1 | rd_w2 | rd_b2] (f32), then mv:
  // cp.async (copies through registers would wait for device memory one by one)
  float* w1s = RDW;
  float* b1s = w1s + 4 * RD1;
  float* w2s = b1s + RD1;
  float* b2s = w2s + RD1 * RD2;
  for (int i = tid; i < 4 * RD1; i += kConsThreads) cp_async4(w1s + i, a.rd_w1 + i);
  for (int i = tid; i < RD1; i += kConsThreads) cp_async4(b1s + i, a.rd_b1 + i);
  for (int i = tid; i < RD1 * RD2; i += kConsThreads) cp_async4(w2s + i, a.rd_w2 + i);
  for (int i = tid; i < RD2; i += kConsThreads) cp_async4(b2s + i, a.rd_b2 + i);
  cp_async_commit();
  constexpr int kPer = 4 / static_cast<int>(sizeof(E));  // elements of one 4-byte copy (W even in bf16)
  for (int t = warp; t < a.q_rows; t += kCons) {
    const E* mr = mv + static_cast<size_t>(n0 + t) * W;
    for (int c = kPer * lane; c < kHd; c += 32 * kPer) {
      if (t < t_valid && c < W) {
        cp_async4(MV + t * kLd + c, mr + c);
      } else {
#pragma unroll
        for (int e = 0; e < kPer; ++e) MV[t * kLd + c + e] = from_f<E>(0.f);
      }
    }
  }
  cp_async_commit();
  cp_async_wait<1>();   // the MLP weights; mv may still be in flight
  bar_consumers(kConsThreads);

  // 2. one thread a row: offsets, rdiff and the ray-diff MLP's hidden layer
  //    h, parked in the row's sin columns (RD1 <= 6 NF) until the embedding
  //    is written
  if (tid < kRows) {
    const int r = tid;
    float off[3] = {0.f, 0.f, 0.f};
    float rdiff[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < rows_valid) {
      const int tt = r / K;
      const int n = n0 + tt;
      const size_t nk = static_cast<size_t>(n) * K + (r - tt * K);
      const float sc = __ldg(a.scale);
      float d3[3], nb[3], diff[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        off[d] = (a.xyz[static_cast<size_t>(n) * 3 + d] - a.nb_xyz[nk * 3 + d]) / sc;
        d3[d] = a.dir[static_cast<size_t>(n) * a.dir_stride + d];
        nb[d] = a.nb_dir[nk * 4 + d];
        diff[d] = d3[d] - nb[d];
      }
      const float ss = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2];
      const float den = fmaxf(sqrtf(ss + 1e-12f), 1e-6f);
      rdiff[0] = diff[0] / den;
      rdiff[1] = diff[1] / den;
      rdiff[2] = diff[2] / den;
      rdiff[3] = d3[0] * nb[0] + d3[1] * nb[1] + d3[2] * nb[2];
    }
    E* er = EMB + r * lde;
#pragma unroll
    for (int d = 0; d < 3; ++d) er[off_col + d] = off[d];
    for (int m = 0; m < RD1; ++m) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) s = fmaf(rdiff[i], w1s[i * RD1 + m], s);
      er[sin_col + m] = leaky(s + b1s[m]);
    }
  }
  bar_consumers(kConsThreads);
  // 3. the ray-diff MLP's output layer: one warp a row, lane n < RD2 holds
  //    column n of rd_w2 in registers
  {
    float w2c[kMaxRd];
#pragma unroll
    for (int m = 0; m < kMaxRd; ++m) w2c[m] = (m < RD1 && lane < RD2) ? w2s[m * RD2 + lane] : 0.f;
    const float b2c = lane < RD2 ? b2s[lane] : 0.f;
    for (int r = warp; r < kRows; r += kCons) {
      const E* h = EMB + r * lde + sin_col;
      float s = b2c;
#pragma unroll
      for (int m = 0; m < kMaxRd; ++m)
        if (m < RD1) s = fmaf(h[m], w2c[m], s);
      if (lane < RD2) EMB[r * lde + rd_col + lane] = leaky(s);
    }
  }
  bar_consumers(kConsThreads);
  // 4. frequency embedding (f32 phases, accurate sincosf), one warp a row
  for (int r = warp; r < kRows; r += kCons) {
    E* er = EMB + r * lde;
    for (int j = lane; j < 3 * NF; j += 32) {
      float sn, cs;
      sincosf(er[off_col + j % 3] * __ldg(a.freqs + j / 3), &sn, &cs);
      er[sin_col + j] = sn;
      er[cos_col + j] = cs;
    }
  }
  cp_async_wait<0>();
  mbar_wait(feat_bar, 0);
  bar_consumers(kConsThreads);

  // 5. base_mlp and the value projection on the tensor cores; once fc0 has
  //    read x_in, its region holds A and B, two [kRows, 128] tiles
  E* A = FEAT;
  E* B = FEAT + kRows * kLd;
  const Operand<E> opA = tile_operand(static_cast<const E*>(A), kLd);
  const Operand<E> opB = tile_operand(static_cast<const E*>(B), kLd);
  constexpr int kKs = kHd / kDep;
  Ring ring{ring_buf, full, empty, a.nst, 0, 0u};
  const Operand<E> x_in{FX, F, F, a.ks_f, EMB, lde, a.ks_f + a.ks_e, {0, 0, 0}};
  product<MT, true>(x_in, a.ks0p, ring, A, a.b0, W, true, true, warp, lane);
  bar_consumers(kConsThreads);
  product<MT, false>(opA, kKs, ring, B, a.b1, W, true, false, warp, lane);
  bar_consumers(kConsThreads);
  product<MT, false>(opB, kKs, ring, A, a.b2, W, true, false, warp, lane);    // pf
  bar_consumers(kConsThreads);
  product<MT, false>(opA, kKs, ring, B, nullptr, 0, false, false, warp, lane);  // v

  if (K == 1) {
    // 6'. one neighbour: o = v; y = v @ wfc; residual from device memory
    bar_consumers(kConsThreads);
    product<MT, false>(opB, kKs, ring, A, nullptr, 0, false, false, warp, lane);
    bar_consumers(kConsThreads);
    layer_norm(a, A, RowMajor{kLd}, mv + static_cast<size_t>(n0) * W, W, n0, t_valid, warp, kCons,
               lane);
    return;
  }

  // 6. keys (over pf, in place) and queries (16-row tiles of mv, mma.sync)
  product<MT, false>(opA, kKs, ring, A, nullptr, 0, false, true, warp, lane);  // k
  float acc[MT][4][4];
  const int mt_q = a.q_rows / 16;
  gemm<MT, false, false, kWgmma>(acc, tile_operand(static_cast<const E*>(MV), kLd), mt_q, kKs,
                                 ring, warp, lane);
  store<MT>(acc, Q, kLdh, mt_q, nullptr, 0, false, a.q_scale, warp, lane);
  bar_consumers(kConsThreads);

  // 7. Lq=1 attention over the K neighbours
  attention(Q, A, B, kLd, K, t_valid, warp, kCons, lane);
  bar_consumers(kConsThreads);

  // 8. output projection, residual and LayerNorm
  gemm<MT, false, false, kWgmma>(acc, tile_operand(static_cast<const E*>(Q), kLd), mt_q, kKs,
                                 ring, warp, lane);
  bar_consumers(kConsThreads);   // every warp has read o
  store<MT>(acc, Q, kLdh, mt_q, nullptr, 0, false, 1.f, warp, lane);
  bar_consumers(kConsThreads);
  layer_norm(a, Q, RowMajor{kLd}, MV, kLd, n0, t_valid, warp, kCons, lane);
}

// ---- wide bf16 tiles: warpgroups of 64 rows sharing one weight ring --------

constexpr int kWgRows = 64;            // rows of one consumer warpgroup
constexpr int kWgThreads = 128;
constexpr int kWgWarps = 4;
// A-operand descriptor strides of CoreTile (no swizzle): blocks of 8
// columns (K) 1 KB apart, blocks of 8 rows 128 bytes apart
constexpr uint32_t kALbo = 1024;
constexpr uint32_t kASbo = 128;
constexpr int kCoreKStep = 2 * 512;    // elements of one k-step (16 columns) of a CoreTile
constexpr int kWideHeader = 256;       // bytes of a wide CTA's barriers

// the warpgroup's own barrier (ids 1.. ; 0 is __syncthreads)
__device__ __forceinline__ void bar_wg(int wg) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + wg), "r"(kWgThreads) : "memory");
}

// generic-proxy writes of shared memory made visible to wgmma's (async
// proxy) reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending) : "memory");
}
// keeps the compiler from moving accesses of the accumulators across the
// wgmma issue and wait instructions
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint64_t a_desc(const void* tile) {
  return ((smem_u32(tile) & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(kALbo >> 4) << 16) |
         (static_cast<uint64_t>(kASbo >> 4) << 32);
}

// d[64x128] += A[64x16] (shared, bf16, K-major CoreTile) @ B[16x128] (shared)
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// The weight ring of a wide CTA. Every consumer warp reads every stage and
// releases it with one arrival (release semantics) on the slot's empty
// barrier. The arrival that completes the barrier's phase (the barrier's
// state before it shows one arrival pending) refills the slot with the
// stage nst further on, after an acquire of that phase, so no warp is set
// aside to produce and none waits to refill. Stage `it` of the stream is
// packed stage `it` (+ skip_n from skip_at on: with K = 1 the key and query
// products are not streamed).
struct WideRing {
  unsigned char* buf;
  uint64_t* full;
  uint64_t* empty;
  const unsigned char* src;
  int nst, total, skip_at, skip_n;
  int aslot, rslot, rel;   // this warp's next slot to acquire and to release, stages released
  uint32_t aphase, rphase;

  __device__ __forceinline__ void fill(int slot, int it) const {
    const int at = it < skip_at ? it : it + skip_n;
    mbar_expect_tx(full + slot, kStageBytes);
    bulk_load(buf + slot * kStageBytes, src + static_cast<size_t>(at) * kStageBytes, kStageBytes,
              full + slot);
  }
  __device__ __forceinline__ const float* acquire() {
    mbar_wait(full + aslot, aphase);
    const unsigned char* p = buf + aslot * kStageBytes;
    if (++aslot == nst) {
      aslot = 0;
      aphase ^= 1u;
    }
    return reinterpret_cast<const float*>(p);
  }
  // the oldest stage this warp holds, once all its lanes are done with it
  __device__ __forceinline__ void release(int lane) {
    __syncwarp();
    if (lane == 0 && mbar_arrive_last(empty + rslot) && rel + nst < total) {
      // acquire: every warp's release arrival came before this one's
      asm volatile("fence.acq_rel.cta;" ::: "memory");
      fill(rslot, rel + nst);
    }
    if (++rslot == nst) {
      rslot = 0;
      rphase ^= 1u;
    }
    ++rel;
  }
};

// The 16-row q and o products of the wide tiles (gemm() for bf16
// operands): acc[mt] = X[16 mt .. +16, :] @ Wkn[:, 32 wn .. 32 wn + 32] for
// mt < mt_n, one mma.sync m16n8k16 per n-tile and k-step, the weights
// streamed through the wide ring (wgmma's core-matrix layout): b0 of n-tile
// j at (k-half 0, n-group 4 wn + j), row g, columns 2t, 2t + 1; b1 at k-half 1.
template <int MT>
__device__ __forceinline__ void gemm_bf(float (&acc)[MT][4][4], const Operand<bf16>& x, int mt_n,
                                        int nks, WideRing& ring, int wn, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
  for (int s = 0; s < nks; s += kStageK) {
    const unsigned char* ws = reinterpret_cast<const unsigned char*>(ring.acquire());
#pragma unroll
    for (int kk = 0; kk < kStageK; ++kk) {
      const int ks = s + kk;
      uint32_t bw[8];
      const uint32_t* wsw = reinterpret_cast<const uint32_t*>(ws + kk * kTileBytesB);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ng = 4 * wn + j;
        bw[2 * j] = wsw[ng * 32 + 4 * g + t];
        bw[2 * j + 1] = wsw[512 + ng * 32 + 4 * g + t];
      }
      const bf16* base = x.x1 + ks * kKStepB;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mt < mt_n) {
          const bf16* xr = base + (16 * mt + g) * x.ld1 + 2 * t;
          uint32_t a[4];
          a[0] = ld_pair(xr);
          a[1] = ld_pair(xr + 8 * x.ld1);
          a[2] = ld_pair(xr + 8);
          a[3] = ld_pair(xr + 8 * x.ld1 + 8);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc[mt][j], a, bw[2 * j], bw[2 * j + 1]);
        }
      }
    }
    ring.release(lane);
  }
}

// The A operand of a wide product: the CoreTile `tile` (a descriptor per
// k-step), of which nks_c k-steps are computed. Bit ks of fold is set where
// one of fc0's blocks ends after k-step ks (a mask, so that the test is
// uniform across the warpgroup as the compiler sees it); the first block
// ends at the lowest bit.
struct WideOperand {
  const bf16* tile;
  int nks_c;
  uint32_t fold;
};

// the two bf16 of a word (lower column in the low half) as f32
__device__ __forceinline__ float lo_f(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_f(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// the four words of a 16-byte chunk of bf16
__device__ __forceinline__ void words(const uint4& v, uint32_t (&w)[4]) {
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

// bf16(bf16(a) + bf16(b)) for two columns at once. The f32 sum of two bf16
// values rounded to bf16 is the correctly rounded bf16 sum (24 >= 2 * 8 + 2
// bits: the double rounding is innocuous), which is what the bf16x2 add
// computes, so this equals the f32 add and rounding the plain version does.
__device__ __forceinline__ __nv_bfloat162 add_bf2(__nv_bfloat162 a, __nv_bfloat162 b) {
  return __hadd2(a, b);
}

// fc0's block sum: tot = bf16(tot + bf16(d)) (tot = bf16(d) for the first
// block), d = 0; tot holds bf16 pairs
__device__ __forceinline__ void fold_wide(float (&d)[64], uint32_t (&tot)[32], bool first) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    __nv_bfloat162 r = __floats2bfloat162_rn(d[2 * i], d[2 * i + 1]);
    if (!first) r = add_bf2(*reinterpret_cast<const __nv_bfloat162*>(&tot[i]), r);
    tot[i] = bf2_bits(r);
    d[2 * i] = 0.f;
    d[2 * i + 1] = 0.f;
  }
}

// d = X[64, :] @ Wkn[:, 128] for one warpgroup, one wgmma m64n128k16 per
// k-step, A and B through descriptors. A stage's k-steps are issued back to
// back and committed once; a stage is waited for (wait_group 1) only once
// the next one is issued, then its slot is released; fc0's block ends wait
// in full. kTwo (fc0): the product is the bf16 sum of its blocks'
// products, each rounded, as in gemm_cl.
template <bool kTwo>
__device__ __forceinline__ void gemm_wide(float (&d)[64], const WideOperand& x, int nks,
                                          WideRing& ring, int ww, int lane) {
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  uint32_t tot[kTwo ? 32 : 1];
  bool pend = false;   // the previous stage's slot is still held
  const uint32_t first_end = x.fold & (0u - x.fold);   // the lowest bit
  for (int s = 0; s < nks; s += kStageK) {
    const unsigned char* ws = reinterpret_cast<const unsigned char*>(ring.acquire());
    fence_acc(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kStageK; ++kk) {
      const int ks = s + kk;
      if (kTwo && ks >= x.nks_c) break;   // the same for the whole warpgroup
      wgmma_bf16_ss(d, a_desc(x.tile + ks * kCoreKStep), b_desc(ws + kk * kTileBytesB));
      if constexpr (kTwo) {
        if ((x.fold >> ks) & 1u) {
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc(d);
          if (pend) {
            ring.release(lane);
            pend = false;
          }
          fold_wide(d, tot, (1u << ks) == first_end);
          fence_acc(d);
          wgmma_fence();
        }
      }
    }
    wgmma_commit();
    if (pend) {
      wgmma_wait<1>();
      ring.release(lane);
    }
    pend = true;
  }
  wgmma_wait<0>();
  fence_acc(d);
  if (pend) ring.release(lane);
  if constexpr (kTwo) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float2 tf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&tot[i]));
      d[2 * i] = tf.x;
      d[2 * i + 1] = tf.y;
    }
  }
}

// Y (CoreTile) = act(bf16(d) + bf16(bias)) as store_bf rounds: warp ww's
// rows 16 ww + g (+8), n-tile j at d[4j .. 4j + 3]; then made visible to
// the next product's descriptor reads. Two columns at a time, in bf16x2:
// the bias sum by add_bf2, the leaky ReLU as multiply and max (x *
// bf16(0.01) is exact in f32, so the bf16 multiply rounds it once, as
// leaky_b does).
__device__ __forceinline__ void store_wide(const float (&d)[64], bf16* Y,
                                           const float* __restrict__ bias, int nb, bool act,
                                           int ww, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
  const __nv_bfloat162 leak = __float2bfloat162_rn(kLeakB);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = j * 8 + 2 * t;
    const __nv_bfloat162 b2 = __floats2bfloat162_rn(
        bias != nullptr && c < nb ? __ldg(bias + c) : 0.f,
        bias != nullptr && c + 1 < nb ? __ldg(bias + c + 1) : 0.f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      __nv_bfloat162 y = __floats2bfloat162_rn(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
      if (bias != nullptr) y = add_bf2(y, b2);
      if (act) y = __hmax2(y, __hmul2(y, leak));
      *reinterpret_cast<__nv_bfloat162*>(Y + CoreTile{}(16 * ww + g + 8 * h, c)) = y;
    }
  }
  fence_async_smem();
}

// q . k of one key and head: the 32 products of bf16 values rounded to bf16
// (as attention<bf16> rounds them), summed in f32 (four partial sums). q
// holds the head's 32 values of q as 16 words; the key is row `row` of the
// CoreTile Kt.
__device__ __forceinline__ float head_score(const bf16* Kt, const uint32_t (&q)[16], int row,
                                            int h) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t kw[4];
    words(*reinterpret_cast<const uint4*>(Kt + CoreTile{}(row, h * kDk + 8 * i)), kw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t p = bf2_bits(__floats2bfloat162_rn(lo_f(q[4 * i + e]) * lo_f(kw[e]),
                                                        hi_f(q[4 * i + e]) * hi_f(kw[e])));
      s[e] += lo_f(p) + hi_f(p);
    }
  }
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// One round of attention_wide's sum over a head's lanes: lanes whose bit
// kHalf / 4 is set keep dimensions [kHalf, 2 kHalf) of o, the others [0,
// kHalf), each adding its partner's (lane ^ kHalf / 4) into o[0, kHalf).
template <int kHalf>
__device__ __forceinline__ void halve(float (&o)[kDk], bool upper) {
#pragma unroll
  for (int d = 0; d < kHalf; ++d) {
    const float send = upper ? o[d] : o[d + kHalf];
    const float keep = upper ? o[d + kHalf] : o[d];
    o[d] = keep + __shfl_xor_sync(0xffffffffu, send, kHalf / 4);
  }
}

// Lq=1 attention of the wide tiles, rounding as attention<bf16>: one warp a
// sample, lane (j, h) = (lane % 8, lane / 8) takes key k0 + j of head h in
// each group of 8 keys: its score (head_score), the max of all K scores
// (a first pass), exp(s - max) summed in f32 and rounded before it meets v,
// each lane summing its keys' weighted 32 values of v in f32; the 8 lanes of
// a head then add their sums (lane j keeps dimensions 4j..4j+3) and write
// o = bf16(sum * bf16(1 / den)) over q. Key and value rows are read 16
// bytes at a time, 8 rows apart across the lanes of a head: no bank
// conflicts beyond the four heads'.
__device__ __forceinline__ void attention_wide(bf16* Q, const bf16* Kt, const bf16* Vt, int K,
                                               int t_valid, int ww, int lane) {
  const int j = lane & 7;
  const int h = lane >> 3;
  for (int t = ww; t < t_valid; t += kWgWarps) {
    uint32_t q[16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t w[4];
      words(*reinterpret_cast<const uint4*>(Q + t * kLdhB + h * kDk + 8 * i), w);
#pragma unroll
      for (int e = 0; e < 4; ++e) q[4 * i + e] = w[e];
    }
    float m = -3.402823466e38f;
    for (int k0 = 0; k0 < K; k0 += 8)
      if (k0 + j < K) m = fmaxf(m, head_score(Kt, q, t * K + k0 + j, h));
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float den = 0.f;
    float o[kDk];
#pragma unroll
    for (int d = 0; d < kDk; ++d) o[d] = 0.f;
    for (int k0 = 0; k0 < K; k0 += 8) {
      if (k0 + j >= K) continue;
      const int row = t * K + k0 + j;
      const float e = expf(head_score(Kt, q, row, h) - m);
      den += e;
      const float w = rnd<bf16>(e);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t vw[4];
        words(*reinterpret_cast<const uint4*>(Vt + CoreTile{}(row, h * kDk + 8 * i)), vw);
#pragma unroll
        for (int e2 = 0; e2 < 4; ++e2) {
          o[8 * i + 2 * e2] = fmaf(w, lo_f(vw[e2]), o[8 * i + 2 * e2]);
          o[8 * i + 2 * e2 + 1] = fmaf(w, hi_f(vw[e2]), o[8 * i + 2 * e2 + 1]);
        }
      }
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) den += __shfl_xor_sync(0xffffffffu, den, off);
    // sum over the head's 8 lanes, halving the dimensions a lane keeps each
    // round: 32 -> 16 (lane bit 2) -> 8 (bit 1) -> 4 (bit 0)
    halve<16>(o, (j & 4) != 0);
    halve<8>(o, (j & 2) != 0);
    halve<4>(o, (j & 1) != 0);
    const float r = rnd<bf16>(1.f / den);
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(Q + t * kLdhB + h * kDk + 4 * j);
    dst[0] = __floats2bfloat162_rn(o[0] * r, o[1] * r);
    dst[1] = __floats2bfloat162_rn(o[2] * r, o[3] * r);
  }
}

// One wide product Y = act(X @ Wkn + bias) of a warpgroup. in_place: Y
// overwrites the operand's region, so every warp must have read it first.
template <bool kTwo>
__device__ __forceinline__ void product_wide(const WideOperand& x, int nks, WideRing& ring, bf16* Y,
                                             const float* bias, int nb, bool act, bool in_place,
                                             int wg, int ww, int lane) {
  float d[64];
  gemm_wide<kTwo>(d, x, nks, ring, ww, lane);
  if (in_place) bar_wg(wg);
  store_wide(d, Y, bias, nb, act, ww, lane);
}

__device__ __forceinline__ WideOperand core_operand(const bf16* tile) {
  return WideOperand{tile, kHd / kKStepB, 0u};
}

// One pass of a warpgroup's neighbour features, rows [r0, r1) (those below
// rows_valid): the block src[0, n) (contiguous in device memory) goes to the
// staging copy SX, its 16-byte-aligned body by one bulk copy, the < 16
// bytes at either end by hand; SX is shifted so that source and copy align
// alike.
struct FeaturePass {
  const bf16* src;
  bf16* SX;
  int n, head, body;
  __device__ __forceinline__ FeaturePass(const bf16* feat, bf16* stage, int F, int r0, int r1,
                                         int rows_valid) {
    src = feat + r0 * F;
    n = (max(r0, min(r1, rows_valid)) - r0) * F;
    head = min(static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15) /
                                sizeof(bf16)),
               n);
    body = (n - head) & ~7;
    SX = stage + ((8 - head) & 7);
  }
  __device__ __forceinline__ void issue(uint64_t* bar) const {
    mbar_expect_tx(bar, body * sizeof(bf16));
    if (body > 0) bulk_load(SX + head, src + head, body * sizeof(bf16), bar);
  }
};

// Rows [r0, r1) of a warpgroup's neighbour features from the staging copy
// SX (rows at stride F from row r0, 2-byte aligned) into the CoreTile FC
// [64, 8 nblk], zero at columns >= F and rows >= rows_valid: thread (r, p) =
// (r0 + wt % 64, wt / 64) fills the 8-column blocks p, p + 2, ... of row r,
// each read as 4 aligned words, or as 5 shifted into place when it starts
// on an odd element.
__device__ __forceinline__ void stage_features(bf16* FC, const bf16* SX, int F, int nblk, int r0,
                                               int r1, int rows_valid, int wt) {
  const int r = r0 + wt % kWgRows;
  if (r >= r1) return;
  const bool row_ok = r < rows_valid;
  for (int cb = wt / kWgRows; cb < nblk; cb += kWgThreads / kWgRows) {
    const int c0 = 8 * cb;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (row_ok && c0 < F) {
      const uintptr_t ad = reinterpret_cast<uintptr_t>(SX + (r - r0) * F + c0);
      const uint32_t* wp = reinterpret_cast<const uint32_t*>(ad & ~uintptr_t(3));
      uint32_t x5[5];
#pragma unroll
      for (int i = 0; i < 5; ++i) x5[i] = wp[i];
      const uint32_t sh = (ad & 3) ? 16u : 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = __funnelshift_r(x5[i], x5[i + 1], sh);
      if (c0 + 8 > F) {   // the row's last block: columns >= F read as 0
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (c0 + 2 * i >= F) w[i] = 0u;
          else if (c0 + 2 * i + 1 >= F) w[i] &= 0xffffu;
        }
      }
    }
    *reinterpret_cast<uint4*>(FC + CoreTile{}(r, c0)) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The bf16 instantiation at tiles of 64 NWG rows: NWG consumer warpgroups
// (no producer warp), warpgroup wg holding samples [(b NWG + wg) Twg, +Twg)
// of CTA b, Twg = 64 / K, in its own region of shared memory; the
// warpgroups meet only at the weight ring, whose stages all of them read.
// Each warpgroup runs the 64-row chain of fused_agg_kernel with its own
// barrier, its activations in CoreTile layout (A of every product after
// the features through a descriptor), mv staged after fc0 where x_in was.
template <int NWG>
__global__ void __launch_bounds__(NWG * kWgThreads, 4 / NWG) fused_agg_wide(const Args a) {
  extern __shared__ __align__(128) float smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem);
  const int K = a.K, F = a.F, W = a.W, NF = a.NF;
  const int RD1 = a.RD1, RD2 = a.RD2;
  const int tid = threadIdx.x;
  // warpgroup, thread in it, warp in it (warp-uniform as the compiler sees
  // them: a wgmma behind a branch it takes for divergent is serialized)
  const int wg = __shfl_sync(0xffffffffu, tid / kWgThreads, 0);
  const int wt = tid % kWgThreads;
  const int ww = __shfl_sync(0xffffffffu, wt >> 5, 0);
  const int lane = tid & 31;

  uint64_t* full = reinterpret_cast<uint64_t*>(base);               // [kMaxStages]
  uint64_t* empty = full + kMaxStages;                              // [kMaxStages]
  uint64_t* feat_bar = empty + kMaxStages;                          // [NWG]
  unsigned char* ring_buf = base + kWideHeader;                     // [nst, 8 KB]
  float* RDW = reinterpret_cast<float*>(ring_buf + a.nst * kStageBytes);
  unsigned char* wbase = reinterpret_cast<unsigned char*>(RDW + a.rdw_floats) +
                         static_cast<size_t>(wg) * (2 * a.region + 4 * a.off_floats);
  bf16* FEAT = reinterpret_cast<bf16*>(wbase);                      // CoreTile [64, 16 ks_f]; later A | B | Q
  bf16* EMB = FEAT + a.feat_elems;                                  // CoreTile [64, 16 ks_e]
  float* OFF = reinterpret_cast<float*>(wbase + 2 * a.region);      // [64, 4] f32 offsets
  bf16* A = FEAT;                                                   // CoreTile [64, 128]
  bf16* B = FEAT + kWgRows * kHd;                                   // CoreTile [64, 128]
  bf16* Q = B + kWgRows * kHd;                                      // [q_rows, kLdhB] (K > 1)

  const int twg = a.T / NWG;
  const int n0 = (blockIdx.x * NWG + wg) * twg;
  const int t_valid = max(0, min(twg, a.N - n0));
  const int rows_valid = t_valid * K;
  // the stream: fc0, then six [128, 128] products (K = 1: wk and wq not read)
  const int fc0_st = a.ks0p / kStageK;
  const int sq_st = kHd / kKStepB / kStageK;
  WideRing ring{ring_buf, full, empty, static_cast<const unsigned char*>(a.wpack), a.nst,
                fc0_st + (K == 1 ? 4 : 6) * sq_st, fc0_st + 3 * sq_st, K == 1 ? 2 * sq_st : 0,
                0, 0, 0, 0u, 0u};
  // the geometry of row gr (phase 2), its loads in flight across the set-up
  const int gr = wt % kWgRows;
  float off[3] = {0.f, 0.f, 0.f};
  float rdiff[4] = {0.f, 0.f, 0.f, 0.f};
  if (gr < rows_valid) {
    const int r = gr;
    const int tt = r / K;
    const int n = n0 + tt;
    const size_t nk = static_cast<size_t>(n) * K + (r - tt * K);
    const float sc = __ldg(a.scale);
    float d3[3], nb[3], diff[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      off[d] = (a.xyz[static_cast<size_t>(n) * 3 + d] - a.nb_xyz[nk * 3 + d]) / sc;
      d3[d] = a.dir[static_cast<size_t>(n) * a.dir_stride + d];
      nb[d] = a.nb_dir[nk * 4 + d];
      diff[d] = d3[d] - nb[d];
    }
    const float ss = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2];
    const float den = fmaxf(sqrtf(ss + 1e-12f), 1e-6f);
    rdiff[0] = diff[0] / den;
    rdiff[1] = diff[1] / den;
    rdiff[2] = diff[2] / den;
    rdiff[3] = d3[0] * nb[0] + d3[1] * nb[1] + d3[2] * nb[2];
  }
  if (tid == 0) {
    for (int s = 0; s < kMaxStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, NWG * kWgWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the warpgroup's first pass of features (step 1) is in flight across the
  // set-up
  const bf16* feat = static_cast<const bf16*>(a.nb_feat) + static_cast<size_t>(n0) * K * F;
  const int pass = min(kWgRows, (kWgRows * a.lde - 16) / F);   // + the shift and a read ahead
  if (wt == 0) {
    mbar_init(feat_bar + wg, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    FeaturePass(feat, EMB, F, 0, min(kWgRows, pass), rows_valid).issue(feat_bar + wg);
  }
  // ray-diff MLP weights [rd_w1 | rd_b1 | rd_w2 | rd_b2] (f32), for the CTA
  float* w1s = RDW;
  float* b1s = w1s + 4 * RD1;
  float* w2s = b1s + RD1;
  float* b2s = w2s + RD1 * RD2;
  for (int i = tid; i < 4 * RD1; i += NWG * kWgThreads) cp_async4(w1s + i, a.rd_w1 + i);
  for (int i = tid; i < RD1; i += NWG * kWgThreads) cp_async4(b1s + i, a.rd_b1 + i);
  for (int i = tid; i < RD1 * RD2; i += NWG * kWgThreads) cp_async4(w2s + i, a.rd_w2 + i);
  for (int i = tid; i < RD2; i += NWG * kWgThreads) cp_async4(b2s + i, a.rd_b2 + i);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < a.nst && s < ring.total; ++s) ring.fill(s, s);
  // EMB row: [off(3) | sin(3NF) | cos(3NF) | rdfc(RD2) | 0], each block on
  // a whole k-step (zeros between), for fc0's block sums
  const int off_col = 0;
  const int sin_col = kKStepB;
  const int trig = (3 * NF + kKStepB - 1) / kKStepB * kKStepB;
  const int cos_col = sin_col + trig;
  const int rd_col = cos_col + trig;
  const CoreTile at{};
  const bf16* mv = static_cast<const bf16*>(a.mv);

  // 1. the neighbour features of the warpgroup's samples into the CoreTile
  //    FEAT, in passes of up to `pass` rows: each pass's block (contiguous
  //    in device memory) bulk-copied into the embedding's region, free until
  //    step 2 (FeaturePass; the first pass was issued at the start), then
  //    moved by stage_features; the embedding zeroed
  for (int r0 = 0, ph = 0; r0 < kWgRows; r0 += pass, ph ^= 1) {
    const int r1 = min(kWgRows, r0 + pass);
    const FeaturePass fp(feat, EMB, F, r0, r1, rows_valid);
    if (wt == 0 && r0 > 0) {
      fence_async_smem();   // the previous pass's reads of the region come first
      fp.issue(feat_bar + wg);
    }
    const bf16* src = fp.src;
    bf16* SX = fp.SX;
    const int n = fp.n, head = fp.head, body = fp.body;
    if (wt < head) SX[wt] = src[wt];
    if (wt < n - head - body) SX[head + body + wt] = src[head + body + wt];
    mbar_wait(feat_bar + wg, ph);
    bar_wg(wg);
    stage_features(FEAT, SX, F, 2 * a.ks_f, r0, r1, rows_valid, wt);
    bar_wg(wg);
  }
  for (int i = wt; i < kWgRows * a.ks_e * kKStepB / 8; i += kWgThreads)
    reinterpret_cast<uint4*>(EMB)[i] = make_uint4(0u, 0u, 0u, 0u);
  bar_wg(wg);

  // 2. two threads a row: the offsets and rdiff (computed above), half of
  //    the ray-diff MLP's hidden layer h each, parked in the row's sin
  //    columns (RD1 <= 2 trig) until the embedding is written
  {
    const int r = gr;
    const int half = wt / kWgRows;
    if (half == 0) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        EMB[at(r, off_col + d)] = from_f<bf16>(off[d]);
        OFF[r * 4 + d] = off[d];
      }
    }
    // bf16 inputs and weights, f32 sums, then bf16(product) + bf16(bias)
#pragma unroll
    for (int i = 0; i < 4; ++i) rdiff[i] = rnd<bf16>(rdiff[i]);
    const int mh = (RD1 + 1) / 2;
    for (int m = half * mh; m < min(RD1, (half + 1) * mh); ++m) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) s = fmaf(rdiff[i], rnd<bf16>(w1s[i * RD1 + m]), s);
      EMB[at(r, sin_col + m)] = from_f<bf16>(leaky_b(rnd<bf16>(rnd<bf16>(s) + rnd<bf16>(b1s[m]))));
    }
  }
  bar_wg(wg);
  // 3. the ray-diff MLP's output layer: one warp a row (four rows at a
  //    time), lane n < RD2 holds column n of rd_w2 in registers (zero from
  //    RD1 on, where the sin block holds zeros)
  {
    float w2c[kMaxRd];
#pragma unroll
    for (int m = 0; m < kMaxRd; ++m)
      w2c[m] = rnd<bf16>((m < RD1 && lane < RD2) ? w2s[m * RD2 + lane] : 0.f);
    const float b2c = rnd<bf16>(lane < RD2 ? b2s[lane] : 0.f);
    const int chunks = (RD1 + 7) / 8;
    for (int r = ww; r < kWgRows; r += 4 * kWgWarps) {
      // h[m] for m < 8 chunks (zero from RD1 on, as w2c): 16-byte chunks
      // of the row's sin block
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kMaxRd / 8; ++i) {
        if (i >= chunks) break;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          uint32_t hw[4];
          words(*reinterpret_cast<const uint4*>(EMB + at(r + u * kWgWarps, sin_col + 8 * i)), hw);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[u] = fmaf(lo_f(hw[e]), w2c[8 * i + 2 * e], s[u]);
            s[u] = fmaf(hi_f(hw[e]), w2c[8 * i + 2 * e + 1], s[u]);
          }
        }
      }
      if (lane < RD2) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          EMB[at(r + u * kWgWarps, rd_col + lane)] =
              from_f<bf16>(leaky_b(rnd<bf16>(rnd<bf16>(s[u]) + b2c)));
      }
    }
  }
  bar_wg(wg);
  // 4. frequency embedding (f32 phases, accurate sincosf), one warp a row
  //    (two rows at a time)
  for (int r = ww; r < kWgRows; r += 2 * kWgWarps) {
    for (int j = lane; j < 3 * NF; j += 32) {
      const float f = __ldg(a.freqs + j / 3);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float sn, cs;
        sincosf(OFF[(r + u * kWgWarps) * 4 + j % 3] * f, &sn, &cs);
        EMB[at(r + u * kWgWarps, sin_col + j)] = from_f<bf16>(sn);
        EMB[at(r + u * kWgWarps, cos_col + j)] = from_f<bf16>(cs);
      }
    }
  }
  fence_async_smem();
  bar_wg(wg);

  // 5. base_mlp and the value projection (fc0 over the CoreTile [features |
  //    embedding]); once fc0 has read it, its region holds A, B and Q
  const int ks_trig = trig / kKStepB;
  const int nks_c = a.ks_f + a.ks_e;   // blocks end after [feat | off | sin | cos | rdfc]
  const WideOperand x_in{FEAT, nks_c,
                         (1u << (a.ks_f - 1)) | (1u << a.ks_f) | (1u << (a.ks_f + ks_trig)) |
                             (1u << (a.ks_f + 2 * ks_trig)) | (1u << (nks_c - 1))};
  constexpr int kKs = kHd / kKStepB;
  product_wide<true>(x_in, a.ks0p, ring, A, a.b0, W, true, true, wg, ww, lane);
  // mv of the warpgroup's samples into Q (K > 1), in flight during fc1..k
  constexpr int kPer = 2;   // bf16 of one 4-byte copy (W even)
  for (int t = ww; t < a.q_rows; t += kWgWarps) {
    const bf16* mr = mv + static_cast<size_t>(n0 + t) * W;
    for (int c = kPer * lane; c < kHd; c += 32 * kPer) {
      if (t < t_valid && c < W) {
        cp_async4(Q + t * kLdhB + c, mr + c);
      } else {
        Q[t * kLdhB + c] = from_f<bf16>(0.f);
        Q[t * kLdhB + c + 1] = from_f<bf16>(0.f);
      }
    }
  }
  cp_async_commit();
  bar_wg(wg);
  product_wide<false>(core_operand(A), kKs, ring, B, a.b1, W, true, false, wg, ww, lane);
  bar_wg(wg);
  product_wide<false>(core_operand(B), kKs, ring, A, a.b2, W, true, false, wg, ww, lane);  // pf
  bar_wg(wg);
  product_wide<false>(core_operand(A), kKs, ring, B, nullptr, 0, false, false, wg, ww, lane);  // v
  const bf16* mv0 = mv + static_cast<size_t>(n0) * W;

  if (K == 1) {
    // 6'. one neighbour: o = v; y = v @ wfc; residual from device memory
    bar_wg(wg);
    product_wide<false>(core_operand(B), kKs, ring, A, nullptr, 0, false, false, wg, ww, lane);
    bar_wg(wg);
    layer_norm(a, A, at, mv0, W, n0, t_valid, ww, kWgWarps, lane);
    return;
  }

  // 6. keys (over pf, in place) and queries (16-row tiles of mv, mma.sync)
  product_wide<false>(core_operand(A), kKs, ring, A, nullptr, 0, false, true, wg, ww, lane);  // k
  cp_async_wait<0>();
  bar_wg(wg);
  float acc[4][4][4];
  const int mt_q = a.q_rows / 16;
  gemm_bf<4>(acc, tile_operand(static_cast<const bf16*>(Q), kLdhB), mt_q, kKs,
                                 ring, ww, lane);
  bar_wg(wg);   // every warp has read mv
  store_bf<4>(acc, Q, mt_q, nullptr, 0, false, rnd<bf16>(a.q_scale), ww, lane);
  bar_wg(wg);

  // 7. Lq=1 attention over the K neighbours
  attention_wide(Q, A, B, K, t_valid, ww, lane);
  bar_wg(wg);

  // 8. output projection, residual and LayerNorm
  gemm_bf<4>(acc, tile_operand(static_cast<const bf16*>(Q), kLdhB), mt_q, kKs,
                                 ring, ww, lane);
  bar_wg(wg);   // every warp has read o
  store_bf<4>(acc, Q, mt_q, nullptr, 0, false, 1.f, ww, lane);
  bar_wg(wg);
  layer_norm(a, Q, RowMajor{kLdhB}, mv0, W, n0, t_valid, ww, kWgWarps, lane);
}

// ---- bf16 cluster tiles: launches too small for the wide tiles ------------
//
// A launch of a few thousand rows (the query's K = 1 launch over N = 1024
// keypoints; small K > 1 launches) fills the card with wide tiles only at
// a CTA an SM or less, and a wide CTA's chain (~0.047 ms) then sets the
// launch's time. The old 16/32-row CTAs each streamed every weight
// through a ring from a buffer the wrapper packed first (three small
// kernels, ~0.011 ms a launch). Here a thread-block cluster of
// kClusterCtas CTAs holds the weights once, resident: CTA c keeps the
// 32-column block c of every product's k-steps, rounded to bf16 by its own
// threads from the f32 parameters while the prologue's copies are in
// flight (load_share), so the wrapper packs nothing. Each CTA owns its own
// 16 or 32 rows (whole samples) and computes every column of them, so no
// activation leaves the CTA: its 8 warps own 16 output columns each and
// read their B fragments, 16 bytes a lane in the ring's layout, from the
// CTA that holds them through distributed shared memory
// (ld.shared::cluster, kClPf k-steps in flight; a 32-row CTA reuses each
// fragment for both m-tiles). One cluster barrier once every CTA's share
// is in place, one before a CTA leaves. The prologue spreads a row over
// 256 / rows threads with its geometry loads in flight across the set-up,
// the attention runs a warp a sample, and the LayerNorm's residual is
// staged in shared memory. The rounding is kernel_agg's (products to
// bf16, fc0's five block sums, the softmax weights), with f32 sums in
// another order.
// Measured on the card (PERF.md, tools/compare_fused_agg.py): a launch
// runs fastest while its clusters hold at most ~120 CTAs, about one an SM
// (16 rows at K = 1 and N = 1024, 1.31x the old 16-row tile; 32 rows at
// K = 8 and N = 256 or 384, 1.04-1.07x the old tiles). At 128 CTAs a few
// SMs take two, and a CTA shares its SM at ~1.5x the time, so the old
// tiles, cheap enough to run two an SM, stay ahead there (K = 8 and N =
// 512: 0.85x); from ~1.5 CTAs an SM the wide tiles take over
// (ops/fused_agg.py, tile_plan). Measured and dropped: tiles fed from the packed buffer,
// clusters of 2, and clusters sharing one ring whose stages are multicast
// to every CTA (TMA .multicast::cluster; each slot's release by every CTA
// set the pace).
constexpr int kClusterCtas = 4;      // CTAs a cluster (clusters of 2 measured slower)
constexpr uint32_t kClChunk = kTileBytesB / kClusterCtas;   // bytes a CTA holds of a k-step
constexpr int kClWarps = 8;
constexpr int kClThreads = kClWarps * 32;
constexpr int kClNj = 2;             // n-tiles of 8 columns a warp holds: 16 columns
constexpr int kClHeader = 128;       // bytes of a cluster CTA's barriers
constexpr int kClPf = 8;             // k-steps of weights in flight a warp

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// the shared::cluster address of p (a shared variable of this CTA) in CTA rank
__device__ __forceinline__ uint32_t cluster_addr(const void* p, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ uint4 ld_cluster(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// every thread of the cluster's CTAs: what each wrote before is visible to
// all after
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// This CTA's share of the weights (its cluster rank's 32-column block),
// rounded to bf16 from the f32 parameters as pack_agg_weights rounds them
// (to nearest even) and placed as it places them: k-step ks of the share
// (the products in the ring's order, the key and query products only with
// K > 1) holds, for half jh, lane (g, t)'s 16 bytes at 512 jh + 16 lane:
// b0 and b1 of n-tiles jl = 0, 1, n = 32 rank + 16 jh + 8 jl + g, k = 16 kp + 2t (+1; +8, +9) of the product's
// padded k (fc0's rows as ring_widths pads them, zero where no weight is).
// A warp a (k-step, block, half), kBatch of them with their loads in
// flight. (Spreading the rounds over the prologue's steps, so that their
// latency would hide behind it, was measured slower: the prologue's own
// loads queued behind them.)
__device__ void load_share(const Args& a, unsigned char* WS, uint32_t rank, int warp, int lane) {
  constexpr int kBatch = 4;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int F = a.F, W = a.W, NF = a.NF;
  const int fp = kKStepB * a.ks_f;                         // fc0's first embedding row
  const int trig = (3 * NF + kKStepB - 1) / kKStepB * kKStepB;
  const int tasks = a.cl_ks * 2;
  for (int i0 = warp * kBatch; i0 < tasks; i0 += kClWarps * kBatch) {
    float v[kBatch][8];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b;
      const int ks = i / 2;
      const int jh = i - ks * 2;
      // the product and its k-step
      int p = kFc0, kp = ks;
      if (ks >= a.ks0p) {
        const int q = (ks - a.ks0p) / (kHd / kKStepB);
        kp = ks - a.ks0p - q * (kHd / kKStepB);
        p = a.K > 1 ? kFc1 + q : (q < 3 ? kFc1 + q : kWfc);
      }
      const int cols = (p == kWv || p == kWk || p == kWq) ? kHd : W;
      const float* src = a.wmat[p];
      const int n0 = 32 * static_cast<int>(rank) + 16 * jh + g;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = kKStepB * kp + 2 * t + (e & 1) + 8 * (e >> 1);
        int row = k;
        if (p == kFc0) {   // fc0's padded k -> the parameter's row
          const int c = k - fp;
          row = k < fp ? (k < F ? k : -1)
                : c < 3 ? F + c
                : c >= kKStepB && c < kKStepB + 3 * NF ? F + 3 + c - kKStepB
                : c >= kKStepB + trig && c < kKStepB + trig + 3 * NF ? F + 3 + 3 * NF + c - kKStepB - trig
                : c >= kKStepB + 2 * trig && c < kKStepB + 2 * trig + a.RD2
                    ? F + 3 + 6 * NF + c - kKStepB - 2 * trig
                    : -1;
        } else if (k >= (p == kWfc ? kHd : W)) {
          row = -1;
        }
        const bool ok = i < tasks && row >= 0;
        v[b][e] = ok && n0 < cols ? __ldg(src + static_cast<size_t>(row) * cols + n0) : 0.f;
        v[b][4 + e] = ok && n0 + 8 < cols ? __ldg(src + static_cast<size_t>(row) * cols + n0 + 8) : 0.f;
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b;
      if (i >= tasks) break;
      const int ks = i / 2;
      const int jh = i - ks * 2;
      const uint4 w = make_uint4(bf2_bits(__floats2bfloat162_rn(v[b][0], v[b][1])),
                                 bf2_bits(__floats2bfloat162_rn(v[b][2], v[b][3])),
                                 bf2_bits(__floats2bfloat162_rn(v[b][4], v[b][5])),
                                 bf2_bits(__floats2bfloat162_rn(v[b][6], v[b][7])));
      *reinterpret_cast<uint4*>(WS + ks * kClChunk + jh * 512 + lane * 16) = w;
    }
  }
}

// acc = X[16 mt .. +16, :] @ Wkn[:, 16 w .. 16 w + 16] for mt < mt_n (all
// MT when kFull), nks k-steps, k-step ks of this warp's weights at the
// cluster address wsrc + ks * kClChunk (16 bytes a lane: b0 and b1 of its
// two n-tiles). kTwo (fc0): the product is the bf16 sum of the products of
// its blocks [feat | off | sin | cos | rdfc], each rounded to bf16, as the
// Pallas kernel sums them (the blocks are padded to whole k-steps).
template <int MT, bool kFull, bool kTwo>
__device__ __forceinline__ void gemm_cl(float (&acc)[MT][kClNj][4], const Operand<bf16>& x,
                                        int mt_n, int nks, uint32_t wsrc, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < kClNj; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
  uint32_t tot[kTwo ? MT : 1][kClNj][2];
  int blk = 0;   // blocks folded so far
  uint4 bq[kClPf];
#pragma unroll
  for (int i = 0; i < kClPf; ++i)
    if (i < nks) bq[i] = ld_cluster(wsrc + i * kClChunk);
  for (int s = 0; s < nks; s += kClPf) {
#pragma unroll
    for (int i = 0; i < kClPf; ++i) {
      const int ks = s + i;
      if (ks < nks) {
        const uint4 bw = bq[i];
        if (ks + kClPf < nks) bq[i] = ld_cluster(wsrc + (ks + kClPf) * kClChunk);
        const bool first = !kTwo || ks < x.nks1;
        const bf16* base = first ? x.x1 + ks * kKStepB : x.x2 + (ks - x.nks1) * kKStepB;
        const int ld = first ? x.ld1 : x.ld2;
        const int kv = x.kv1 - ks * kKStepB;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (kFull || mt < mt_n) {
            const bf16* xr = base + (16 * mt + g) * ld + 2 * t;
            uint32_t a[4];
            if (kTwo && first) {
              a[0] = ld_pair_masked(xr, 2 * t, kv);
              a[1] = ld_pair_masked(xr + 8 * ld, 2 * t, kv);
              a[2] = ld_pair_masked(xr + 8, 2 * t + 8, kv);
              a[3] = ld_pair_masked(xr + 8 * ld + 8, 2 * t + 8, kv);
            } else {
              a[0] = ld_pair(xr);
              a[1] = ld_pair(xr + 8 * ld);
              a[2] = ld_pair(xr + 8);
              a[3] = ld_pair(xr + 8 * ld + 8);
            }
            mma_bf16(acc[mt][0], a, bw.x, bw.y);
            mma_bf16(acc[mt][1], a, bw.z, bw.w);
          }
        }
        if constexpr (kTwo) {
          const int end = blk == 0 ? x.nks1 : blk < 4 ? x.blk_end[blk - 1] : x.nks_c;
          if (ks + 1 == end) {
            fold_block<MT, kClNj>(acc, tot, blk == 0);
            ++blk;
          }
        }
      }
    }
  }
  if constexpr (kTwo) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < kClNj; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 tf =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&tot[mt][j][h]));
          acc[mt][j][2 * h] = tf.x;
          acc[mt][j][2 * h + 1] = tf.y;
        }
  }
}

// One product of a cluster tile, Y = act(X @ Wkn + bias) over all MT
// m-tiles; in_place: Y overwrites the operand's region, so every warp must
// have read it first.
template <int MT, bool kTwo>
__device__ __forceinline__ void product_cl(const Operand<bf16>& x, int nks, uint32_t wsrc,
                                           bf16* Y, const float* bias, int nb, bool act,
                                           bool in_place, int warp, int lane) {
  float acc[MT][kClNj][4];
  gemm_cl<MT, true, kTwo>(acc, x, MT, nks, wsrc, lane);
  if (in_place) __syncthreads();
  store_bf<MT, kClNj>(acc, Y, MT, bias, nb, act, 1.f, warp, lane);
}

// q . k of one key over a lane's 4 dimensions of its head, each product
// rounded to bf16 (as attention<bf16> rounds it), then summed over the 8
// lanes of the head (an xor butterfly: every lane gets the same sum)
__device__ __forceinline__ float head_score_cl(uint2 q, const bf16* krow) {
  const uint2 kw = *reinterpret_cast<const uint2*>(krow);
  const uint32_t p0 = bf2_bits(__floats2bfloat162_rn(lo_f(q.x) * lo_f(kw.x), hi_f(q.x) * hi_f(kw.x)));
  const uint32_t p1 = bf2_bits(__floats2bfloat162_rn(lo_f(q.y) * lo_f(kw.y), hi_f(q.y) * hi_f(kw.y)));
  float s = (lo_f(p0) + hi_f(p0)) + (lo_f(p1) + hi_f(p1));
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// Lq=1 attention of the cluster tiles, rounding as attention<bf16>: one
// warp a sample, lane (h, d) = (lane / 8, lane % 8) holding dimensions
// 4d .. 4d + 3 of head h; the max of all K scores first, then exp(s - max)
// summed in f32 and rounded before it meets v, o = bf16(sum * bf16(1 /
// den)) written over q. A warp reads one 256-byte row of K or V at a time.
__device__ __forceinline__ void attention_cl(bf16* Q, const bf16* Kt, const bf16* Vt, int K,
                                             int t_valid, int warp, int lane) {
  const int col = (lane >> 3) * kDk + 4 * (lane & 7);
  for (int t = warp; t < t_valid; t += kClWarps) {
    const uint2 q = *reinterpret_cast<const uint2*>(Q + t * kLdhB + col);
    const bf16* krow = Kt + t * K * kLdhB + col;
    float m = -3.402823466e38f;
    for (int k = 0; k < K; ++k) m = fmaxf(m, head_score_cl(q, krow + k * kLdhB));
    float den = 0.f;
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < K; ++k) {
      const float e = expf(head_score_cl(q, krow + k * kLdhB) - m);
      den += e;
      const float w = rnd<bf16>(e);
      const uint2 vw = *reinterpret_cast<const uint2*>(Vt + (t * K + k) * kLdhB + col);
      o[0] = fmaf(w, lo_f(vw.x), o[0]);
      o[1] = fmaf(w, hi_f(vw.x), o[1]);
      o[2] = fmaf(w, lo_f(vw.y), o[2]);
      o[3] = fmaf(w, hi_f(vw.y), o[3]);
    }
    const float r = rnd<bf16>(1.f / den);
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(Q + t * kLdhB + col);
    dst[0] = __floats2bfloat162_rn(o[0] * r, o[1] * r);
    dst[1] = __floats2bfloat162_rn(o[2] * r, o[3] * r);
  }
}

// The bf16 instantiation at cluster tiles of 16 MT rows (T samples a CTA,
// CTA b holding samples [b T, b T + T)), kClusterCtas CTAs a cluster
// sharing the weights; see the note above. The prologue: the geometry loads in flight
// across the set-up, 256 / rows threads a row for the ray-diff MLP's hidden
// layer, up to four rows at a time a warp for its output layer.
template <int MT>
__global__ void __launch_bounds__(kClThreads, 2) fused_agg_cluster(const Args a) {
  static_assert(MT == 1 || MT == 2, "cluster tiles hold 16 or 32 rows");
  constexpr int kRows = 16 * MT;
  constexpr int kParts = kClThreads / kRows;    // threads a row in the hidden layer
  constexpr int kKs = kHd / kKStepB;
  extern __shared__ __align__(128) float smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem);
  const int K = a.K, F = a.F, W = a.W, T = a.T, NF = a.NF, lde = a.lde;
  const int RD1 = a.RD1, RD2 = a.RD2;

  uint64_t* fbar = reinterpret_cast<uint64_t*>(base);
  unsigned char* WS = base + kClHeader;                                // [cl_ks, kClChunk]
  bf16* FEAT = reinterpret_cast<bf16*>(WS + a.cl_ks * kClChunk);         // [kRows, F] + pad; later A | B
  bf16* EMB = FEAT + a.feat_elems;                                     // [kRows, lde]
  bf16* MV = FEAT + a.region;                                          // [q_rows, kLdhB]
  bf16* Q = MV + a.q_rows * kLdhB;                                     // [q_rows, kLdhB] (K > 1)
  float* RDW = reinterpret_cast<float*>(Q + a.q_rows * kLdhB);         // ray-diff MLP weights
  float* OFF = RDW + a.rdw_floats;                                     // [kRows, 4] f32 offsets

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n0 = blockIdx.x * T;
  const int t_valid = max(0, min(T, a.N - n0));   // CTAs past N only hold weights
  const int rows_valid = t_valid * K;

  // the geometry of row gr, its loads in flight across the set-up
  const int gr = tid % kRows;
  float off[3] = {0.f, 0.f, 0.f};
  float rdiff[4] = {0.f, 0.f, 0.f, 0.f};
  if (gr < rows_valid) {
    const int tt = gr / K;
    const int n = n0 + tt;
    const size_t nk = static_cast<size_t>(n) * K + (gr - tt * K);
    const float sc = __ldg(a.scale);
    float d3[3], nb[3], diff[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      off[d] = (a.xyz[static_cast<size_t>(n) * 3 + d] - a.nb_xyz[nk * 3 + d]) / sc;
      d3[d] = a.dir[static_cast<size_t>(n) * a.dir_stride + d];
      nb[d] = a.nb_dir[nk * 4 + d];
      diff[d] = d3[d] - nb[d];
    }
    const float ss = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2];
    const float den = fmaxf(sqrtf(ss + 1e-12f), 1e-6f);
    rdiff[0] = diff[0] / den;
    rdiff[1] = diff[1] / den;
    rdiff[2] = diff[2] / den;
    rdiff[3] = d3[0] * nb[0] + d3[1] * nb[1] + d3[2] * nb[2];
  }

  // 1. the tile's neighbour features by bulk copy: the 16-byte-aligned
  //    body, the < 16 bytes at either end by hand, zeros after the valid
  //    rows; the embedding zeroed; then, with the copies in flight, this
  //    CTA's share of the weights
  const bf16* feat = static_cast<const bf16*>(a.nb_feat) + static_cast<size_t>(n0) * K * F;
  const int nfeat = rows_valid * F;
  const int head = min(static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(feat) & 15)) & 15) /
                                        sizeof(bf16)),
                       nfeat);
  const int body = (nfeat - head) & ~7;
  bf16* FX = FEAT + ((8 - head) & 7);
  if (tid == 0) {
    mbar_init(fbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(fbar, body * sizeof(bf16));
    if (body > 0) bulk_load(FX + head, feat + head, body * sizeof(bf16), fbar);
  }
  __syncthreads();
  if (tid < head) FX[tid] = feat[tid];
  if (tid < nfeat - head - body) FX[head + body + tid] = feat[head + body + tid];
  for (int i = nfeat + tid; i < kRows * F + kKStepB; i += kClThreads) FX[i] = from_f<bf16>(0.f);
  for (int i = tid; i < kRows * lde / 8; i += kClThreads)
    reinterpret_cast<uint4*>(EMB)[i] = make_uint4(0u, 0u, 0u, 0u);
  // ray-diff MLP weights [rd_w1 | rd_b1 | rd_w2 | rd_b2] (f32), then mv
  float* w1s = RDW;
  float* b1s = w1s + 4 * RD1;
  float* w2s = b1s + RD1;
  float* b2s = w2s + RD1 * RD2;
  for (int i = tid; i < 4 * RD1; i += kClThreads) cp_async4(w1s + i, a.rd_w1 + i);
  for (int i = tid; i < RD1; i += kClThreads) cp_async4(b1s + i, a.rd_b1 + i);
  for (int i = tid; i < RD1 * RD2; i += kClThreads) cp_async4(w2s + i, a.rd_w2 + i);
  for (int i = tid; i < RD2; i += kClThreads) cp_async4(b2s + i, a.rd_b2 + i);
  cp_async_commit();
  const bf16* mv = static_cast<const bf16*>(a.mv);
  for (int t = warp; t < a.q_rows; t += kClWarps) {
    const bf16* mr = mv + static_cast<size_t>(n0 + t) * W;
    for (int c = 2 * lane; c < kHd; c += 64) {
      if (t < t_valid && c < W) {
        cp_async4(MV + t * kLdhB + c, mr + c);
      } else {
        MV[t * kLdhB + c] = from_f<bf16>(0.f);
        MV[t * kLdhB + c + 1] = from_f<bf16>(0.f);
      }
    }
  }
  cp_async_commit();
  load_share(a, WS, cluster_rank(), warp, lane);
  cp_async_wait<1>();   // the MLP weights; mv may still be in flight
  __syncthreads();

  // EMB row: [off(3) | sin(3NF) | cos(3NF) | rdfc(RD2) | 0], each block on
  // a whole k-step (zeros between), for fc0's block sums
  const int sin_col = kKStepB;
  const int trig = (3 * NF + kKStepB - 1) / kKStepB * kKStepB;
  const int cos_col = sin_col + trig;
  const int rd_col = cos_col + trig;
  // 2. kParts threads a row: the offsets and rdiff (computed above), their
  //    share of the ray-diff MLP's hidden layer h, parked in the row's sin
  //    columns (RD1 <= 2 trig) until the embedding is written
  {
    const int part = tid / kRows;
    bf16* er = EMB + gr * lde;
    if (part == 0) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        er[d] = from_f<bf16>(off[d]);
        OFF[gr * 4 + d] = off[d];
      }
    }
    // bf16 inputs and weights, f32 sums, then bf16(product) + bf16(bias)
#pragma unroll
    for (int i = 0; i < 4; ++i) rdiff[i] = rnd<bf16>(rdiff[i]);
    const int mh = (RD1 + kParts - 1) / kParts;
    for (int m = part * mh; m < min(RD1, (part + 1) * mh); ++m) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) s = fmaf(rdiff[i], rnd<bf16>(w1s[i * RD1 + m]), s);
      er[sin_col + m] = from_f<bf16>(leaky_b(rnd<bf16>(rnd<bf16>(s) + rnd<bf16>(b1s[m]))));
    }
  }
  __syncthreads();
  // 3. the ray-diff MLP's output layer: one warp a row, four rows at a time
  //    (rows r, r + 8, r + 16, r + 24), lane n < RD2 holding column n of
  //    rd_w2 in registers (zero from RD1 on, where the sin block holds zeros)
  {
    float w2c[kMaxRd];
#pragma unroll
    for (int m = 0; m < kMaxRd; ++m)
      w2c[m] = rnd<bf16>((m < RD1 && lane < RD2) ? w2s[m * RD2 + lane] : 0.f);
    const float b2c = rnd<bf16>(lane < RD2 ? b2s[lane] : 0.f);
    const int chunks = (RD1 + 7) / 8;
    constexpr int kAtOnce = kRows / kClWarps < 4 ? kRows / kClWarps : 4;
    for (int r = warp; r < kRows; r += kAtOnce * kClWarps) {
      float s[kAtOnce];
#pragma unroll
      for (int u = 0; u < kAtOnce; ++u) s[u] = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxRd / 8; ++i) {
        if (i >= chunks) break;
#pragma unroll
        for (int u = 0; u < kAtOnce; ++u) {
          uint32_t hw[4];
          words(*reinterpret_cast<const uint4*>(EMB + (r + u * kClWarps) * lde + sin_col + 8 * i),
                hw);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[u] = fmaf(lo_f(hw[e]), w2c[8 * i + 2 * e], s[u]);
            s[u] = fmaf(hi_f(hw[e]), w2c[8 * i + 2 * e + 1], s[u]);
          }
        }
      }
      if (lane < RD2) {
#pragma unroll
        for (int u = 0; u < kAtOnce; ++u)
          EMB[(r + u * kClWarps) * lde + rd_col + lane] =
              from_f<bf16>(leaky_b(rnd<bf16>(rnd<bf16>(s[u]) + b2c)));
      }
    }
  }
  __syncthreads();
  // 4. frequency embedding (f32 phases, accurate sincosf), a (row, phase) a
  //    thread
  {
    const int nj = 3 * NF;
    for (int i = tid; i < kRows * nj; i += kClThreads) {
      const int r = i / nj;
      const int j = i - r * nj;
      float sn, cs;
      sincosf(OFF[r * 4 + j % 3] * __ldg(a.freqs + j / 3), &sn, &cs);
      EMB[r * lde + sin_col + j] = from_f<bf16>(sn);
      EMB[r * lde + cos_col + j] = from_f<bf16>(cs);
    }
  }
  cp_async_wait<0>();
  mbar_wait(fbar, 0);
  cluster_sync();   // every CTA's share of the weights is in place (and this CTA's inputs)

  // 5. base_mlp and the value projection; once fc0 has read x_in, its
  //    region holds A and B, two [kRows, 128] tiles. Warp w reads the
  //    weights of its 16 columns from CTA w / 2, which holds their
  //    32-column block.
  bf16* A = FEAT;
  bf16* B = FEAT + kRows * kLdhB;
  const Operand<bf16> opA = tile_operand(static_cast<const bf16*>(A), kLdhB);
  const Operand<bf16> opB = tile_operand(static_cast<const bf16*>(B), kLdhB);
  uint32_t wsrc = cluster_addr(WS + (warp & 1) * 512 + lane * 16, warp >> 1);
  const int ks_trig = trig / kKStepB;
  const Operand<bf16> x_in{FX, F, F, a.ks_f, EMB, lde, a.ks_f + a.ks_e,
                           {a.ks_f + 1, a.ks_f + 1 + ks_trig, a.ks_f + 1 + 2 * ks_trig}};
  product_cl<MT, true>(x_in, x_in.nks_c, wsrc, A, a.b0, W, true, true, warp, lane);
  wsrc += a.ks0p * kClChunk;
  __syncthreads();
  product_cl<MT, false>(opA, kKs, wsrc, B, a.b1, W, true, false, warp, lane);
  wsrc += kKs * kClChunk;
  __syncthreads();
  product_cl<MT, false>(opB, kKs, wsrc, A, a.b2, W, true, false, warp, lane);   // pf
  wsrc += kKs * kClChunk;
  __syncthreads();
  product_cl<MT, false>(opA, kKs, wsrc, B, nullptr, 0, false, false, warp, lane);   // v
  wsrc += kKs * kClChunk;

  if (K == 1) {
    // 6'. one neighbour: o = v; y = v @ wfc; residual mv
    __syncthreads();
    product_cl<MT, false>(opB, kKs, wsrc, A, nullptr, 0, false, false, warp, lane);
    __syncthreads();
    layer_norm(a, A, RowMajor{kLdhB}, MV, kLdhB, n0, t_valid, warp, kClWarps, lane);
    cluster_sync();   // no CTA leaves while another may read its weights
    return;
  }

  // 6. keys (over pf, in place) and queries (the 16-row tiles of mv)
  product_cl<MT, false>(opA, kKs, wsrc, A, nullptr, 0, false, true, warp, lane);   // k
  wsrc += kKs * kClChunk;
  float acc[MT][kClNj][4];
  const int mt_q = a.q_rows / 16;
  gemm_cl<MT, false, false>(acc, tile_operand(static_cast<const bf16*>(MV), kLdhB), mt_q, kKs,
                            wsrc, lane);
  wsrc += kKs * kClChunk;
  store_bf<MT, kClNj>(acc, Q, mt_q, nullptr, 0, false, rnd<bf16>(a.q_scale), warp, lane);
  __syncthreads();

  // 7. Lq=1 attention over the K neighbours
  attention_cl(Q, A, B, K, t_valid, warp, lane);
  __syncthreads();

  // 8. output projection, residual and LayerNorm
  gemm_cl<MT, false, false>(acc, tile_operand(static_cast<const bf16*>(Q), kLdhB), mt_q, kKs,
                            wsrc, lane);
  __syncthreads();   // every warp has read o
  store_bf<MT, kClNj>(acc, Q, mt_q, nullptr, 0, false, 1.f, warp, lane);
  __syncthreads();
  layer_norm(a, Q, RowMajor{kLdhB}, MV, kLdhB, n0, t_valid, warp, kClWarps, lane);
  cluster_sync();   // no CTA leaves while another may read its weights
}

// the k-steps of the products a launch runs: fc0's, then six [128, 128]
// products' (four with K = 1: no keys or queries)
int cluster_ks(int ks0p, int K) { return ks0p + (K > 1 ? 6 : 4) * (kHd / kKStepB); }

struct Plan {
  int ks_f, ks_e, ks0p, lde, feat_elems, region, q_rows, rdw_floats, off_floats, nst;
  size_t smem;
};

// Shared memory of the f32 tiles: the ring, the x_in region (features
// [rows, F] at stride F plus one MMA depth of padding and < 16 bytes of
// alignment shift, then the embedding [rows, lde]; later the A and B
// tiles), mv and q/o ([q_rows, kLdh] each, K > 1); the ray-diff MLP
// weights and the barriers. A tile aims at two CTAs per SM, so that one
// CTA's CUDA-core phases overlap the other's products.
bool make_plan(int rows, int T, int K, int F, int NF, int RD1, int RD2, Plan* p) {
  constexpr int vec = 4;   // floats of 16 bytes
  p->ks_f = (F + kKStep - 1) / kKStep;
  p->ks_e = (3 + 6 * NF + RD2 + kKStep - 1) / kKStep;
  p->ks0p = (p->ks_f + p->ks_e + kStageK - 1) / kStageK * kStageK;
  p->lde = kKStep * p->ks_e + Elem<float>::kLdePad;
  p->feat_elems = (rows * F + kKStep + vec - 1 + vec - 1) / vec * vec;   // + the alignment shift
  const int x_in = p->feat_elems + rows * p->lde;
  p->region = x_in > 2 * rows * kLdh ? x_in : 2 * rows * kLdh;
  p->region = (p->region + vec - 1) / vec * vec;
  p->q_rows = K > 1 ? (T + 15) / 16 * 16 : 0;
  p->rdw_floats = (4 * RD1 + RD1 + RD1 * RD2 + RD2 + 3) / 4 * 4;
  p->off_floats = 0;
  const size_t rest =
      sizeof(float) * (static_cast<size_t>(p->region) + 2 * static_cast<size_t>(p->q_rows) * kLdh) +
      sizeof(float) * static_cast<size_t>(p->rdw_floats) + (2 * kMaxStages + 2) * sizeof(uint64_t);
  size_t cap = kSmemMax;
  if (rest + 2 * kStageBytes <= static_cast<size_t>(kSmemHalf)) cap = kSmemHalf;
  if (rest + 2 * kStageBytes > cap) return false;
  const size_t fit = (cap - rest) / kStageBytes;
  p->nst = static_cast<int>(fit < kMaxStages ? fit : kMaxStages);
  p->smem = rest + static_cast<size_t>(p->nst) * kStageBytes;
  return true;
}

// The wide tiles' plan: per warpgroup the x_in region (the features and the
// embedding as CoreTiles [64, 16 ks_f] and [64, 16 ks_e]; later A, B and Q
// [q_rows, kLdhB]) and the f32 offsets; the ray-diff MLP weights once; the
// ring gets what is left of the CTA's share of the SM: 4 / NWG CTAs an SM
// where two stages still fit, else fewer (64 rows: three, 128 rows: two).
bool make_plan_wide(int nwg, int T, int K, int F, int NF, int RD1, int RD2, Plan* p) {
  if (K > kWgRows || T != nwg * (kWgRows / K)) return false;
  p->ks_f = (F + kKStepB - 1) / kKStepB;
  const int emb = kKStepB + 2 * ((3 * NF + kKStepB - 1) / kKStepB * kKStepB) + RD2;
  p->ks_e = (emb + kKStepB - 1) / kKStepB;
  if (p->ks_f + p->ks_e > 32) return false;   // fc0's block ends are a 32-bit mask
  p->ks0p = (p->ks_f + p->ks_e + kStageK - 1) / kStageK * kStageK;
  p->lde = kKStepB * p->ks_e;
  p->feat_elems = kWgRows * kKStepB * p->ks_f;   // the features' CoreTile
  const int x_in = p->feat_elems + kWgRows * p->lde;
  p->q_rows = K > 1 ? (T / nwg + 15) / 16 * 16 : 0;
  const int tiles = 2 * kWgRows * kHd + p->q_rows * kLdhB;
  p->region = ((x_in > tiles ? x_in : tiles) + 63) / 64 * 64;
  p->rdw_floats = (4 * RD1 + RD1 + RD1 * RD2 + RD2 + 31) / 32 * 32;
  p->off_floats = 4 * kWgRows;
  const size_t rest = kWideHeader + sizeof(float) * p->rdw_floats +
                      static_cast<size_t>(nwg) * (2 * p->region + sizeof(float) * p->off_floats);
  for (int per_sm = 4 / nwg; per_sm >= 1; --per_sm) {
    const size_t cap = per_sm == 1 ? kSmemMax : (kSmemMax + 1024) / per_sm - 1024;
    if (rest + 2 * kStageBytes > cap) continue;
    const size_t fit = (cap - rest) / kStageBytes;
    p->nst = static_cast<int>(fit < kMaxStages ? fit : kMaxStages);
    p->smem = rest + static_cast<size_t>(p->nst) * kStageBytes;
    return true;
  }
  return false;
}

// The cluster tiles' plan: the CTA's share of the weights (the k-steps a
// launch runs, kClChunk bytes each), then the x_in region (later A and B),
// mv and q/o, the ray-diff MLP weights and the f32 offsets, no ring.
bool make_plan_cl(int rows, int T, int K, int F, int NF, int RD1, int RD2, Plan* p) {
  if (T * K > rows || T < 1) return false;
  p->ks_f = (F + kKStepB - 1) / kKStepB;
  const int emb = kKStepB + 2 * ((3 * NF + kKStepB - 1) / kKStepB * kKStepB) + RD2;
  p->ks_e = (emb + kKStepB - 1) / kKStepB;
  p->ks0p = (p->ks_f + p->ks_e + kStageK - 1) / kStageK * kStageK;
  p->lde = kKStepB * p->ks_e + Elem<bf16>::kLdePad;
  p->feat_elems = (rows * F + kKStepB + 7 + 7) / 8 * 8;   // + the alignment shift
  const int x_in = p->feat_elems + rows * p->lde;
  p->region = ((x_in > 2 * rows * kLdhB ? x_in : 2 * rows * kLdhB) + 7) / 8 * 8;
  p->q_rows = (T + 15) / 16 * 16;
  p->rdw_floats = (4 * RD1 + RD1 + RD1 * RD2 + RD2 + 3) / 4 * 4;
  p->off_floats = 4 * rows;
  p->nst = 0;
  p->smem = kClHeader + static_cast<size_t>(cluster_ks(p->ks0p, K)) * kClChunk +
            2 * (static_cast<size_t>(p->region) + 2 * static_cast<size_t>(p->q_rows) * kLdhB) +
            sizeof(float) * static_cast<size_t>(p->rdw_floats + p->off_floats);
  return p->smem <= static_cast<size_t>(kSmemMax);
}

// bf16: 16/32-row cluster tiles and 64/128-row wide tiles; f32: 16, 32 and
// 64 rows
bool plan_for(int rows, int T, int K, int F, int NF, int RD1, int RD2, bool bf, Plan* p) {
  if (bf && rows < kWgRows)
    return (rows == 16 || rows == 32) && make_plan_cl(rows, T, K, F, NF, RD1, RD2, p);
  if (bf)
    return (rows == kWgRows || rows == 2 * kWgRows) &&
           make_plan_wide(rows / kWgRows, T, K, F, NF, RD1, RD2, p);
  return rows <= kWgRows && make_plan(rows, T, K, F, NF, RD1, RD2, p);
}

template <int NWG>
int launch_wide(const Args& a, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(fused_agg_wide<NWG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (a.N + a.T - 1) / a.T;
  fused_agg_wide<NWG><<<grid, NWG * kWgThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int MT>
int launch_cluster(const Args& a, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(fused_agg_cluster<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (a.N + a.T - 1) / a.T;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((tiles + kClusterCtas - 1) / kClusterCtas * kClusterCtas, 1, 1);
  cfg.blockDim = dim3(kClThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kClusterCtas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fused_agg_cluster<MT>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int MT>
int launch_kernel(const Args& a, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(fused_agg_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (a.N + a.T - 1) / a.T;
  fused_agg_kernel<MT><<<grid, (kCons + 1) * 32, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch_rows(const Args& a, int rows, bool bf, size_t smem, cudaStream_t s) {
  switch (rows) {
    case 16: return bf ? launch_cluster<1>(a, smem, s) : launch_kernel<1>(a, smem, s);
    case 32: return bf ? launch_cluster<2>(a, smem, s) : launch_kernel<2>(a, smem, s);
    case 64: return bf ? launch_wide<1>(a, smem, s) : launch_kernel<4>(a, smem, s);
    case 128: return bf ? launch_wide<2>(a, smem, s) : static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes and ring stages of one CTA of `rows` rows holding T
// samples (bf != 0: the bf16 instantiation); 0 if the tile does not fit.
size_t fused_agg_smem_bytes(int rows, int T, int K, int F, int NF, int RD1, int RD2, int bf,
                            int* stages) {
  Plan p;
  if (!plan_for(rows, T, K, F, NF, RD1, RD2, bf != 0, &p)) return 0;
  if (stages != nullptr) *stages = p.nst;
  return p.smem;
}

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = success).
// bf != 0: the bf16 instantiation (mv, nb_feat and wpack bf16), else f32.
// wpack holds the seven products in the ring's order and layout
// (ops/fused_agg.py:pack_agg_weights); rows in {16, 32, 64} (f32) or {16,
// 32, 64, 128} (bf16), T*K <= rows; bf16 tiles of 64 and 128 rows hold T =
// (rows / 64) (64 / K) samples (K <= 64). bf16 tiles of 16 and 32 rows run
// in clusters of kClusterCtas CTAs, which read the products from wmat (a host
// array of their seven f32 device pointers, in the ring's order) and not
// from wpack (null then).
int fused_agg_forward(const float* xyz, const float* dir, int dir_stride, const void* mv,
                      const float* nb_xyz, const float* nb_dir, const void* nb_feat,
                      const float* scale, const float* freqs, const float* rd_w1,
                      const float* rd_b1, const float* rd_w2, const float* rd_b2,
                      const void* wpack, const float* const* wmat, const float* b0,
                      const float* b1, const float* b2, const float* ln_s, const float* ln_b,
                      float* out, int N, int K, int F, int W, int NF, int RD1, int RD2, int rows,
                      int T, float q_scale, int bf, void* stream) {
  if (N <= 0) return 0;
  Plan p;
  if (T < 1 || K < 1 || T * K > rows || W < 1 || W > kHd || (bf && W % 2) || RD1 < 1 ||
      RD1 > kMaxRd || RD1 > 6 * NF || RD2 < 1 || RD2 > kMaxRd ||
      !plan_for(rows, T, K, F, NF, RD1, RD2, bf != 0, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{xyz,    dir,    mv,     nb_xyz,        nb_dir,   nb_feat,  scale,
               freqs,  rd_w1,  rd_b1,  rd_w2,         rd_b2,    wpack,    b0,
               b1,     b2,     ln_s,   ln_b,          out,      N,        K,
               F,      W,      NF,     RD1,           RD2,      T,        dir_stride,
               p.ks_f, p.ks_e, p.ks0p, p.lde,         p.feat_elems,       p.region,
               p.q_rows,       p.nst,  p.rdw_floats,  p.off_floats,       q_scale};
  a.cl_ks = cluster_ks(p.ks0p, K);
  for (int i = 0; i < kProducts; ++i) a.wmat[i] = wmat != nullptr ? wmat[i] : nullptr;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch_rows(a, rows, bf != 0, p.smem, s);
}

}  // extern "C"
