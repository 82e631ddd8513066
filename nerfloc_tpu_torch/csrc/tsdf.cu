// TSDF integration of one RGB-D frame on Hopper.
//
// Not a port of a TPU kernel: the JAX package integrates on the host
// (nerfloc_tpu/native/tsdf.cpp:63-115, OpenMP C++). Its plain version is
// csrc/tsdf_host.cpp, the host copy of that function, and this kernel gives
// a bit-equal volume: every float operation of a voxel's update is an
// explicit round-to-nearest intrinsic (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn; nothing to contract into an FMA) in the host code's order, the
// pixel is lroundf's, and a projection that leaves the int range skips the
// voxel and is counted, as on the host. Each voxel's update reads and
// writes only its own entries, so no order between threads matters.
//
// Layout: five float32 arrays of nx*ny*nz voxels, z fastest (tsdf, weight,
// r, g, b). The frame (depth [H*W], colour [H*W*3]) is read by gather at
// each voxel's pixel. What bounds it: bytes. A voxel that the frame updates
// reads and writes 20 bytes; the others read nothing (their test needs only
// their coordinates), so the frame costs the updated voxels' 40 bytes and
// its own pixels, a few per cent of the volume's voxels.
//
// Design. The first version ran a thread per voxel of the whole volume
// (~10^5 blocks of 128 threads a frame), so the launch was spent rejecting
// voxels: every thread computed its world point and depth, those in front
// of the camera two IEEE divisions and a rounding, and few of them reached
// memory. Here the volume is cut into bricks of 8x8x8 voxels, a block of
// 128 threads a brick, each thread walking 4 voxels of the brick along x
// (z of neighbouring threads neighbouring words). A block first tests its
// brick against the frame's frustum, in float64 on the brick's corners
// (the voxel centres as the update computes them, in float32), with planes
// the host computes once per frame (native/tsdf.py: cull_planes, whose
// numpy mirror brick_keep_mask the tests hold against the host copy):
//   - behind the camera: the brick's largest depth pz < -m_z;
//   - beyond the frame: its smallest pz > z_far (the frame's largest depth
//     plus sdf_trunc, or +inf);
//   - outside the image: for bricks whose smallest pz > z_keep, one of the
//     four image edges, widened by a pixel, has every corner outside.
// m_z, the pixel of widening and z_keep bound the float32 rounding of the
// voxel's own projection, so no brick that holds a voxel the update would
// touch is skipped; bricks that meet the slab 0 < pz <= z_keep, where a
// projection may leave the int range (and be counted), are never tested
// against the image edges. A skipped brick costs its block one test; a kept
// one runs the per-voxel code below unchanged. Runs on the caller's stream;
// allocates nothing.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct Camera {
  float R[9];  // world-to-camera rotation, row-major
  float t[3];  // world-to-camera translation
  float fx, fy, cx, cy;
};

struct Grid {
  int nx, ny, nz;
  float ox, oy, oz;  // the origin voxel's centre
  float voxel, trunc;
};

// The frame's culling planes (native/tsdf.py: cull_planes, float64). A
// plane p is the affine form p[3] + p[0] x + p[1] y + p[2] z of the world
// point.
struct Cull {
  double pz[4];       // the camera depth pz
  double side[4][4];  // the image edges widened by a pixel, >= 0 inside
  double m_z;         // a brick whose largest pz < -m_z is behind the camera
  double z_far;       // a brick whose smallest pz > z_far is beyond the frame
  double z_keep;      // the edges cull only bricks whose smallest pz > z_keep
};
constexpr int kCullDoubles = 4 + 16 + 3;

constexpr int kBrick = 8;      // voxels a side of a brick
constexpr int kBlock = 128;    // threads a brick: z 8 x y 8 x two halves of x
constexpr int kPerThread = kBrick * kBrick * kBrick / kBlock;   // voxels along x

// The largest (kMax) or smallest value of the plane p over the box [lo, hi],
// in float64 without contraction (the order brick_keep_mask computes it in).
template <bool kMax>
__device__ __forceinline__ double plane_extreme(const double (&p)[4], const double (&lo)[3],
                                                const double (&hi)[3]) {
  double v = p[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) v = __dadd_rn(v, __dmul_rn(p[a], (p[a] > 0.0) == kMax ? hi[a] : lo[a]));
  return v;
}

__device__ __forceinline__ float world(float o, int i, float voxel) {
  return __fadd_rn(o, __fmul_rn((float)i, voxel));
}

__global__ void __launch_bounds__(kBlock)
tsdf_integrate_kernel(float* __restrict__ tsdf, float* __restrict__ weight,
                      float* __restrict__ r, float* __restrict__ g, float* __restrict__ b,
                      const float* __restrict__ depth, const float* __restrict__ color, int H,
                      int W, Camera cam, Grid grid, Cull cull, float obs_weight,
                      unsigned long long* __restrict__ overflow) {
  const int bz = blockIdx.x * kBrick, by = blockIdx.y * kBrick, bx = blockIdx.z * kBrick;
  // the brick's corners: the first and last voxel centres on each axis
  // (a centre is monotonic in its index)
  const double lo[3] = {world(grid.ox, bx, grid.voxel), world(grid.oy, by, grid.voxel),
                        world(grid.oz, bz, grid.voxel)};
  const double hi[3] = {world(grid.ox, min(bx + kBrick, grid.nx) - 1, grid.voxel),
                        world(grid.oy, min(by + kBrick, grid.ny) - 1, grid.voxel),
                        world(grid.oz, min(bz + kBrick, grid.nz) - 1, grid.voxel)};
  const double zmin = plane_extreme<false>(cull.pz, lo, hi);
  if (plane_extreme<true>(cull.pz, lo, hi) < -cull.m_z || zmin > cull.z_far) return;
  if (zmin > cull.z_keep) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (plane_extreme<true>(cull.side[e], lo, hi) < 0.0) return;
  }

  const int iz = bz + (threadIdx.x & (kBrick - 1));
  const int iy = by + ((threadIdx.x / kBrick) & (kBrick - 1));
  if (iz >= grid.nz || iy >= grid.ny) return;
  const float* R = cam.R;
  const float wy = world(grid.oy, iy, grid.voxel);
  const float wz = world(grid.oz, iz, grid.voxel);
  const int x0 = bx + (threadIdx.x / (kBrick * kBrick)) * kPerThread;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int ix = x0 + j;
    if (ix >= grid.nx) break;
    const float wx = world(grid.ox, ix, grid.voxel);
    // R[i0]*wx + R[i1]*wy + t[i], then + R[i2]*wz: the host's hoisted order
    const float pz0 = __fadd_rn(__fadd_rn(__fmul_rn(R[6], wx), __fmul_rn(R[7], wy)), cam.t[2]);
    const float pz = __fadd_rn(pz0, __fmul_rn(R[8], wz));
    if (pz <= 0.0f) continue;
    const float px0 = __fadd_rn(__fadd_rn(__fmul_rn(R[0], wx), __fmul_rn(R[1], wy)), cam.t[0]);
    const float py0 = __fadd_rn(__fadd_rn(__fmul_rn(R[3], wx), __fmul_rn(R[4], wy)), cam.t[1]);
    const float px = __fadd_rn(px0, __fmul_rn(R[2], wz));
    const float py = __fadd_rn(py0, __fmul_rn(R[5], wz));
    const float qu = __fadd_rn(__fdiv_rn(__fmul_rn(cam.fx, px), pz), cam.cx);
    const float qv = __fadd_rn(__fdiv_rn(__fmul_rn(cam.fy, py), pz), cam.cy);
    if (!(fabsf(qu) < 2147483648.0f) || !(fabsf(qv) < 2147483648.0f)) {
      atomicAdd(overflow, 1ull);
      continue;
    }
    const int u = (int)lroundf(qu);
    const int v = (int)lroundf(qv);
    if (u < 0 || u >= W || v < 0 || v >= H) continue;
    const int64_t pix = (int64_t)v * W + u;
    const float d = depth[pix];
    if (d <= 0.0f) continue;
    const float sdf = __fsub_rn(d, pz);
    if (sdf < -grid.trunc) continue;
    const float tsdf_new = fminf(1.0f, __fdiv_rn(sdf, grid.trunc));
    const int64_t idx = ((int64_t)ix * grid.ny + iy) * grid.nz + iz;
    const float w_old = weight[idx];
    const float w_new = __fadd_rn(w_old, obs_weight);
    tsdf[idx] = __fdiv_rn(__fadd_rn(__fmul_rn(tsdf[idx], w_old), __fmul_rn(tsdf_new, obs_weight)),
                          w_new);
    weight[idx] = w_new;
    if (color != nullptr) {
      const float* c = color + pix * 3;
      r[idx] = __fdiv_rn(__fadd_rn(__fmul_rn(r[idx], w_old), __fmul_rn(c[0], obs_weight)), w_new);
      g[idx] = __fdiv_rn(__fadd_rn(__fmul_rn(g[idx], w_old), __fmul_rn(c[1], obs_weight)), w_new);
      b[idx] = __fdiv_rn(__fadd_rn(__fmul_rn(b[idx], w_old), __fmul_rn(c[2], obs_weight)), w_new);
    }
  }
}

}  // namespace

extern "C" {

// Launches the integration of one frame on `stream`; returns
// cudaGetLastError() (0 = success). Volume, depth, colour (or null) and
// overflow (one counter, incremented per skipped voxel) are device
// pointers; origin [3], K [9] (row-major), R [9] (row-major), t [3] and
// cull [23] (the Cull struct's doubles in order) are host arrays, passed
// to the kernel by value.
int tsdf_integrate_cuda(float* tsdf, float* weight, float* r, float* g, float* b, int nx, int ny,
                        int nz, const float* origin, float voxel_size, float sdf_trunc,
                        const float* depth, const float* color, int H, int W, const float* K,
                        const float* R, const float* t, const double* cull, float obs_weight,
                        unsigned long long* overflow, void* stream) {
  const int bx = (nx + kBrick - 1) / kBrick, by = (ny + kBrick - 1) / kBrick;
  if (nx < 1 || ny < 1 || nz < 1 || by > 65535 || bx > 65535 || H < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Camera cam;
  for (int i = 0; i < 9; ++i) cam.R[i] = R[i];
  for (int i = 0; i < 3; ++i) cam.t[i] = t[i];
  cam.fx = K[0];
  cam.cx = K[2];
  cam.fy = K[4];
  cam.cy = K[5];
  Cull c;
  static_assert(sizeof(Cull) == kCullDoubles * sizeof(double), "Cull is the host's array");
  double* dst = reinterpret_cast<double*>(&c);
  for (int i = 0; i < kCullDoubles; ++i) dst[i] = cull[i];
  const Grid grid{nx, ny, nz, origin[0], origin[1], origin[2], voxel_size, sdf_trunc};
  const dim3 blocks((nz + kBrick - 1) / kBrick, by, bx);
  tsdf_integrate_kernel<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      tsdf, weight, r, g, b, depth, color, H, W, cam, grid, c, obs_weight, overflow);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
