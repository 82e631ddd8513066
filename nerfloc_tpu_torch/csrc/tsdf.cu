// TSDF integration of one RGB-D frame on Hopper.
//
// Not a port of a TPU kernel: the JAX package integrates on the host
// (nerfloc_tpu/native/tsdf.cpp:63-115, OpenMP C++). Its plain version is
// csrc/tsdf_host.cpp, the host copy of that function, and this kernel gives
// a bit-equal volume: every float operation is an explicit round-to-nearest
// intrinsic (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn; nothing to
// contract into an FMA) in the host code's order, the pixel is lroundf's,
// and a projection that leaves the int range skips the voxel and is
// counted, as on the host. Each voxel's update reads and writes only its
// own entries, so no order between threads matters.
//
// Layout: five float32 arrays of nx*ny*nz voxels, z fastest (tsdf, weight,
// r, g, b). One thread per voxel; a block is 128 consecutive z of one (x,
// y) column (grid: z blocks x ny x nx), so neighbouring threads load and
// store neighbouring words. The frame (depth [H*W], colour [H*W*3]) is read
// by gather at each voxel's pixel. What bounds it: bytes. A voxel that the
// frame updates reads and writes 20 bytes; the others read nothing (their
// test needs only their coordinates), so the frame costs the updated
// voxels' 40 bytes and its own pixels, and at 10^7 voxels the launch and
// the threads' arithmetic are of the same order. Runs on the caller's
// stream; allocates nothing.
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

constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock)
tsdf_integrate_kernel(float* __restrict__ tsdf, float* __restrict__ weight,
                      float* __restrict__ r, float* __restrict__ g, float* __restrict__ b,
                      const float* __restrict__ depth, const float* __restrict__ color, int H,
                      int W, Camera cam, Grid grid, float obs_weight,
                      unsigned long long* __restrict__ overflow) {
  const int iz = blockIdx.x * kBlock + threadIdx.x;
  if (iz >= grid.nz) return;
  const int iy = blockIdx.y, ix = blockIdx.z;
  const float wx = __fadd_rn(grid.ox, __fmul_rn((float)ix, grid.voxel));
  const float wy = __fadd_rn(grid.oy, __fmul_rn((float)iy, grid.voxel));
  const float wz = __fadd_rn(grid.oz, __fmul_rn((float)iz, grid.voxel));
  const float* R = cam.R;
  // R[i0]*wx + R[i1]*wy + t[i], then + R[i2]*wz: the host's hoisted order
  const float pz0 = __fadd_rn(__fadd_rn(__fmul_rn(R[6], wx), __fmul_rn(R[7], wy)), cam.t[2]);
  const float pz = __fadd_rn(pz0, __fmul_rn(R[8], wz));
  if (pz <= 0.0f) return;
  const float px0 = __fadd_rn(__fadd_rn(__fmul_rn(R[0], wx), __fmul_rn(R[1], wy)), cam.t[0]);
  const float py0 = __fadd_rn(__fadd_rn(__fmul_rn(R[3], wx), __fmul_rn(R[4], wy)), cam.t[1]);
  const float px = __fadd_rn(px0, __fmul_rn(R[2], wz));
  const float py = __fadd_rn(py0, __fmul_rn(R[5], wz));
  const float qu = __fadd_rn(__fdiv_rn(__fmul_rn(cam.fx, px), pz), cam.cx);
  const float qv = __fadd_rn(__fdiv_rn(__fmul_rn(cam.fy, py), pz), cam.cy);
  if (!(fabsf(qu) < 2147483648.0f) || !(fabsf(qv) < 2147483648.0f)) {
    atomicAdd(overflow, 1ull);
    return;
  }
  const int u = (int)lroundf(qu);
  const int v = (int)lroundf(qv);
  if (u < 0 || u >= W || v < 0 || v >= H) return;
  const int64_t pix = (int64_t)v * W + u;
  const float d = depth[pix];
  if (d <= 0.0f) return;
  const float sdf = __fsub_rn(d, pz);
  if (sdf < -grid.trunc) return;
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

}  // namespace

extern "C" {

// Launches the integration of one frame on `stream`; returns
// cudaGetLastError() (0 = success). Volume, depth, colour (or null) and
// overflow (one counter, incremented per skipped voxel) are device
// pointers; origin [3], K [9] (row-major), R [9] (row-major) and t [3] are
// host arrays, passed to the kernel by value.
int tsdf_integrate_cuda(float* tsdf, float* weight, float* r, float* g, float* b, int nx, int ny,
                        int nz, const float* origin, float voxel_size, float sdf_trunc,
                        const float* depth, const float* color, int H, int W, const float* K,
                        const float* R, const float* t, float obs_weight,
                        unsigned long long* overflow, void* stream) {
  if (nx < 1 || ny < 1 || nz < 1 || ny > 65535 || nx > 65535 || H < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Camera cam;
  for (int i = 0; i < 9; ++i) cam.R[i] = R[i];
  for (int i = 0; i < 3; ++i) cam.t[i] = t[i];
  cam.fx = K[0];
  cam.cx = K[2];
  cam.fy = K[4];
  cam.cy = K[5];
  const Grid grid{nx, ny, nz, origin[0], origin[1], origin[2], voxel_size, sdf_trunc};
  const dim3 blocks((nz + kBlock - 1) / kBlock, ny, nx);
  tsdf_integrate_kernel<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      tsdf, weight, r, g, b, depth, color, H, W, cam, grid, obs_weight, overflow);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
