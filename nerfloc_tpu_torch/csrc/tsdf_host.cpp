// TSDF fusion on the host: the plain version of csrc/tsdf.cu.
//
// A copy of the JAX package's native engine (nerfloc_tpu/native/tsdf.cpp):
// integration of one RGB-D frame (:63-115), the surface count and point
// extraction (:118-149) and the marching-tetrahedra mesh (:186-243), over a
// volume the caller owns: five float32 arrays of nx*ny*nz voxels, z fastest
// (tsdf initialised to 1; weight and the colour accumulators r, g, b to 0).
// The arithmetic is tsdf.cpp's, in its order, one IEEE single operation at a
// time: ops/native.HOST_FLAGS compiles without FMA contraction, so the
// CUDA kernel, written in explicit round-to-nearest operations in the same
// order, gives a bit-equal volume. One change: a projection whose rounded
// pixel would not fit an int (a voxel just in front of the camera, where
// fx*px/pz overflows) skips the voxel and is counted; tsdf.cpp's
// (int)std::lround there is undefined (on x86 it wraps, to column 0 above
// 2^63). The kernel applies the same rule. Single-threaded.
//
// Plain C interface, loaded with ctypes by nerfloc_tpu_torch/native/tsdf.py.
#include <cmath>
#include <cstdint>

extern "C" {

// Integrates one frame. depth [H*W] metres (<= 0 invalid); color [H*W*3] in
// [0, 1] or null; K [9] row-major intrinsics; R [9] row-major and t [3] the
// world-to-camera rotation and translation. Returns the number of voxels in
// front of the camera whose projection left the int range (skipped).
int64_t tsdf_integrate(float* tsdf, float* weight, float* r, float* g, float* b,
                       int64_t nx, int64_t ny, int64_t nz, const float* origin,
                       float voxel_size, float sdf_trunc, const float* depth,
                       const float* color, int H, int W, const float* K, const float* R,
                       const float* t, float obs_weight) {
  const float fx = K[0], cx = K[2], fy = K[4], cy = K[5];
  const int64_t nyz = ny * nz;
  int64_t overflow = 0;
  for (int64_t ix = 0; ix < nx; ++ix) {
    const float wx = origin[0] + (float)ix * voxel_size;
    for (int64_t iy = 0; iy < ny; ++iy) {
      const float wy = origin[1] + (float)iy * voxel_size;
      // the x/y part of the rotation, once per column
      const float px0 = R[0] * wx + R[1] * wy + t[0];
      const float py0 = R[3] * wx + R[4] * wy + t[1];
      const float pz0 = R[6] * wx + R[7] * wy + t[2];
      const int64_t base = ix * nyz + iy * nz;
      for (int64_t iz = 0; iz < nz; ++iz) {
        const float wz = origin[2] + (float)iz * voxel_size;
        const float pz = pz0 + R[8] * wz;
        if (pz <= 0.0f) continue;
        const float px = px0 + R[2] * wz;
        const float py = py0 + R[5] * wz;
        const float qu = fx * px / pz + cx;
        const float qv = fy * py / pz + cy;
        if (!(std::fabs(qu) < 2147483648.0f) || !(std::fabs(qv) < 2147483648.0f)) {
          ++overflow;
          continue;
        }
        const int u = (int)std::lround(qu);
        const int vv = (int)std::lround(qv);
        if (u < 0 || u >= W || vv < 0 || vv >= H) continue;
        const float d = depth[(int64_t)vv * W + u];
        if (d <= 0.0f) continue;
        const float sdf = d - pz;
        if (sdf < -sdf_trunc) continue;
        const float tsdf_new = std::fmin(1.0f, sdf / sdf_trunc);
        const int64_t idx = base + iz;
        const float w_old = weight[idx];
        const float w_new = w_old + obs_weight;
        tsdf[idx] = (tsdf[idx] * w_old + tsdf_new * obs_weight) / w_new;
        weight[idx] = w_new;
        if (color) {
          const int64_t c = ((int64_t)vv * W + u) * 3;
          r[idx] = (r[idx] * w_old + color[c + 0] * obs_weight) / w_new;
          g[idx] = (g[idx] * w_old + color[c + 1] * obs_weight) / w_new;
          b[idx] = (b[idx] * w_old + color[c + 2] * obs_weight) / w_new;
        }
      }
    }
  }
  return overflow;
}

// Surface voxels: weight > 0 and |tsdf| < thresh.
int64_t tsdf_count_surface(const float* tsdf, const float* weight, int64_t n, float thresh) {
  int64_t cnt = 0;
  for (int64_t i = 0; i < n; ++i)
    if (weight[i] > 0.0f && std::fabs(tsdf[i]) < thresh) ++cnt;
  return cnt;
}

// Centres and colours of the surface voxels in flat-index order, at most
// `cap` of them (xyz and rgb hold cap x 3 floats). Returns the number
// written.
int64_t tsdf_extract_points(const float* tsdf, const float* weight, const float* r,
                            const float* g, const float* b, int64_t nx, int64_t ny, int64_t nz,
                            const float* origin, float voxel_size, float thresh, float* xyz,
                            float* rgb, int64_t cap) {
  int64_t out = 0;
  const int64_t nyz = ny * nz;
  for (int64_t ix = 0; ix < nx && out < cap; ++ix)
    for (int64_t iy = 0; iy < ny && out < cap; ++iy)
      for (int64_t iz = 0; iz < nz && out < cap; ++iz) {
        const int64_t idx = ix * nyz + iy * nz + iz;
        if (weight[idx] <= 0.0f || std::fabs(tsdf[idx]) >= thresh) continue;
        xyz[out * 3 + 0] = origin[0] + (float)ix * voxel_size;
        xyz[out * 3 + 1] = origin[1] + (float)iy * voxel_size;
        xyz[out * 3 + 2] = origin[2] + (float)iz * voxel_size;
        rgb[out * 3 + 0] = r[idx];
        rgb[out * 3 + 1] = g[idx];
        rgb[out * 3 + 2] = b[idx];
        ++out;
      }
  return out;
}

// ---------------------------------------------------------------------------
// Surface mesh by marching tetrahedra: each cell splits into 6 tetrahedra,
// and the zero crossings of the TSDF along their edges emit triangles.
// ---------------------------------------------------------------------------

namespace {

struct V3 { float x, y, z; };

// the 6 tetrahedra of a cube, as corner indices
const int kTets[6][4] = {
    {0, 5, 1, 6}, {0, 1, 2, 6}, {0, 2, 3, 6},
    {0, 3, 7, 6}, {0, 7, 4, 6}, {0, 4, 5, 6}};
// cube corner offsets (x, y, z)
const int kOff[8][3] = {{0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
                        {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1}};

inline V3 lerp_zero(const V3& a, const V3& b, float va, float vb) {
  float t = va / (va - vb + 1e-12f);
  if (t < 0.f) t = 0.f;
  if (t > 1.f) t = 1.f;
  return V3{a.x + t * (b.x - a.x), a.y + t * (b.y - a.y), a.z + t * (b.z - a.z)};
}

}  // namespace

// Surface triangles (9 floats each) into tri_verts, at most `cap`. Returns
// the number written.
int64_t tsdf_extract_mesh(const float* tsdf, const float* weight, int64_t nx, int64_t ny,
                          int64_t nz, const float* origin, float voxel_size, float* tri_verts,
                          int64_t cap) {
  const int64_t nyz = ny * nz;
  int64_t out = 0;
  for (int64_t ix = 0; ix + 1 < nx && out < cap; ++ix)
    for (int64_t iy = 0; iy + 1 < ny && out < cap; ++iy)
      for (int64_t iz = 0; iz + 1 < nz && out < cap; ++iz) {
        float val[8];
        V3 pos[8];
        bool ok = true;
        for (int c = 0; c < 8; ++c) {
          const int64_t jx = ix + kOff[c][0], jy = iy + kOff[c][1], jz = iz + kOff[c][2];
          const int64_t idx = jx * nyz + jy * nz + jz;
          if (weight[idx] <= 0.0f) { ok = false; break; }
          val[c] = tsdf[idx];
          // a surface exactly on a lattice plane collapses crossings onto
          // corners (degenerate triangles): exact zeros count as inside
          if (val[c] == 0.0f) val[c] = -1e-6f;
          pos[c] = V3{origin[0] + (float)jx * voxel_size, origin[1] + (float)jy * voxel_size,
                      origin[2] + (float)jz * voxel_size};
        }
        if (!ok) continue;
        for (int t = 0; t < 6 && out < cap; ++t) {
          const int* T = kTets[t];
          int inside = 0;
          for (int k = 0; k < 4; ++k)
            if (val[T[k]] < 0.0f) ++inside;
          if (inside == 0 || inside == 4) continue;
          // crossing points on the tetrahedron's 6 edges
          V3 pts[4];
          int np = 0;
          const int E[6][2] = {{0, 1}, {0, 2}, {0, 3}, {1, 2}, {1, 3}, {2, 3}};
          for (int e = 0; e < 6 && np < 4; ++e) {
            const int a = T[E[e][0]], b = T[E[e][1]];
            if ((val[a] < 0.f) != (val[b] < 0.f))
              pts[np++] = lerp_zero(pos[a], pos[b], val[a], val[b]);
          }
          auto emit = [&](const V3& a, const V3& b, const V3& c) {
            if (out >= cap) return;
            float* p = tri_verts + out * 9;
            p[0] = a.x; p[1] = a.y; p[2] = a.z;
            p[3] = b.x; p[4] = b.y; p[5] = b.z;
            p[6] = c.x; p[7] = c.y; p[8] = c.z;
            ++out;
          };
          if (np == 3) {
            emit(pts[0], pts[1], pts[2]);
          } else if (np == 4) {  // a quad: two triangles
            emit(pts[0], pts[1], pts[2]);
            emit(pts[0], pts[2], pts[3]);
          }
        }
      }
  return out;
}

}  // extern "C"
