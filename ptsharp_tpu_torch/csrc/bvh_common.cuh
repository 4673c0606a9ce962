// Shared device arithmetic for the fat-table BVH kernels.
//
// The constants and the order of every floating-point operation follow the
// JAX package's packet helpers (ptsharp_tpu/pallas/wide_kernel.py:55-152):
//   packet_safe_inv  clamps |d| below 1e-30 to +/-1e-30 before 1/d;
//   packet_slab      slab test of one box (min of maxes, max of mins);
//   packet_mt        Moller-Trumbore with det clamped at 1e-12, accepting
//                    u in [0,1], v >= 0, u+v <= 1 and t > 1e-4;
//   packet_descend   smallest preorder index among the hit children;
//   accept_closest   keeps a hit only where tt < best t.
// The library is built with -fmad=false so that no multiply-add is
// contracted: each product and sum rounds as it does in the plain PyTorch
// version and in the JAX reference, and the MT edge tests decide alike.
//
// Table layout (accel/tables.py): fat row pair (2i, 2i+1) = [wide node i;
// its leaf block], 128 float32 columns each. Node row: own box [0:6],
// first slot [6] (int bits), count [7] (int bits, low byte), skip [8],
// K child boxes [9 : 9+6K], K child indices [9+6K : 9+7K] (int bits, 0 =
// absent). Leaf block: leaf_size x (v0, e1, e2).

#pragma once

#include <cuda_runtime.h>

namespace ptk {

constexpr int kRow = 128;
constexpr float kInf = 1e9f;

#ifndef PT_STACK_CAP
#define PT_STACK_CAP 64
#endif
constexpr int kStackCap = PT_STACK_CAP;

__device__ __forceinline__ float safe_inv(float d) {
  float dd = fabsf(d) < 1e-30f ? (d < 0.0f ? -1e-30f : 1e-30f) : d;
  return 1.0f / dd;
}

struct Ray {
  float ox, oy, oz;
  float dx, dy, dz;
  float ix, iy, iz;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ org,
                                        const float* __restrict__ dir,
                                        int i) {
  Ray r;
  r.ox = org[3 * i + 0];
  r.oy = org[3 * i + 1];
  r.oz = org[3 * i + 2];
  r.dx = dir[3 * i + 0];
  r.dy = dir[3 * i + 1];
  r.dz = dir[3 * i + 2];
  r.ix = safe_inv(r.dx);
  r.iy = safe_inv(r.dy);
  r.iz = safe_inv(r.dz);
  return r;
}

// Box at b[0:3] (lo), b[3:6] (hi): entry/exit distances.
__device__ __forceinline__ void slab(const float* __restrict__ b,
                                     const Ray& r, float& tmin,
                                     float& tmax) {
  float lox = (b[0] - r.ox) * r.ix;
  float loy = (b[1] - r.oy) * r.iy;
  float loz = (b[2] - r.oz) * r.iz;
  float hix = (b[3] - r.ox) * r.ix;
  float hiy = (b[4] - r.oy) * r.iy;
  float hiz = (b[5] - r.oz) * r.iz;
  tmin = fmaxf(fmaxf(fminf(lox, hix), fminf(loy, hiy)), fminf(loz, hiz));
  tmax = fminf(fminf(fmaxf(lox, hix), fmaxf(loy, hiy)), fmaxf(loz, hiz));
}

__device__ __forceinline__ bool box_hit(float tmin, float tmax, float bt) {
  return tmax >= fmaxf(tmin, 0.0f) && tmin < bt;
}

// Moller-Trumbore against one (v0, e1, e2) triangle; returns whether the
// ray hits it at tt > 1e-4 (before any best-t test).
__device__ __forceinline__ bool mt(const float* __restrict__ tri,
                                   const Ray& r, float& tt, float& uu,
                                   float& vv) {
  const float v0x = tri[0], v0y = tri[1], v0z = tri[2];
  const float e1x = tri[3], e1y = tri[4], e1z = tri[5];
  const float e2x = tri[6], e2y = tri[7], e2z = tri[8];
  const float hx = r.dy * e2z - r.dz * e2y;
  const float hy = r.dz * e2x - r.dx * e2z;
  const float hz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * hx + e1y * hy + e1z * hz;
  const float inv_det = 1.0f / (fabsf(det) < 1e-12f ? 1e-12f : det);
  const float sx = r.ox - v0x;
  const float sy = r.oy - v0y;
  const float sz = r.oz - v0z;
  uu = (sx * hx + sy * hy + sz * hz) * inv_det;
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  vv = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  return fabsf(det) > 1e-12f && uu >= 0.0f && uu <= 1.0f && vv >= 0.0f &&
         uu + vv <= 1.0f && tt > 1e-4f;
}

// Children of an internal node that the ray enters before `bt`, sorted
// near to far (stable: equal entry distances keep child order). Returns
// their number; idx[0] is the nearest.
template <int K>
__device__ __forceinline__ int hit_children(const float* __restrict__ node,
                                            const Ray& r, float bt,
                                            float (&key)[K], int (&idx)[K]) {
  const int* bits = reinterpret_cast<const int*>(node);
  int nh = 0;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const int ci = bits[9 + 6 * K + c];
    float ctmin, ctmax;
    slab(node + 9 + 6 * c, r, ctmin, ctmax);
    if (box_hit(ctmin, ctmax, bt) && ci > 0) {
      int j = nh;
      while (j > 0 && key[j - 1] > ctmin) {
        key[j] = key[j - 1];
        idx[j] = idx[j - 1];
        --j;
      }
      key[j] = ctmin;
      idx[j] = ci;
      ++nh;
    }
  }
  return nh;
}

// The preorder walk's descent (packet_descend): the smallest preorder
// index among the children the ray enters before `bt`, or -1 when it
// enters none. Absent children carry index 0 and are never taken.
template <int K>
__device__ __forceinline__ int first_hit_child(const float* __restrict__ node,
                                               const Ray& r, float bt) {
  const int* bits = reinterpret_cast<const int*>(node);
  int target = -1;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const int ci = bits[9 + 6 * K + c];
    float ctmin, ctmax;
    slab(node + 9 + 6 * c, r, ctmin, ctmax);
    if (box_hit(ctmin, ctmax, bt) && ci > 0 && (target < 0 || ci < target)) {
      target = ci;
    }
  }
  return target;
}

// Push the hit children far to near (all but the nearest, which the walk
// visits next). An ordered scene's build checks max_stack_bound <=
// kStackCap, so the capacity test never drops an entry for a table the
// port built.
template <int K>
__device__ __forceinline__ void push_far_to_near(const int (&idx)[K], int nh,
                                                 int* stack, int& sp) {
  for (int j = nh - 1; j >= 1; --j) {
    if (sp < kStackCap) stack[sp++] = idx[j];
  }
}

}  // namespace ptk
