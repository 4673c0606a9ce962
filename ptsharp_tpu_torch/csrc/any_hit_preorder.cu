// Any-hit (occlusion) over the fat BVH table: one thread per ray,
// preorder walk along skip links, no stack.
//
// Replaces the TPU kernel ptsharp_tpu/pallas/hbm_kernel.py
// pallas_occluded_hbm8_fat (body _kernel8_hbm_fat_any): True where some
// triangle lies at t in (1e-4, t_cut), over the fat interleave. The TPU
// kernel retires a lane on its first hit and ends a 128-ray group's walk
// once every lane is occluded or inactive; here each thread ends its own
// walk on its first hit.
//
// What bounds it on an H100: the same chain of dependent 1 KB fat-row
// loads as the closest-hit walks, and a preorder walk does not reach a
// blocker sooner by entering near children first. Shadow rays of one warp
// finish at different times, so warps stay partly idle. What the design
// does about it: no stack and no sort of child keys, so nothing lives in
// local memory (ptxas, nvcc 12.8 for sm_90a: a 0-byte stack frame, against
// 576 bytes for any_hit.cu at K=8, though 48 registers against its 40); a
// lane with t_cut <= 0 returns False without reading the table; and a
// thread retires on its first accepted hit.
//
// The walk is the preorder closest-hit walk (closest_hit_preorder.cu)
// with best t fixed at t_cut: test the node's box, run MT at a leaf, go
// to the hit child of smallest preorder index at an internal node, and
// follow the skip link where nothing is hit.

#include "bvh_common.cuh"

namespace {

template <int K>
__global__ void __launch_bounds__(128)
any_hit_preorder_kernel(const float* __restrict__ fat,
                        const float* __restrict__ org,
                        const float* __restrict__ dir,
                        const float* __restrict__ t_cut, int n, int base,
                        int end, int leaf_size, bool* __restrict__ occ_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float tc = t_cut[i];
  bool occ = false;
  if (tc > 0.0f) {
    const ptk::Ray r = ptk::load_ray(org, dir, i);
    int cur = base;
    const int max_iters = end - base;
    for (int it = 0; cur < end && it < max_iters && !occ; ++it) {
      const float* node = fat + static_cast<size_t>(2 * cur) * ptk::kRow;
      const int* bits = reinterpret_cast<const int*>(node);
      float tmin, tmax;
      ptk::slab(node, r, tmin, tmax);
      int next = bits[8];  // skip link
      if (ptk::box_hit(tmin, tmax, tc)) {
        if ((bits[7] & 0xFF) > 0) {
          occ = ptk::leaf_any(node + ptk::kRow, leaf_size, r, tc);
        } else {
          const int c = ptk::first_hit_child<K>(node, r, tc);
          if (c >= 0) next = c;
        }
      }
      cur = next;
    }
  }
  occ_out[i] = occ;
}

}  // namespace

extern "C" int pt_any_hit_preorder(const float* fat, const float* org,
                                   const float* dir, const float* t_cut,
                                   int n, int base, int end, int leaf_size,
                                   int k, bool* occ_out, void* stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 4:
      any_hit_preorder_kernel<4><<<blocks, threads, 0, s>>>(
          fat, org, dir, t_cut, n, base, end, leaf_size, occ_out);
      break;
    case 8:
      any_hit_preorder_kernel<8><<<blocks, threads, 0, s>>>(
          fat, org, dir, t_cut, n, base, end, leaf_size, occ_out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
