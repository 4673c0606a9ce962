// Any-hit (occlusion) over the fat BVH table: one thread per ray.
//
// Replaces two TPU kernels with one contract, True where some triangle
// lies at t in (1e-4, t_cut): ptsharp_tpu/pallas/wide_kernel.py
// pallas_occluded_wide8 (body _kernel8_any, over separate node and leaf
// tables, VMEM-resident) and ptsharp_tpu/pallas/ordered_kernel.py
// pallas_occluded_fat_pipe (body _kernel8_fat_any_pipe, over the fat table
// in HBM). The port keeps one table form, so one kernel serves both.
//
// What bounds it on an H100: the same chain of dependent 1 KB fat-row
// loads as closest-hit, plus the per-thread stack in registers and local
// memory. Its design answer is the early exit: a thread retires on its
// first accepted hit, a lane with t_cut <= 0 returns False without reading
// the table, and the near-to-far walk reaches a blocker sooner. Shadow
// rays of one warp finish at different times, so warps stay partly idle;
// regrouping live rays is left to later work.
//
// The walk is the closest-hit walk with best t fixed at t_cut: pop a node,
// test its own box, run MT at a leaf, push hit children far to near at an
// internal node (ptk::ordered_any in bvh_common.cuh, which any_hit_split.cu
// runs over the split tables).

#include "bvh_common.cuh"

namespace {

template <int K>
__global__ void __launch_bounds__(128)
any_hit_kernel(const float* __restrict__ fat, const float* __restrict__ org,
               const float* __restrict__ dir,
               const float* __restrict__ t_cut, int n, int base, int end,
               int leaf_size, bool* __restrict__ occ_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float tc = t_cut[i];
  bool occ = false;
  if (tc > 0.0f) {
    const ptk::Ray r = ptk::load_ray(org, dir, i);
    occ = ptk::ordered_any<K, ptk::Push::kFull>(ptk::FatTable{fat}, r, tc,
                                                base, end, leaf_size);
  }
  occ_out[i] = occ;
}

}  // namespace

extern "C" int pt_any_hit(const float* fat, const float* org,
                          const float* dir, const float* t_cut, int n,
                          int base, int end, int leaf_size, int k,
                          bool* occ_out, void* stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 4:
      any_hit_kernel<4><<<blocks, threads, 0, s>>>(
          fat, org, dir, t_cut, n, base, end, leaf_size, occ_out);
      break;
    case 8:
      any_hit_kernel<8><<<blocks, threads, 0, s>>>(
          fat, org, dir, t_cut, n, base, end, leaf_size, occ_out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
