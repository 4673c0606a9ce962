// Any-hit (occlusion) over the split node and leaf tables: one thread per
// ray, ordered stack, both push orders.
//
// Replaces the TPU kernel ptsharp_tpu/pallas/ordered_kernel.py
// pallas_occluded_ordered8 (body _kernel8_ord_any): True where some
// triangle lies at t in (1e-4, t_cut), over `rows` + `leaf` held in VMEM.
// The TPU kernel retires a lane on its first hit and ends a 128-ray
// group's walk once every lane is occluded or inactive; here each thread
// ends its own walk on its first hit, and a lane with t_cut <= 0 returns
// False without reading the tables. Its `order_mode` is a template
// parameter (ptk::Push), as in closest_hit_split.cu.
//
// What bounds it on an H100: the dependent node-row loads of the ordered
// walk, from a node table and a leaf table, with the stack in local
// memory, and warps whose shadow rays retire at different times. The walk
// body is ptk::ordered_any over a SplitTable, the body any_hit.cu runs
// over the fat table; regrouping live rays is left to later work.

#include "bvh_common.cuh"

namespace {

template <int K, ptk::Push P>
__global__ void __launch_bounds__(128)
any_hit_split_kernel(const float* __restrict__ rows,
                     const float* __restrict__ leaf,
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
    occ = ptk::ordered_any<K, P>(ptk::SplitTable{rows, leaf, leaf_size}, r,
                                 tc, base, end, leaf_size);
  }
  occ_out[i] = occ;
}

template <int K, ptk::Push P>
void launch(const float* rows, const float* leaf, const float* org,
            const float* dir, const float* t_cut, int n, int base, int end,
            int leaf_size, bool* occ_out, cudaStream_t s) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  any_hit_split_kernel<K, P><<<blocks, threads, 0, s>>>(
      rows, leaf, org, dir, t_cut, n, base, end, leaf_size, occ_out);
}

}  // namespace

// near != 0 selects order_mode "near".
extern "C" int pt_any_hit_split(const float* rows, const float* leaf,
                                const float* org, const float* dir,
                                const float* t_cut, int n, int base, int end,
                                int leaf_size, int k, int near, bool* occ_out,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using ptk::Push;
  if (k == 4 && !near) {
    launch<4, Push::kFull>(rows, leaf, org, dir, t_cut, n, base, end,
                           leaf_size, occ_out, s);
  } else if (k == 4) {
    launch<4, Push::kNear>(rows, leaf, org, dir, t_cut, n, base, end,
                           leaf_size, occ_out, s);
  } else if (k == 8 && !near) {
    launch<8, Push::kFull>(rows, leaf, org, dir, t_cut, n, base, end,
                           leaf_size, occ_out, s);
  } else if (k == 8) {
    launch<8, Push::kNear>(rows, leaf, org, dir, t_cut, n, base, end,
                           leaf_size, occ_out, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
