// Any-hit (occlusion) by the K-wide preorder walk along skip links, no
// stack, one ray a lane in persistent warps that refill their idle lanes:
// over the fat BVH table (pt_any_hit_preorder) or over the XLA walk's row
// tables w_rows + leaf_rows (pt_any_hit_wide_rows).
//
// Replaces the TPU kernel ptsharp_tpu/pallas/hbm_kernel.py
// pallas_occluded_hbm8_fat (body _kernel8_hbm_fat_any): True where some
// triangle lies at t in (1e-4, t_cut), over the fat interleave. The TPU
// kernel retires a lane on its first hit and ends a 128-ray group's walk
// once every lane is occluded or inactive; here a lane retires on its
// first accepted hit and takes the next ray.
//
// Over the row tables it is the shadow-ray walk of the "wide", "walk" and
// "cluster" intersectors. The JAX package runs those shadow rays as the
// preorder closest-hit bounded by t_cut and tests t < INF
// (ptsharp_tpu/intersect.py:722-728); this walk gives the same boolean
// wherever t_cut <= 1e9: both accept exactly the triangles at t in
// (1e-4, t_cut) behind the same box tests, and the closest-hit's best t
// stays t_cut until its first accepted hit. Each ray's steps are capped at
// max_iters (65,536), as the closest-hit's are.
//
// What bounds it on an H100: the same chain of dependent row loads as the
// closest-hit walks, and a preorder walk does not reach a blocker sooner
// by entering near children first; shadow rays of one warp end at very
// different steps. The design is closest_hit_preorder.cu's (bvh_common.cuh,
// the persistent preorder walk) with best t fixed at t_cut: a lane whose
// t_cut is not positive writes False without reading the table, a lane
// that finds a blocker writes True, and both take the next ray while the
// other lanes walk on. ptxas (nvcc 12.8, sm_90a; chip_smoke.py's ptxas
// lines): 77 registers at K=4 and 80 at K=8 with float4 loads, 55 and 80
// with scalar loads, no stack frame and no spills (the one-thread-a-ray
// design had 40 and 48). The plain versions
// (kernels/traverse.py any_hit_preorder_plain, any_hit_wide_rows_plain)
// take the same steps, so the kernel equals them on every lane.

#include "bvh_common.cuh"

namespace {

template <int K, bool kVec, class Table>
__global__ void __launch_bounds__(ptk::kWalkThreads,
                                  ptk::kPreorderMinBlocks)
any_hit_preorder_kernel(Table tab, const float* __restrict__ org,
                        const float* __restrict__ dir,
                        const float* __restrict__ t_cut, int n, int base,
                        int end, int max_iters, bool* __restrict__ occ_out,
                        int* __restrict__ next_ray,
                        unsigned long long* __restrict__ counts) {
  ptk::Ray r;
  float tc = 0.0f;
  bool occ = false;
  ptk::persistent_walk(
      n, end, max_iters, next_ray, counts,
      [&](int i) {
        tc = t_cut[i];
        occ = false;
        if (!(tc > 0.0f)) return end;
        r = ptk::load_ray(org, dir, i);
        return base;
      },
      [&](int cur) {
        return ptk::preorder_step<K, kVec>(
            tab, cur, r, tc, end, [&](const float* leaf, int, int cnt) {
              ptk::leaf_slots<kVec>(leaf, cnt, r,
                                    [&](int, float tt, float, float) {
                                      occ = tt < tc;
                                      return occ;
                                    });
              return occ;
            });
      },
      [&](int i, int) { occ_out[i] = occ; });
}

template <int K, bool kVec, class Table>
int launch(const Table& tab, const float* org, const float* dir,
           const float* t_cut, int n, int base, int end, int max_iters,
           bool* occ_out, int* next_ray, unsigned long long* counts,
           cudaStream_t s) {
  static const int resident =
      ptk::resident_blocks(any_hit_preorder_kernel<K, kVec, Table>);
  any_hit_preorder_kernel<K, kVec, Table>
      <<<ptk::persistent_blocks(n, resident), ptk::kWalkThreads, 0, s>>>(
          tab, org, dir, t_cut, n, base, end, max_iters, occ_out, next_ray,
          counts);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec, class Table>
int launch_k(int k, const Table& tab, const float* org, const float* dir,
             const float* t_cut, int n, int base, int end, int max_iters,
             bool* occ_out, int* next_ray, unsigned long long* counts,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 4:
      return launch<4, kVec>(tab, org, dir, t_cut, n, base, end, max_iters,
                             occ_out, next_ray, counts, s);
    case 8:
      return launch<8, kVec>(tab, org, dir, t_cut, n, base, end, max_iters,
                             occ_out, next_ray, counts, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// next_ray and counts as in pt_closest_hit; the fat table as in
// pt_closest_hit_preorder
extern "C" int pt_any_hit_preorder(const float* fat, const float* org,
                                   const float* dir, const float* t_cut,
                                   int n, int base, int end, int k,
                                   bool* occ_out, int* next_ray,
                                   unsigned long long* counts,
                                   void* stream) {
  return launch_k<true>(k, ptk::FatTable{fat}, org, dir, t_cut, n, base, end,
                        end - base, occ_out, next_ray, counts, stream);
}

// the row tables and vec as in pt_closest_hit_wide_rows
extern "C" int pt_any_hit_wide_rows(
    const float* rows, const float* leaves, int node_stride, int leaf_stride,
    int vec, const float* org, const float* dir, const float* t_cut, int n,
    int base, int end, int leaf_size, int k, int max_iters, bool* occ_out,
    int* next_ray, unsigned long long* counts, void* stream) {
  const ptk::RowTable tab{rows, leaves, node_stride, leaf_stride, leaf_size};
  const int cap = end - base < max_iters ? end - base : max_iters;
  return vec ? launch_k<true>(k, tab, org, dir, t_cut, n, base, end, cap,
                              occ_out, next_ray, counts, stream)
             : launch_k<false>(k, tab, org, dir, t_cut, n, base, end, cap,
                               occ_out, next_ray, counts, stream);
}
