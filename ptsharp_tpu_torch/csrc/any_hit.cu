// Any-hit (occlusion) by the ordered walk, one ray a lane, in persistent
// warps that refill their idle lanes: over the fat BVH table (pt_any_hit)
// or over the split tables rows + leaf (pt_any_hit_split).
//
// Replaces three TPU kernels with one contract, True where some triangle
// lies at t in (1e-4, t_cut): ptsharp_tpu/pallas/wide_kernel.py
// pallas_occluded_wide8 (body _kernel8_any, over separate node and leaf
// tables, VMEM-resident) and ptsharp_tpu/pallas/ordered_kernel.py
// pallas_occluded_fat_pipe (body _kernel8_fat_any_pipe, over the fat table
// in HBM), which the port serves with one kernel over its one fat table;
// and ordered_kernel.py pallas_occluded_ordered8 (body _kernel8_ord_any),
// the ordered walk over `rows` + `leaf`, which retires a lane on its first
// hit and ends a 128-ray group's walk once every lane is occluded or
// inactive. The result is a boolean, and this walk visits each node at
// most once, so the push order changes none, and each entry pushes one
// order: the fat walk (#2, #3) far to near (ptk::Push::kFull), the split
// walk (#8) in static reverse order (kNear), which took 2-6% less time
// than far to near for it on the H100 (PERF.md section 6), whatever
// pallas_occluded_ordered8's `order_mode` names.
//
// What bounds it on an H100: the same chain of dependent row loads as
// closest-hit, and early exits that end the rays of one warp at very
// different steps. The design is closest_hit.cu's (bvh_common.cuh, the
// persistent ordered walk): a lane that finds a blocker, or whose t_cut is
// not positive, writes its result and takes the next ray while the others
// walk on; the walk tests no visited node's own box again (the child test
// decided it against t_cut, which never shrinks, so no pushed entry is ever
// dropped and the stack holds node indices only); float4 loads read the
// meta fields, the child fields and a leaf's `count` triangles. The plain
// versions are kernels/traverse.py any_hit_plain and any_hit_split_plain,
// which take the same steps.

#include "bvh_common.cuh"

namespace {

template <int K, ptk::Push P, class Table>
__global__ void __launch_bounds__(ptk::kWalkThreads)
any_hit_kernel(Table tab, const float* __restrict__ org,
               const float* __restrict__ dir,
               const float* __restrict__ t_cut, int n, int base, int end,
               bool* __restrict__ occ_out, int* __restrict__ next_ray,
               unsigned long long* __restrict__ counts) {
  ptk::Ray r;
  float tc = 0.0f;
  bool occ = false;
  ptk::EntryStack<false> st;
  ptk::persistent_walk(
      n, end, end - base + 2, next_ray, counts,
      [&](int i) {
        tc = t_cut[i];
        occ = false;
        st.sp = 0;
        if (!(tc > 0.0f)) return end;
        r = ptk::load_ray(org, dir, i);
        return ptk::walk_start(tab, r, tc, base, end);
      },
      [&](int cur) {
        return ptk::walk_step<K, P>(
            tab, cur, r, tc, st, end, [&](int, float tt, float, float) {
              occ = tt < tc;
              return occ;
            });
      },
      [&](int i, int) { occ_out[i] = occ; });
}

template <ptk::Push P, class Table>
int launch(int k, const Table& tab, const float* org, const float* dir,
           const float* t_cut, int n, int base, int end, bool* occ_out,
           int* next_ray, unsigned long long* counts, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 4) {
    static const int resident =
        ptk::resident_blocks(any_hit_kernel<4, P, Table>);
    any_hit_kernel<4, P, Table>
        <<<ptk::persistent_blocks(n, resident), ptk::kWalkThreads, 0, s>>>(
            tab, org, dir, t_cut, n, base, end, occ_out, next_ray, counts);
  } else if (k == 8) {
    static const int resident =
        ptk::resident_blocks(any_hit_kernel<8, P, Table>);
    any_hit_kernel<8, P, Table>
        <<<ptk::persistent_blocks(n, resident), ptk::kWalkThreads, 0, s>>>(
            tab, org, dir, t_cut, n, base, end, occ_out, next_ray, counts);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// next_ray and counts as in pt_closest_hit
extern "C" int pt_any_hit(const float* fat, const float* org,
                          const float* dir, const float* t_cut, int n,
                          int base, int end, int k, bool* occ_out,
                          int* next_ray, unsigned long long* counts,
                          void* stream) {
  return launch<ptk::Push::kFull>(k, ptk::FatTable{fat}, org, dir, t_cut, n,
                                  base, end, occ_out, next_ray, counts,
                                  stream);
}

// The split tables (node j at rows[j], its leaf block at leaf[first /
// leaf_size]); next_ray and counts as in pt_closest_hit.
extern "C" int pt_any_hit_split(const float* rows, const float* leaf,
                                const float* org, const float* dir,
                                const float* t_cut, int n, int base, int end,
                                int leaf_size, int k, bool* occ_out,
                                int* next_ray, unsigned long long* counts,
                                void* stream) {
  return launch<ptk::Push::kNear>(k, ptk::SplitTable{rows, leaf, leaf_size},
                                  org, dir, t_cut, n, base, end, occ_out,
                                  next_ray, counts, stream);
}
