// Any-hit (occlusion) over the fat BVH table: the ordered walk, one ray a
// lane, in persistent warps that refill their idle lanes.
//
// Replaces two TPU kernels with one contract, True where some triangle
// lies at t in (1e-4, t_cut): ptsharp_tpu/pallas/wide_kernel.py
// pallas_occluded_wide8 (body _kernel8_any, over separate node and leaf
// tables, VMEM-resident) and ptsharp_tpu/pallas/ordered_kernel.py
// pallas_occluded_fat_pipe (body _kernel8_fat_any_pipe, over the fat table
// in HBM). The port keeps one table form, so one kernel serves both. The
// result is a boolean, so the push order changes none: this walk pushes
// far to near, which measured faster than static reverse order.
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
// version is kernels/traverse.py any_hit_plain, which takes the same steps.

#include "bvh_common.cuh"

namespace {

template <int K>
__global__ void __launch_bounds__(ptk::kWalkThreads)
any_hit_kernel(const float* __restrict__ fat, const float* __restrict__ org,
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
        return ptk::fat_start(fat, r, tc, base, end);
      },
      [&](int cur) {
        return ptk::fat_step<K, ptk::Push::kFull>(
            fat, cur, r, tc, st, end, [&](int, float tt, float, float) {
              occ = tt < tc;
              return occ;
            });
      },
      [&](int i) { occ_out[i] = occ; });
}

template <int K>
int launch(const float* fat, const float* org, const float* dir,
           const float* t_cut, int n, int base, int end, bool* occ_out,
           int* next_ray, unsigned long long* counts, cudaStream_t s) {
  static const int resident = ptk::resident_blocks(any_hit_kernel<K>);
  any_hit_kernel<K>
      <<<ptk::persistent_blocks(n, resident), ptk::kWalkThreads, 0, s>>>(
          fat, org, dir, t_cut, n, base, end, occ_out, next_ray, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// next_ray and counts as in pt_closest_hit
extern "C" int pt_any_hit(const float* fat, const float* org,
                          const float* dir, const float* t_cut, int n,
                          int base, int end, int k, bool* occ_out,
                          int* next_ray, unsigned long long* counts,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 4:
      return launch<4>(fat, org, dir, t_cut, n, base, end, occ_out, next_ray,
                       counts, s);
    case 8:
      return launch<8>(fat, org, dir, t_cut, n, base, end, occ_out, next_ray,
                       counts, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
