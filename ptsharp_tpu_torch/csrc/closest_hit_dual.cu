// Closest-hit over the fat table: the ordered walk with two rays a
// thread, so two independent chains of row loads are in flight at once.
//
// Replaces the TPU kernel ptsharp_tpu/pallas/ordered_kernel.py
// pallas_traverse_ordered8_fat_dual (body _kernel8_ord_fat_dual): two
// independent packets of the ordered walk interleaved in one program,
// each issuing the DMA of its next fat pair before its MT unroll, so that
// the other packet's whole phase runs in that copy's shadow. It pushes in
// the "near" order only, and its results are those of
// pallas_traverse_ordered8_fat (closest_hit.cu), which the JAX package
// calls in that order. Its `mt_gate` only skips MT passes no lane needs and changes no result, and
// its `max_iters` is closest_hit.cu's bound, so the port takes neither.
//
// closest_hit.cu already walks one ray a thread, so the counterpart of
// two packets in flight is two rays a thread: ray i and ray i + h, h =
// ceil(R / 2), each with its own stack of kStackCap entries and its own
// best hit. One loop advances both walks; each turn
//   1. reads the heads of the node rows both rays visit (the two rows'
//      loads are issued before either is used),
//   2. runs both slab tests and both steps of the ordered walk
//      (ptk::ordered_step: descend and push, or pop), which pick each
//      ray's next node,
//   3. and only then runs MT over each ray's leaf block, if it has one.
// The next node does not depend on the leaf test, so each ray tests the
// leaves closest_hit.cu tests, in the same order (that walk also pushes
// "near", and only skips the steps whose own-box test fails here): t,
// slot, u and v equal on every lane.
//
// What bounds it on an H100: the chain of dependent 1 KB row-pair loads
// of each walk. What the design does about it: two chains in one
// instruction stream, so a thread waits for the slower of two loads
// instead of for each in turn. It pays with about twice the registers and
// a 1 KB local-memory frame for the two stacks, so fewer warps fit on an
// SM to hide each other's latency: the trade the TPU kernel made
// ("doubles register pressure", BASELINE.md). Rays i and i + h of a warp
// are each 32 neighbours in the caller's order, so a coherent ray order
// stays coherent within each half.

#include "bvh_common.cuh"

namespace {

template <int K>
__global__ void __launch_bounds__(128)
closest_hit_dual_kernel(const float* __restrict__ fat,
                        const float* __restrict__ org,
                        const float* __restrict__ dir,
                        const float* __restrict__ t_max, int n, int half,
                        int base, int end, int leaf_size,
                        float* __restrict__ t_out, int* __restrict__ slot_out,
                        float* __restrict__ u_out,
                        float* __restrict__ v_out) {
  const int ia = blockIdx.x * blockDim.x + threadIdx.x;
  if (ia >= half) return;
  const int ib = ia + half;  // past R only for the last thread of an odd R
  const bool has_b = ib < n;
  const ptk::FatTable tab{fat};
  const ptk::Ray ra = ptk::load_ray(org, dir, ia);
  const ptk::Ray rb = ptk::load_ray(org, dir, has_b ? ib : ia);
  ptk::Best ba{t_max[ia], -1, 0.0f, 0.0f};
  ptk::Best bb{has_b ? t_max[ib] : 0.0f, -1, 0.0f, 0.0f};
  int stack_a[ptk::kStackCap], stack_b[ptk::kStackCap];
  int sp_a = 0, sp_b = 0;
  int ca = base, cb = has_b ? base : end;
  // both walks take one step a turn while they run, so the turn count is
  // each running walk's step count and bounds it as closest_hit.cu does
  const int max_iters = end - base + 2;
  for (int it = 0; (ca < end || cb < end) && it < max_iters; ++it) {
    const bool run_a = ca < end, run_b = cb < end;
    const float* na = tab.node(run_a ? ca : base);
    const float* nb = tab.node(run_b ? cb : base);
    float tmin_a, tmax_a, tmin_b, tmax_b;
    ptk::slab(na, ra, tmin_a, tmax_a);
    ptk::slab(nb, rb, tmin_b, tmax_b);
    int fa = 0, fb = 0;
    const float* la = nullptr;
    const float* lb = nullptr;
    if (run_a) {
      la = ptk::ordered_step<K, ptk::Push::kNear>(
          tab, na, tmin_a, tmax_a, ra, ba.t, stack_a, sp_a, ca, end, fa);
    }
    if (run_b) {
      lb = ptk::ordered_step<K, ptk::Push::kNear>(
          tab, nb, tmin_b, tmax_b, rb, bb.t, stack_b, sp_b, cb, end, fb);
    }
    if (la != nullptr) ptk::leaf_closest(la, fa, leaf_size, ra, ba);
    if (lb != nullptr) ptk::leaf_closest(lb, fb, leaf_size, rb, bb);
  }
  t_out[ia] = ba.slot >= 0 ? ba.t : ptk::kInf;
  slot_out[ia] = ba.slot;
  u_out[ia] = ba.u;
  v_out[ia] = ba.v;
  if (!has_b) return;
  t_out[ib] = bb.slot >= 0 ? bb.t : ptk::kInf;
  slot_out[ib] = bb.slot;
  u_out[ib] = bb.u;
  v_out[ib] = bb.v;
}

}  // namespace

extern "C" int pt_closest_hit_dual(const float* fat, const float* org,
                                   const float* dir, const float* t_max,
                                   int n, int base, int end, int leaf_size,
                                   int k, float* t_out, int* slot_out,
                                   float* u_out, float* v_out, void* stream) {
  const int threads = 128;
  const int half = (n + 1) / 2;
  const int blocks = (half + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 4:
      closest_hit_dual_kernel<4><<<blocks, threads, 0, s>>>(
          fat, org, dir, t_max, n, half, base, end, leaf_size, t_out,
          slot_out, u_out, v_out);
      break;
    case 8:
      closest_hit_dual_kernel<8><<<blocks, threads, 0, s>>>(
          fat, org, dir, t_max, n, half, base, end, leaf_size, t_out,
          slot_out, u_out, v_out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
