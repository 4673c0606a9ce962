// Shared device arithmetic and walk bodies for the BVH kernels.
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
// Table layout (accel/tables.py), 128 float32 columns a row. Node row:
// own box [0:6], first slot [6] (int bits), count [7] (int bits, low
// byte), skip [8], K child boxes [9 : 9+6K], K child indices [9+6K :
// 9+7K] (int bits, 0 = absent). Leaf block: leaf_size x (v0, e1, e2). Two
// forms hold the same rows: the fat interleave, row pair (2j, 2j+1) =
// [node j; its leaf block] (FatTable), and the split tables that
// pack_fat interleaves, node j at rows[j] and its leaf block at
// leaf[first / leaf_size] (SplitTable). A walk body takes either: the one
// ordered walk and the one preorder walk serve both table forms.
//
// The XLA walks' row tables (ptsharp_tpu/accel/traverse.py) hold the same
// fields at other strides (RowTable): the binary node rows u_rows (N, 10),
// whose internal nodes carry no child fields, the K-wide w_rows
// (Nw, row_width(K)), 40 floats at K=4 and 72 at K=8, and the leaf blocks
// leaf_rows (NL, leaf_size * 9), node j's block at leaf[first / leaf_size].
// A leaf's slots past its count hold zero triangles in every table, which
// Moller-Trumbore rejects (det = 0), so a walk may test only `count` slots.

#pragma once

#include <cuda_runtime.h>

namespace ptk {

constexpr int kRow = 128;
constexpr float kInf = 1e9f;

// traversal stack entries per ray of the ordered walk, as the JAX ordered
// kernels hold per group (ptsharp_tpu/pallas/ordered_kernel.py:34-37)
#ifndef PT_STACK_CAP
#define PT_STACK_CAP 128
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

// Children the ray enters before `bt`, sorted near to far (stable: equal
// entry distances keep child order), from K child boxes cb[6c : 6c+6] and
// K child indices ci[c] (int bits). Returns their number; idx[0] is the
// nearest and key[j] the entry distance of idx[j].
template <int K>
__device__ __forceinline__ int sort_children(const float* cb, const float* ci,
                                             const Ray& r, float bt,
                                             float (&key)[K], int (&idx)[K]) {
  int nh = 0;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const int cc = __float_as_int(ci[c]);
    float ctmin, ctmax;
    slab(cb + 6 * c, r, ctmin, ctmax);
    if (box_hit(ctmin, ctmax, bt) && cc > 0) {
      int j = nh;
      while (j > 0 && key[j - 1] > ctmin) {
        key[j] = key[j - 1];
        idx[j] = idx[j - 1];
        --j;
      }
      key[j] = ctmin;
      idx[j] = cc;
      ++nh;
    }
  }
  return nh;
}

// ---- where a walk reads a node row and its leaf block ----------------------

struct FatTable {
  const float* fat;
  __device__ __forceinline__ const float* node(int j) const {
    return fat + static_cast<size_t>(2 * j) * kRow;
  }
  // the leaf block of `node`, whose first slot the caller has read
  __device__ __forceinline__ const float* leaf(const float* node, int) const {
    return node + kRow;
  }
};

struct SplitTable {
  const float* rows;
  const float* leaves;
  int leaf_size;
  __device__ __forceinline__ const float* node(int j) const {
    return rows + static_cast<size_t>(j) * kRow;
  }
  // the leaf block of `node`, whose first slot `first` the caller has read
  __device__ __forceinline__ const float* leaf(const float*, int first) const {
    return leaves + static_cast<size_t>(first / leaf_size) * kRow;
  }
};

// Node rows and leaf blocks at strides given at run time (the XLA walks'
// tables). w_rows (40 or 72 floats) and leaf_rows at a leaf size that is a
// multiple of 4 (72 floats at leaf 8) are 16-byte strides, which the walks
// read with float4 loads; leaf_rows at other leaf sizes (54 floats at leaf
// 6) are not, and are read with scalar loads. u_rows (10 floats) is an
// 8-byte stride, which the binary walk reads with float2 loads.
struct RowTable {
  const float* rows;
  const float* leaves;
  int node_stride;
  int leaf_stride;
  int leaf_size;
  __device__ __forceinline__ const float* node(int j) const {
    return rows + static_cast<size_t>(j) * node_stride;
  }
  // the leaf block of `node`, whose first slot `first` the caller has read
  __device__ __forceinline__ const float* leaf(const float*, int first) const {
    return leaves + static_cast<size_t>(first / leaf_size) * leaf_stride;
  }
};

// ---- results and push orders ----------------------------------------------

// The ordered walk's push order (ordered_kernel.py order_mode): both take
// the nearest hit child next; kFull pushes the others far to near (:206-
// 221), kNear in static reverse order (:222-225), so they pop in child
// order whatever their distance.
enum class Push { kFull, kNear };

struct Best {
  float t;
  int slot;
  float u, v;
};

// ---- the persistent ordered walk (#1, #2, #5, #8, #9) ----------------------
//
// closest_hit.cu and any_hit.cu run the ordered walk in persistent warps,
// over the fat table (#1, #2) and over the split tables (#5, #8): one walk
// over a table view (FatTable or SplitTable) serves both forms.
// closest_hit_dual.cu runs two such walks a lane (persistent_walk2) over
// the fat table. The grid holds as many blocks as are resident at once,
// and each warp takes rays from one global counter in their input order.
// A lane whose ray has ended writes its result and takes the next ray,
// with its stack reset, while the other lanes keep walking; a warp refills
// its idle lanes (one atomicAdd for all of them) when fewer than
// kRefillBelow are live. Stack entries carry the entry distance of their
// box, computed when the parent tested its children: a pop drops the
// entries that the ray no longer enters before the best t without reading
// their rows, and no node reached from the stack or from its parent tests
// its own box again, since the parent's child test decided it (exact
// because every child box in a row equals the child's own box bit for bit,
// which the scene build checks: accel.tables.check_child_boxes; split_fat
// copies those rows). A step reads what it uses with float4 loads through
// the read-only path: the meta fields, then at an internal node the K
// child boxes and indices, at a leaf its `count` triangles (in the split
// tables, from leaf[first / leaf_size]).

constexpr int kWalkThreads = 128;  // threads a block
constexpr unsigned kWarpAll = 0xffffffffu;
// the persistent walks refill a warp's idle lanes when fewer than this are
// live (measured against 8-32 for the ordered walks and 16 and 32 for the
// preorder and binary walks on the H100, PERF.md section 6)
constexpr int kRefillBelow = 24;

// The ordered walk's stack, in local memory. With kDist each entry also
// carries the distance at which the ray enters the entry's box, and
// next() drops the entries no longer nearer than the best t; without it
// (any-hit, whose bound never shrinks, so nothing pushed is ever dropped)
// the entries hold node indices only.
template <bool kDist>
struct EntryStack {
  int sp;
  int node[kStackCap];
  float dist[kDist ? kStackCap : 1];

  __device__ __forceinline__ void push(int n, float d) {
    if (sp >= kStackCap) return;  // builds check max_stack_bound
    node[sp] = n;
    if constexpr (kDist) dist[sp] = d;
    ++sp;
  }
  // the next node to visit, `end` when the stack runs out
  __device__ __forceinline__ int next(float bt, int end) {
    while (sp > 0) {
      --sp;
      if (!kDist || dist[sp] < bt) return node[sp];
    }
    return end;
  }
};

// A float4 from device memory through the read-only path, or with kShared
// a plain load from shared memory (in a warp packet every lane reads the
// same address: a broadcast).
template <bool kShared>
__device__ __forceinline__ float4 load4(const float4* p) {
  if constexpr (kShared) {
    return *p;
  } else {
    return __ldg(p);
  }
}

// MT over the first `cnt` triangles of a leaf block in slot order, four
// triangles (nine float4 loads, none past the last triangle) a turn, or
// with kVec false one triangle (nine scalar loads) a turn, for a block
// that is not 16-byte aligned; keep(l, tt, uu, vv) takes each hit at
// tt > 1e-4 and returns true to stop. The padding slots past `cnt` are
// zero triangles, which MT rejects, so the result is that of every slot.
// kShared: the block lies in shared memory (float4 loads only).
template <bool kVec = true, bool kShared = false, class Keep>
__device__ __forceinline__ void leaf_slots(const float* __restrict__ leaf,
                                           int cnt, const Ray& r,
                                           Keep keep) {
  static_assert(kVec || !kShared, "shared blocks are read with float4");
  if constexpr (!kVec) {
    for (int l = 0; l < cnt; ++l) {
      float tri[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) tri[i] = __ldg(leaf + 9 * l + i);
      float tt, uu, vv;
      if (mt(tri, r, tt, uu, vv) && keep(l, tt, uu, vv)) return;
    }
  } else {
    const float4* p = reinterpret_cast<const float4*>(leaf);
    for (int g = 0; g < cnt; g += 4) {
      float f[36];
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        const int q = 9 * (g / 4) + i;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (4 * q < 9 * cnt) v = load4<kShared>(p + q);
        f[4 * i + 0] = v.x;
        f[4 * i + 1] = v.y;
        f[4 * i + 2] = v.z;
        f[4 * i + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float tt, uu, vv;
        if (g + j < cnt && mt(f + 9 * j, r, tt, uu, vv) &&
            keep(g + j, tt, uu, vv)) {
          return;
        }
      }
    }
  }
}

// leaf_slots keeping the closest accepted hit in b: strict tt < best t, so
// the first slot wins among equal t.
template <bool kVec, bool kShared = false>
__device__ __forceinline__ void closest_in_leaf(const float* __restrict__ leaf,
                                                int first, int cnt,
                                                const Ray& r, Best& b) {
  leaf_slots<kVec, kShared>(leaf, cnt, r, [&](int l, float tt, float uu,
                                              float vv) {
    if (tt < b.t) b = Best{tt, first + l, uu, vv};
    return false;
  });
}

// Where a ray starts over nodes [base, end) of `tab`: the root, or `end`
// when the ray does not enter the root's box before `bt`.
template <class Table>
__device__ __forceinline__ int walk_start(const Table& tab, const Ray& r,
                                          float bt, int base, int end) {
  if (base >= end) return end;
  float tmin, tmax;
  slab(tab.node(base), r, tmin, tmax);
  return box_hit(tmin, tmax, bt) ? base : end;
}

// What a step of the ordered walk reads of a node row, in registers,
// loaded in two parts so that a thread that walks two rays
// (closest_hit_dual.cu) issues both rays' loads before it waits for
// either: load_meta() reads the meta fields [4, 8) (first slot, count)
// with one float4 load; at an internal node load_children(), once they
// have arrived, reads fields [8, 8 + 4 kVec): the skip link, the K child
// boxes at [9, 9 + 6K) and the K child indices at [9 + 6K, 9 + 7K). A
// leaf's triangles are read by the leaf test itself: holding four of them
// in registers beside the child fields took #1 from 80 to 123 registers at
// K=8 (PERF.md section 6).
template <int K>
struct OrderedRow {
  static constexpr int kVec = (1 + 7 * K + 3) / 4;
  const float* node;
  int first, cnt;
  float f[4 * kVec];

  template <class Table>
  __device__ __forceinline__ void load_meta(const Table& tab, int cur) {
    node = tab.node(cur);
    const float4 meta = __ldg(reinterpret_cast<const float4*>(node) + 1);
    first = __float_as_int(meta.z);
    cnt = __float_as_int(meta.w) & 0xFF;
  }
  __device__ __forceinline__ void load_children() {
    const float4* p = reinterpret_cast<const float4*>(node) + 2;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float4 q = __ldg(p + i);
      f[4 * i + 0] = q.x;
      f[4 * i + 1] = q.y;
      f[4 * i + 2] = q.z;
      f[4 * i + 3] = q.w;
    }
  }
  __device__ __forceinline__ const float* boxes() const { return f + 1; }
  __device__ __forceinline__ const float* children() const {
    return f + 1 + 6 * K;
  }
};

// The step of the ordered walk at a leaf of `tab` whose meta fields `row`
// holds, which the ray enters before `bt` (the root by walk_start, any
// other node by its parent's child test): MT over its `count` triangles in
// slot order, keep(slot, tt, uu, vv) taking each hit at tt > 1e-4 and
// returning true to end the walk. Returns the next node: `end` when the
// walk is over.
template <int K, bool kDist, class Table, class Keep>
__device__ __forceinline__ int row_leaf(const Table& tab,
                                        const OrderedRow<K>& row,
                                        const Ray& r, const float& bt,
                                        EntryStack<kDist>& st, int end,
                                        Keep keep) {
  bool stop = false;
  const int first = row.first;
  leaf_slots(tab.leaf(row.node, first), row.cnt, r,
             [&](int l, float tt, float uu, float vv) {
               stop = keep(first + l, tt, uu, vv);
               return stop;
             });
  return stop ? end : st.next(bt, end);
}

// The step of the ordered walk at an internal node whose child fields
// `row` holds, which the ray enters before `bt`: push the hit children
// other than the nearest with their entry distances, in the order P names,
// and go to the nearest (the lowest child among equal entry distances), or
// pop where it enters none. Returns the next node: `end` when the walk is
// over.
template <int K, Push P, bool kDist>
__device__ __forceinline__ int row_descend(const OrderedRow<K>& row,
                                           const Ray& r, float bt,
                                           EntryStack<kDist>& st, int end) {
  float key[K];
  if constexpr (P == Push::kFull) {
    int idx[K];
    const int nh = sort_children<K>(row.boxes(), row.children(), r, bt, key,
                                    idx);
    for (int j = nh - 1; j >= 1; --j) st.push(idx[j], key[j]);
    return nh > 0 ? idx[0] : st.next(bt, end);
  } else {
    unsigned hit = 0;
    int near = -1, near_idx = 0;
    float near_t = 0.0f;
#pragma unroll
    for (int c = 0; c < K; ++c) {
      float ctmax;
      slab(row.boxes() + 6 * c, r, key[c], ctmax);
      const int cc = __float_as_int(row.children()[c]);
      if (box_hit(key[c], ctmax, bt) && cc > 0) {
        hit |= 1u << c;
        if (near < 0 || key[c] < near_t) {
          near = c;
          near_idx = cc;
          near_t = key[c];
        }
      }
    }
    if (near < 0) return st.next(bt, end);
    hit &= ~(1u << near);
#pragma unroll
    for (int c = K - 1; c >= 0; --c) {
      if ((hit >> c) & 1u) st.push(__float_as_int(row.children()[c]), key[c]);
    }
    return near_idx;
  }
}

// One step of the ordered walk at node `cur` of `tab`: load its meta
// fields, then at a leaf row_leaf, at an internal node its child fields
// and row_descend.
template <int K, Push P, bool kDist, class Table, class Keep>
__device__ __forceinline__ int walk_step(const Table& tab, int cur,
                                         const Ray& r, const float& bt,
                                         EntryStack<kDist>& st, int end,
                                         Keep keep) {
  OrderedRow<K> row;
  row.load_meta(tab, cur);
  if (row.cnt > 0) return row_leaf(tab, row, r, bt, st, end, keep);
  row.load_children();
  return row_descend<K, P>(row, r, bt, st, end);
}

// The end of a persistent warp's work: the last warp of the grid to finish
// sets next_ray[0] (the ray counter) and next_ray[1] (the warps finished)
// back to 0 for the next launch on the stream; every other warp took its
// last rays before it counted itself.
__device__ __forceinline__ void finish_launch(int* __restrict__ next_ray) {
  if ((threadIdx.x & 31) == 0) {
    __threadfence();
    const int warps = static_cast<int>(gridDim.x * (blockDim.x / 32));
    if (atomicAdd(next_ray + 1, 1) == warps - 1) {
      atomicExch(next_ray, 0);
      atomicExch(next_ray + 1, 0);
    }
  }
}

// The end of a persistent walk's warp: with `counts`, add the steps its
// lanes' rays took (`steps`, each lane's own) to counts[0] and the walk
// slots it ran to counts[1]; then finish_launch.
__device__ __forceinline__ void end_walk(
    unsigned long long steps, unsigned long long slots,
    unsigned long long* __restrict__ counts, int* __restrict__ next_ray) {
  if (counts != nullptr) {
    for (int o = 16; o > 0; o >>= 1) {
      steps += __shfl_down_sync(kWarpAll, steps, o);
    }
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(counts, steps);
      atomicAdd(counts + 1, slots);
    }
  }
  finish_launch(next_ray);
}

// The persistent loop of one warp over rays [0, n), which it takes from
// next_ray[0], a counter at 0 when the launch starts: begin(i) starts ray
// i and returns its first node, step(cur) takes one step and returns the
// next node, finish(i, steps) writes ray i's result (`steps` the steps it
// took). A ray ends at `end` or after max_iters steps, as max_iters bounds
// the TPU kernels and the XLA walks.
// The warp takes new rays for its idle lanes when fewer than kRefillBelow
// are live. With `counts`, the warp adds the steps its rays took to
// counts[0] and the lane slots it ran (32 a loop turn) to counts[1]: their
// ratio is its lane use.
template <class Begin, class Step, class Finish>
__device__ __forceinline__ void persistent_walk(
    int n, int end, int max_iters, int* __restrict__ next_ray,
    unsigned long long* __restrict__ counts, Begin begin, Step step,
    Finish finish) {
  const int lane = threadIdx.x & 31;
  int ray = -1, cur = end, it = 0;
  bool drained = false;
  unsigned long long steps = 0, turns = 0;
  for (;;) {
    unsigned live = __ballot_sync(kWarpAll, ray >= 0);
    if (!drained && __popc(live) < kRefillBelow) {
      const unsigned idle = ~live;
      const int want = __popc(idle);
      int first = 0;
      if (lane == 0) first = atomicAdd(next_ray, want);
      first = __shfl_sync(kWarpAll, first, 0);
      drained = first + want >= n;
      if (ray < 0) {
        const int i = first + __popc(idle & ((1u << lane) - 1u));
        if (i < n) {
          ray = i;
          cur = begin(i);
          it = 0;
        }
      }
      live = __ballot_sync(kWarpAll, ray >= 0);
    }
    if (live == 0) break;  // only once the counter is drained
    ++turns;
    if (ray >= 0) {
      if (cur < end && it < max_iters) {
        cur = step(cur);
        ++it;
      }
      if (cur >= end || it >= max_iters) {
        finish(ray, it);
        steps += it;
        ray = -1;
      }
    }
  }
  end_walk(steps, 32ull * turns, counts, next_ray);
}

// persistent_walk with two rays a lane (closest_hit_dual.cu): slot s of a
// lane walks a ray of its own, and the warp's 64 slots take rays from
// next_ray[0] as persistent_walk's lanes do, refilling the idle slots when
// fewer than kRefill are live (one atomicAdd; slot 0's idle lanes take the
// first rays in lane order, then slot 1's, so each slot's rays stay
// neighbours in the caller's order). begin(s, i) starts ray i in slot s
// and returns its first node; turn(run, cur) takes one step of each slot s
// with run[s] set, setting cur[s] to its next node, so that it can issue
// both slots' loads before it uses either; finish(s, i) writes ray i's
// result from slot s. A ray ends at `end` or after max_iters steps. With
// `counts`, the warp adds the steps its rays took to counts[0] and the
// slots it ran (64 a loop turn) to counts[1].
template <int kRefill, class Begin, class Turn, class Finish>
__device__ __forceinline__ void persistent_walk2(
    int n, int end, int max_iters, int* __restrict__ next_ray,
    unsigned long long* __restrict__ counts, Begin begin, Turn turn,
    Finish finish) {
  const unsigned below = (1u << (threadIdx.x & 31)) - 1u;
  int ray[2] = {-1, -1}, cur[2] = {end, end}, it[2] = {0, 0};
  bool drained = false;
  unsigned long long steps = 0, turns = 0;
  for (;;) {
    unsigned live[2] = {__ballot_sync(kWarpAll, ray[0] >= 0),
                        __ballot_sync(kWarpAll, ray[1] >= 0)};
    if (!drained && __popc(live[0]) + __popc(live[1]) < kRefill) {
      const int idle0 = 32 - __popc(live[0]);
      const int want = idle0 + 32 - __popc(live[1]);
      int first = 0;
      if ((threadIdx.x & 31) == 0) first = atomicAdd(next_ray, want);
      first = __shfl_sync(kWarpAll, first, 0);
      drained = first + want >= n;
      const int take[2] = {first + __popc(~live[0] & below),
                           first + idle0 + __popc(~live[1] & below)};
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if (ray[s] < 0 && take[s] < n) {
          ray[s] = take[s];
          cur[s] = begin(s, take[s]);
          it[s] = 0;
        }
        live[s] = __ballot_sync(kWarpAll, ray[s] >= 0);
      }
    }
    if ((live[0] | live[1]) == 0) break;  // only once the counter is drained
    ++turns;
    bool run[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      run[s] = ray[s] >= 0 && cur[s] < end && it[s] < max_iters;
    }
    turn(run, cur);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      it[s] += run[s];
      if (ray[s] >= 0 && (cur[s] >= end || it[s] >= max_iters)) {
        finish(s, ray[s]);
        steps += it[s];
        ray[s] = -1;
      }
    }
  }
  end_walk(steps, 64ull * turns, counts, next_ray);
}

// ---- the persistent preorder walk (#4, 4w, #7, #13) -------------------------
//
// closest_hit_preorder.cu and any_hit_preorder.cu run the preorder walk
// along skip links in the persistent warps of persistent_walk, over the
// fat table, the split tables and the XLA walk's row tables. The walk
// keeps no stack: a lane that takes a new ray resets its cursor, its best
// t and its step count. Each step tests the node's own box, as the plain
// walk does. A step reads what it uses through the read-only path: fields
// [0, 12) of the node row (own box, first slot, count, skip link) first;
// at an internal node whose box the ray enters, the child fields up to
// 9 + 7K; at such a leaf its `count` triangles. Where the table's rows
// and leaf blocks are 16-byte strides from 16-byte aligned bases (the fat
// table; w_rows and leaf_rows at leaf 4, 8, 12, ...), float4 loads (kVec);
// otherwise scalar loads of the same fields.

// blocks an SM that the preorder kernels' __launch_bounds__ ask for, which
// allows up to 128 registers a thread: with it ptxas spills nothing at
// K=8, where without it it kept 72-80 registers and spilled 4-8 bytes, the
// high word of the warp's 64-bit slot count (PERF.md section 6)
constexpr int kPreorderMinBlocks = 4;

// The fields of a K-wide node row that the preorder walk reads, f[i] =
// field i: [0, 6) own box, 6 first slot, 7 count (int bits, low byte),
// 8 skip link, [9, 9 + 6K) child boxes, [9 + 6K, 9 + 7K) child indices.
// kShared: the row lies in shared memory (float4 loads only).
template <int K, bool kVec, bool kShared = false>
struct PreorderRow {
  static_assert(kVec || !kShared, "shared rows are read with float4");
  static constexpr int kFields = 9 + 7 * K;
  static constexpr int kQuads = (kFields + 3) / 4;
  float f[4 * kQuads];

  // fields [4 q0, 4 q1); scalar loads stop at kFields, the row's end in a
  // table of exactly 9 + 7K columns
  template <int q0, int q1>
  __device__ __forceinline__ void load(const float* __restrict__ row) {
#pragma unroll
    for (int q = q0; q < q1; ++q) {
      if constexpr (kVec) {
        const float4 v =
            load4<kShared>(reinterpret_cast<const float4*>(row) + q);
        f[4 * q + 0] = v.x;
        f[4 * q + 1] = v.y;
        f[4 * q + 2] = v.z;
        f[4 * q + 3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (4 * q + j < kFields) f[4 * q + j] = __ldg(row + 4 * q + j);
        }
      }
    }
  }
};

// The hit child of smallest preorder index among the K children whose
// fields `row` holds (packet_descend; absent children carry index 0), -1
// where the ray enters none before bt.
template <int K, bool kVec>
__device__ __forceinline__ int first_hit_child(const PreorderRow<K, kVec>& row,
                                               const Ray& r, float bt) {
  int target = -1;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const int ci = __float_as_int(row.f[9 + 6 * K + c]);
    float ctmin, ctmax;
    slab(row.f + 9 + 6 * c, r, ctmin, ctmax);
    if (box_hit(ctmin, ctmax, bt) && ci > 0 && (target < 0 || ci < target)) {
      target = ci;
    }
  }
  return target;
}

// One step of the preorder walk at node `cur`: test its own box against
// bt; at a leaf the ray enters, leaf(block, first, cnt) tests its
// triangles and returns true to end the walk; at an internal node the ray
// enters, go to the hit child of smallest preorder index (packet_descend;
// absent children carry index 0); otherwise, and where no child is hit,
// follow the skip link. Returns the next node, `end` when leaf() ended the
// walk.
template <int K, bool kVec, class Table, class Leaf>
__device__ __forceinline__ int preorder_step(const Table& tab, int cur,
                                             const Ray& r, float bt, int end,
                                             Leaf leaf) {
  const float* node = tab.node(cur);
  PreorderRow<K, kVec> row;
  row.template load<0, 3>(node);
  const int skip = __float_as_int(row.f[8]);
  float tmin, tmax;
  slab(row.f, r, tmin, tmax);
  if (!box_hit(tmin, tmax, bt)) return skip;
  const int cnt = __float_as_int(row.f[7]) & 0xFF;
  if (cnt > 0) {
    const int first = __float_as_int(row.f[6]);
    return leaf(tab.leaf(node, first), first, cnt) ? end : skip;
  }
  row.template load<3, PreorderRow<K, kVec>::kQuads>(node);
  const int target = first_hit_child(row, r, bt);
  return target >= 0 ? target : skip;
}

// ---- the persistent binary walk (#14) ---------------------------------------
//
// closest_hit_binary.cu runs the binary skip-link walk (traverse_packed)
// over u_rows in the persistent warps of persistent_walk, with no stack,
// as the preorder walk runs. A step reads fields [0, 10) of the node row
// with five float2 loads through the read-only path: u_rows rows are 40
// bytes, so each lies on an 8-byte boundary where the table's base does
// (the wrapper checks it).

// One step of the binary walk at node `cur`: test its own box against bt;
// at a leaf the ray enters, leaf(block, first, cnt) tests its triangles;
// at an internal node it enters, go to cur + 1, its left child in
// preorder; otherwise, and after a leaf, follow the skip link. Returns the
// next node.
// Fields [0, 10) of a binary row (8-byte aligned) into f: five float2
// loads through the read-only path.
__device__ __forceinline__ void load_binary_row(const float* __restrict__ node,
                                                float* f) {
  const float2* row = reinterpret_cast<const float2*>(node);
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const float2 v = __ldg(row + i);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

template <class Leaf>
__device__ __forceinline__ int binary_step(const RowTable& tab, int cur,
                                           const Ray& r, float bt,
                                           Leaf leaf) {
  float f[10];
  load_binary_row(tab.node(cur), f);
  float tmin, tmax;
  slab(f, r, tmin, tmax);
  const int skip = __float_as_int(f[8]);
  if (!box_hit(tmin, tmax, bt)) return skip;
  const int cnt = __float_as_int(f[7]) & 0xFF;
  if (cnt == 0) return cur + 1;
  const int first = __float_as_int(f[6]);
  leaf(tab.leaf(nullptr, first), first, cnt);
  return skip;
}

// Blocks of `kernel` (kWalkThreads threads each, `smem` bytes of dynamic
// shared memory each) resident at once on the current card: its blocks an
// SM times the card's SMs. A launcher asks once and keeps the answer; one
// that asks for more than 48 KB raises the kernel's limit first.
template <class Kernel>
__host__ inline int resident_blocks(Kernel kernel, size_t smem = 0) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                kWalkThreads, smem);
  return per_sm * sms;
}

// Blocks of a persistent launch over n rays: the resident blocks, fewer
// for fewer rays.
__host__ inline int persistent_blocks(int n, int resident) {
  const int need = (n + kWalkThreads - 1) / kWalkThreads;
  return need < resident ? need : resident;
}

// ---- the warp packet walk (#10, #11, #12) ---------------------------------
//
// closest_hit_fat_cache.cu, closest_hit_block_cache.cu and
// closest_hit_row_stage.cu walk packets of
// 32 rays, one warp each, in persistent warps: a warp takes 32 consecutive
// rays from next_ray[0] (persistent_walk's counter, one atomicAdd a packet)
// and walks them all to their ends before it takes more. Each lane keeps
// its own preorder cursor; the packet's cursor is their minimum
// (__reduce_min_sync), and the lanes whose cursor it is take their own
// preorder step there while the others wait. Child indices and skip links
// point forward, so every lane's cursor only grows, the packet's cursor only
// grows, and the packet visits the union of its lanes' walks in node
// order: each lane takes exactly the steps of its own walk and gets its
// (t, slot, u, v). No lane takes a new ray inside a packet: the new ray
// would start at `base`, behind the packet's cursor, and break both the
// growing cursor and the ring's prefetch, which follows it.
//
// The cursor is the same on every lane, so the warp reads one node row and
// at most one leaf block a step, from a ring of two cache blocks of the
// table in the warp's share of dynamic shared memory (TmaRing): every lane
// reads the same address, a broadcast. One lane fills the ring with TMA
// bulk copies that report to an mbarrier per buffer; no thread spends
// registers or instructions on a copy beyond its issue, and nothing wider
// than the warp synchronises. When the cursor enters block b, the ring
// starts the copy of block b + 1 into its other buffer, where the next
// steps most often go (a descent goes to the next node in preorder), so the
// copy overlaps the tests of block b. A ring without prefetch (#11's
// one-row stages, the TPU kernel's schedule) has one buffer and copies a
// row only when the cursor needs another one.

// The shared-memory address of a pointer into shared memory.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Whether the phase of the mbarrier at `bar` with parity `parity` has
// completed (the copies it tracks have landed and are visible).
__device__ __forceinline__ bool mbar_try_wait(unsigned bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// A ring of two buffers of kRows table rows each in shared memory, over a
// table of `rows` rows: buffer `cur` holds the block the cursor is in, the
// other one the next block (a prefetch) or nothing. Every lane of the warp
// holds the same state and makes the same calls; lane 0 issues the copies.
// A demand copy takes the current buffer (the cursor only grows, so its
// block is done with); a prefetch takes the other one. Blocks whose first
// row lies at or past `limit` (rows no walk reads) are never prefetched,
// and the last block is copied only up to the table's end. Without
// kPrefetch the ring is one buffer (a stage): each block the cursor moves
// to is a demand copy into it.
template <int kRows, bool kPrefetch = true>
struct TmaRing {
  static constexpr int kFloats = kRows * kRow;  // a buffer
  static constexpr int kBytes = (kPrefetch ? 2 : 1) * kFloats * 4;

  const float* table;
  int rows, limit;
  float* buf;    // shared, kBytes, 128-byte aligned
  unsigned bar;  // shared address of two 8-byte mbarriers
  int tag0, tag1;  // the block each buffer holds or is loading, -1 none
  int cur;
  unsigned parity;      // bit s: the parity buffer s's next wait waits for
  unsigned pending;     // bit s: a copy into buffer s not yet waited for
  unsigned prefetched;  // bit s: buffer s holds a prefetch not yet used
  unsigned demand, used, discarded;

  // Every lane calls it, before any copy; `bars` is 8-byte aligned.
  __device__ __forceinline__ void init(const float* t, int n_rows, int lim,
                                       float* shared_buf,
                                       unsigned long long* bars) {
    table = t;
    rows = n_rows;
    limit = lim;
    buf = shared_buf;
    bar = smem_addr(bars);
    tag0 = tag1 = -1;
    cur = 0;
    parity = pending = prefetched = 0;
    demand = used = discarded = 0;
    if ((threadIdx.x & 31) == 0) {
      asm volatile(
          "mbarrier.init.shared::cta.b64 [%0], 1;\n\t"
          "mbarrier.init.shared::cta.b64 [%1], 1;\n\t"
          "fence.mbarrier_init.release.cluster;\n" ::"r"(bar),
          "r"(bar + 8)
          : "memory");
    }
    __syncwarp();
  }

  __device__ __forceinline__ int tag(int s) const { return s ? tag1 : tag0; }
  __device__ __forceinline__ void set_tag(int s, int b) {
    tag0 = s ? tag0 : b;
    tag1 = s ? b : tag1;
  }

  // Start the copy of block blk into buffer s, whose earlier copy the warp
  // has waited for and whose rows it has finished reading: __syncwarp
  // orders those reads before the issue, and the proxy fence orders them
  // before the copy engine's writes.
  __device__ __forceinline__ void issue(int s, int blk) {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) {
      const unsigned b = bar + 8 * s;
      const int n = min(kRows, rows - blk * kRows);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      if (n > 0) {
        const unsigned bytes = static_cast<unsigned>(n) * kRow * 4;
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n\t"
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes [%2], [%3], %1, [%0];\n" ::"r"(b),
            "r"(bytes), "r"(smem_addr(buf + s * kFloats)),
            "l"(table + static_cast<size_t>(blk) * kFloats)
            : "memory");
      } else {  // a row past the table (no table of the port has one)
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(b)
                     : "memory");
      }
    }
    set_tag(s, blk);
    pending |= 1u << s;
  }

  __device__ __forceinline__ void wait(int s) {
    if ((pending >> s) & 1u) {
      while (!mbar_try_wait(bar + 8 * s, (parity >> s) & 1u)) {
      }
      parity ^= 1u << s;
      pending &= ~(1u << s);
    }
  }

  __device__ __forceinline__ void prefetch(int s, int blk) {
    if (blk * kRows < limit) {
      issue(s, blk);
      prefetched |= 1u << s;
    } else {
      set_tag(s, -1);
    }
  }

  // Make block blk the current one without waiting for it: a prefetch
  // the ring holds, or a demand copy (which discards the prefetch); then
  // start the prefetch of blk + 1. Without kPrefetch, a demand copy into
  // the one buffer, whose last copy row() has waited for.
  __device__ __forceinline__ void fetch(int blk) {
    if (tag(cur) == blk) return;
    if constexpr (!kPrefetch) {
      ++demand;
      issue(cur, blk);
    } else {
      const int o = cur ^ 1;
      if (tag(o) == blk) {
        ++used;
        prefetched &= ~(1u << o);
        cur = o;
        prefetch(o ^ 1, blk + 1);
      } else {
        ++demand;
        issue(cur, blk);
        wait(o);
        if ((prefetched >> o) & 1u) {
          ++discarded;
          prefetched &= ~(1u << o);
        }
        prefetch(o, blk + 1);
      }
    }
  }

  // Start the copy of row r's block, if the ring has not.
  __device__ __forceinline__ void start(int r) { fetch(r / kRows); }

  // Row r of the table, in shared memory.
  __device__ __forceinline__ const float* row(int r) {
    fetch(r / kRows);
    wait(cur);
    return buf + cur * kFloats + (r % kRows) * kRow;
  }

  // The packet is over: wait for the copies in flight and count the
  // prefetch no step used. The next packet starts empty, so a packet's
  // copies depend on its own rays only.
  __device__ __forceinline__ void end_packet() {
    wait(0);
    wait(1);
    discarded += __popc(prefetched);
    prefetched = 0;
    tag0 = tag1 = -1;
  }
};

// Add a ring's demand copies, prefetches used and prefetches discarded to
// c[2], c[3] and c[4] (one lane calls it).
template <class Ring>
__device__ __forceinline__ void add_ring_counts(const Ring& ring,
                                                unsigned long long* c) {
  atomicAdd(c + 2, static_cast<unsigned long long>(ring.demand));
  atomicAdd(c + 3, static_cast<unsigned long long>(ring.used));
  atomicAdd(c + 4, static_cast<unsigned long long>(ring.discarded));
}

// Dynamic shared memory of one warp whose rings take `ring_bytes`: 128
// bytes of mbarriers (two a ring), then the buffers, 128-byte aligned.
constexpr int warp_smem(int ring_bytes) { return 128 + ring_bytes; }

// The split tables through two rings (TmaRing): node j at rows[j], its
// leaf block at leaf[first / leaf_size], the tables of
// closest_hit_block_cache.cu and closest_hit_row_stage.cu.
template <class Ring>
struct SplitRings {
  Ring nodes, leaves;
  int leaf_size;

  // Every lane calls it: the node ring over rows[0, n_rows), prefetching
  // no row at or past `end`, and the leaf ring over leaf[0, n_leaf), in
  // the warp's `own` dynamic shared memory, warp_smem(2 * Ring::kBytes)
  // bytes from a 128-byte boundary.
  __device__ __forceinline__ void init(const float* rows, int n_rows,
                                       int end, const float* leaf,
                                       int n_leaf, int ls,
                                       unsigned char* own) {
    auto* bars = reinterpret_cast<unsigned long long*>(own);
    auto* bufs = reinterpret_cast<float*>(own + 128);
    leaf_size = ls;
    nodes.init(rows, n_rows, end, bufs, bars);
    leaves.init(leaf, n_leaf, n_leaf, bufs + Ring::kBytes / 4, bars + 2);
  }
  __device__ __forceinline__ void start(int j) { nodes.start(j); }
  __device__ __forceinline__ const float* node(int j) { return nodes.row(j); }
  __device__ __forceinline__ const float* leaf(const float*, int first) {
    return leaves.row(first / leaf_size);
  }
  __device__ __forceinline__ void end_packet() {
    nodes.end_packet();
    leaves.end_packet();
  }
  __device__ __forceinline__ void add_counts(unsigned long long* c) const {
    add_ring_counts(nodes, c);
    add_ring_counts(leaves, c);
  }
};

// The preorder closest-hit of rays [0, n) over nodes [base, end) in warp
// packets (see above). `tab` reads through its rings: start(j) begins the
// copy of node j's block, node(j) gives node j's row and leaf(node, first)
// its leaf block (both in shared memory; every lane calls them with the
// same arguments), end_packet() closes the packet, and add_counts(c) adds
// its rings' copies to c[2], c[3] and c[4]. A lane ends its walk at `end` or after end - base
// steps, as the per-ray walk does. With `counts`, the warp adds its
// packet steps to counts[0], its lanes' steps to counts[1] and its copies
// to counts[2..4] (demand, prefetches used, prefetches discarded), the
// order of traverse.PACKET_COUNTS.
template <int K, class Tables>
__device__ __forceinline__ void warp_packet_closest(
    Tables& tab, const float* __restrict__ org, const float* __restrict__ dir,
    const float* __restrict__ t_max, int n, int base, int end,
    float* __restrict__ t_out, int* __restrict__ slot_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ next_ray, unsigned long long* __restrict__ counts) {
  using Row = PreorderRow<K, true, true>;
  const int lane = threadIdx.x & 31;
  const int max_iters = end - base;
  unsigned long long packet_steps = 0, lane_steps = 0;
  for (;;) {
    int first = 0;
    if (lane == 0) first = atomicAdd(next_ray, 32);
    first = __shfl_sync(kWarpAll, first, 0);
    if (first >= n) break;
    if (base < end) tab.start(base);  // copied while the rays load
    const int i = first + lane;
    const bool live = i < n;
    const Ray r = load_ray(org, dir, live ? i : first);
    Best b{live ? t_max[i] : -kInf, -1, 0.0f, 0.0f};
    int cur = live ? base : end;  // the lane's own cursor
    int it = 0;
    for (;;) {
      const int c = __reduce_min_sync(kWarpAll, cur);
      if (c >= end) break;
      ++packet_steps;
      const bool mine = cur == c;
      const float* node = tab.node(c);
      Row row;
      row.template load<0, 3>(node);
      const int cnt = __float_as_int(row.f[7]) & 0xFF;
      float tmin, tmax;
      slab(row.f, r, tmin, tmax);
      const bool hit = mine && box_hit(tmin, tmax, b.t);
      int next = __float_as_int(row.f[8]);  // skip link
      if (__any_sync(kWarpAll, hit)) {
        if (cnt > 0) {
          const int f = __float_as_int(row.f[6]);
          const float* leaf = tab.leaf(node, f);
          if (hit) closest_in_leaf<true, true>(leaf, f, cnt, r, b);
        } else {
          row.template load<3, Row::kQuads>(node);
          int target = -1;
#pragma unroll
          for (int ch = 0; ch < K; ++ch) {
            const int ci = __float_as_int(row.f[9 + 6 * K + ch]);
            float ctmin, ctmax;
            slab(row.f + 9 + 6 * ch, r, ctmin, ctmax);
            if (box_hit(ctmin, ctmax, b.t) && ci > 0 &&
                (target < 0 || ci < target)) {
              target = ci;
            }
          }
          if (hit && target >= 0) next = target;
        }
      }
      if (mine) cur = ++it < max_iters ? next : end;
    }
    if (live) {
      t_out[i] = b.slot >= 0 ? b.t : kInf;
      slot_out[i] = b.slot;
      u_out[i] = b.u;
      v_out[i] = b.v;
    }
    lane_steps += it;
    tab.end_packet();
  }
  if (counts != nullptr) {
    for (int o = 16; o > 0; o >>= 1) {
      lane_steps += __shfl_down_sync(kWarpAll, lane_steps, o);
    }
    if (lane == 0) {
      atomicAdd(counts, packet_steps);
      atomicAdd(counts + 1, lane_steps);
      tab.add_counts(counts);
    }
  }
  finish_launch(next_ray);
}

// ---- the TLAS walk (tlas_walk.cu) -------------------------------------------
//
// tlas_walk.cu walks the whole scene in one walk: a TLAS over the scene's
// objects (typed singleton leaves: spheres, cubes, cylinders and mesh
// instances) at the head of the XLA walks' node rows (RowTable: binary
// u_rows, or K-wide w_rows), whose instance leaves re-enter the instance's
// BLAS with the ray in its object space (ptsharp_tpu/intersect.py
// traverse_scene). A step (tlas_step) reads a row as the preorder and the
// binary walks read theirs: K-wide rows with PreorderRow's float4 loads,
// fields [0, 12) first and the child quads only at an internal node the
// ray enters; binary rows with binary_step's five float2 loads; at a K
// given at run time, scalar loads. The world->object affines are read as
// three float4 loads (their tables start on 16-byte boundaries, rows of 48
// bytes). The analytic tests and the affine transforms below take the
// order of operations of the plain version (kernels/traverse.py _sphere_t,
// _cube_t, _cyl_t, _affine), so that the kernel equals it on every lane.

// type codes of the TLAS leaves and hit records (ptsharp_tpu_torch/scene.py)
constexpr int kNone = 0, kSphere = 1, kCube = 3, kCylinder = 4;
constexpr int kTriangle = 5, kInstance = 9;
constexpr float kEpsT = 1e-4f;  // least t of an analytic hit

// The tables the TLAS walk reads (kernels/traverse.py _TlasScene, which
// fills it field for field): the node rows and leaf blocks at their
// strides; per instance its world->object affine (3x4, row-major) and its
// BLAS node range [base, end); the analytic primitives in object space,
// each type with its world->object affines, applied where the type's
// xform flag is set. k: children a node row, 0 for binary rows.
struct TlasScene {
  const float* rows;
  const float* leaves;
  const float* inst_inv;
  const int* inst_range;
  const float* sph_center;
  const float* sph_radius;
  const float* sph_inv;
  const float* cube_min;
  const float* cube_max;
  const float* cube_inv;
  const float* cyl_radius;
  const float* cyl_z0;
  const float* cyl_z1;
  const float* cyl_inv;
  int node_stride, leaf_stride, leaf_size, k;
  int n_inst, n_sph, n_cube, n_cyl;
  int sph_xform, cube_xform, cyl_xform;
};

// The ray r under the affine m (3x4, row-major, on a 16-byte boundary:
// three float4 loads): the origin with the translation added last, the
// direction unnormalised (so that t stays the parameter of the
// untransformed ray), and its safe inverse.
__device__ __forceinline__ Ray affine_ray(const float* __restrict__ m,
                                          const Ray& r) {
  const float4* q = reinterpret_cast<const float4*>(m);
  const float4 a0 = __ldg(q), a1 = __ldg(q + 1), a2 = __ldg(q + 2);
  Ray o;
  o.ox = ((a0.x * r.ox + a0.y * r.oy) + a0.z * r.oz) + a0.w;
  o.oy = ((a1.x * r.ox + a1.y * r.oy) + a1.z * r.oz) + a1.w;
  o.oz = ((a2.x * r.ox + a2.y * r.oy) + a2.z * r.oz) + a2.w;
  o.dx = (a0.x * r.dx + a0.y * r.dy) + a0.z * r.dz;
  o.dy = (a1.x * r.dx + a1.y * r.dy) + a1.z * r.dz;
  o.dz = (a2.x * r.dx + a2.y * r.dy) + a2.z * r.dz;
  o.ix = safe_inv(o.dx);
  o.iy = safe_inv(o.dy);
  o.iz = safe_inv(o.dz);
  return o;
}

// Nearest hit t > kEpsT of r on the sphere (c, rad), kInf where none
// (ptsharp_tpu/intersect.py _sphere_t1).
__device__ __forceinline__ float sphere_t(const Ray& r, float cx, float cy,
                                          float cz, float rad) {
  const float ocx = r.ox - cx, ocy = r.oy - cy, ocz = r.oz - cz;
  const float a = (r.dx * r.dx + r.dy * r.dy) + r.dz * r.dz;
  const float b = 2.0f * ((ocx * r.dx + ocy * r.dy) + ocz * r.dz);
  const float cq = ((ocx * ocx + ocy * ocy) + ocz * ocz) - rad * rad;
  const float disc = b * b - (4.0f * a) * cq;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float inv2a = 0.5f / fmaxf(a, 1e-30f);
  const float t0 = (-b - sq) * inv2a;
  const float t1 = (-b + sq) * inv2a;
  const float t = t0 > kEpsT ? t0 : (t1 > kEpsT ? t1 : kInf);
  return disc > 0.0f ? t : kInf;
}

// Entry t > kEpsT of r on the box [lo, hi], kInf where none (_cube_t1).
__device__ __forceinline__ float cube_t(const Ray& r,
                                        const float* __restrict__ lo,
                                        const float* __restrict__ hi) {
  const float nx = (__ldg(lo + 0) - r.ox) * r.ix;
  const float ny = (__ldg(lo + 1) - r.oy) * r.iy;
  const float nz = (__ldg(lo + 2) - r.oz) * r.iz;
  const float fx = (__ldg(hi + 0) - r.ox) * r.ix;
  const float fy = (__ldg(hi + 1) - r.oy) * r.iy;
  const float fz = (__ldg(hi + 2) - r.oz) * r.iz;
  const float t0 =
      fmaxf(fmaxf(fminf(nx, fx), fminf(ny, fy)), fminf(nz, fz));
  const float t1 =
      fminf(fminf(fmaxf(nx, fx), fmaxf(ny, fy)), fmaxf(nz, fz));
  return t0 > kEpsT && t0 < t1 ? t0 : kInf;
}

// Nearest hit t > kEpsT of r on the capped z-cylinder (rad, z0, z1),
// kInf where none (_cyl_t1).
__device__ __forceinline__ float cyl_t(const Ray& r, float rad, float z0,
                                       float z1) {
  const float den =
      fabsf(r.dz) < 1e-30f ? (r.dz < 0.0f ? -1e-30f : 1e-30f) : r.dz;
  const float tz0 = (z0 - r.oz) / den;
  const float tz1 = (z1 - r.oz) / den;
  const float r2 = rad * rad;
  auto cap = [&](float tc) {
    const float px = r.ox + r.dx * tc;
    const float py = r.oy + r.dy * tc;
    return tc > kEpsT && px * px + py * py <= r2 ? tc : kInf;
  };
  const float a = r.dx * r.dx + r.dy * r.dy;
  const float b = 2.0f * (r.ox * r.dx + r.oy * r.dy);
  const float c = (r.ox * r.ox + r.oy * r.oy) - r2;
  const float disc = b * b - (4.0f * a) * c;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float inv2a = 0.5f / fmaxf(a, 1e-30f);
  const float tl0 = (-b - sq) * inv2a;
  const float tl1 = (-b + sq) * inv2a;
  auto lat = [&](float tl) {
    const float z = r.oz + r.dz * tl;
    return tl > kEpsT && z >= z0 && z <= z1 && disc >= 0.0f;
  };
  const float t_lat = lat(tl0) ? tl0 : (lat(tl1) ? tl1 : kInf);
  return fminf(fminf(cap(tz1), cap(tz0)), t_lat);
}

// The hit t of r on the analytic leaf of type `kind` naming primitive
// `first` (clamped to its table, as traverse_scene clamps it), in the
// primitive's object space where its type is transformed.
__device__ __forceinline__ float analytic_t(const TlasScene& sc, int kind,
                                           int first, const Ray& r) {
  auto pick = [](int i, int n) { return i < 0 ? 0 : (i >= n ? n - 1 : i); };
  if (kind == kSphere && sc.n_sph > 0) {
    const int p = pick(first, sc.n_sph);
    const Ray o = sc.sph_xform ? affine_ray(sc.sph_inv + 12 * p, r) : r;
    return sphere_t(o, __ldg(sc.sph_center + 3 * p),
                    __ldg(sc.sph_center + 3 * p + 1),
                    __ldg(sc.sph_center + 3 * p + 2),
                    __ldg(sc.sph_radius + p));
  }
  if (kind == kCube && sc.n_cube > 0) {
    const int p = pick(first, sc.n_cube);
    const Ray o = sc.cube_xform ? affine_ray(sc.cube_inv + 12 * p, r) : r;
    return cube_t(o, sc.cube_min + 3 * p, sc.cube_max + 3 * p);
  }
  if (kind == kCylinder && sc.n_cyl > 0) {
    const int p = pick(first, sc.n_cyl);
    const Ray o = sc.cyl_xform ? affine_ray(sc.cyl_inv + 12 * p, r) : r;
    return cyl_t(o, __ldg(sc.cyl_radius + p), __ldg(sc.cyl_z0 + p),
                 __ldg(sc.cyl_z1 + p));
  }
  return kInf;
}

// leaf_slots for the TLAS walk, which holds the analytic tests' and the
// instance entry's state beside a leaf's: one triangle at a time, its
// nine floats from the three float4 loads that cover them (triangle l
// starts l mod 4 floats past a 16-byte boundary of a block whose stride is
// a multiple of 4 floats: leaf 4, 8, ...), or with kVec false from nine
// scalar loads; so at most twelve floats of the block are live, where
// leaf_slots<true> holds four triangles' 36.
template <bool kVec, class Keep>
__device__ __forceinline__ void leaf_each(const float* __restrict__ leaf,
                                          int cnt, const Ray& r, Keep keep) {
  if constexpr (!kVec) {
    leaf_slots<false>(leaf, cnt, r, keep);
  } else {
    const float4* p = reinterpret_cast<const float4*>(leaf);
    for (int g = 0; g < cnt; g += 4) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int l = g + j;
        if (l >= cnt) return;
        float f[12];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float4 v = __ldg(p + 9 * (g / 4) + (9 * j) / 4 + i);
          f[4 * i + 0] = v.x;
          f[4 * i + 1] = v.y;
          f[4 * i + 2] = v.z;
          f[4 * i + 3] = v.w;
        }
        float tt, uu, vv;
        if (mt(f + j, r, tt, uu, vv) && keep(l, tt, uu, vv)) return;
      }
    }
  }
}

// K of a TLAS walk instance that reads K from the table at run time
constexpr int kRunTimeK = -1;

// One step of the TLAS walk at node `cur` of `tab`, whose rows hold K
// children (K = 4, 8: w_rows, float4 loads; K = 0: binary u_rows, five
// float2 loads; K = kRunTimeK: k children, 0 for binary rows, scalar
// loads): test the node's own box against bt; at a leaf the ray enters
// (a kind other than kNone in bits 8-11 of its count field), return
// leaf(kind, first, count, skip), the next node; at an internal node it
// enters, go to the hit child of smallest preorder index (binary rows: to
// cur + 1), as preorder_step does; otherwise, and where no child is hit,
// follow the skip link.
template <int K, class Leaf>
__device__ __forceinline__ int tlas_step(const RowTable& tab, int k, int cur,
                                         const Ray& r, float bt, Leaf leaf) {
  const float* node = tab.node(cur);
  // the row's fields; at K <= 0 only [0, 10) are used
  PreorderRow<(K > 0 ? K : 1), true> row;
  if constexpr (K > 0) {
    row.template load<0, 3>(node);
  } else if constexpr (K == 0) {
    load_binary_row(node, row.f);
  } else {
#pragma unroll
    for (int i = 0; i < 9; ++i) row.f[i] = __ldg(node + i);
  }
  const int skip = __float_as_int(row.f[8]);
  float tmin, tmax;
  slab(row.f, r, tmin, tmax);
  if (!box_hit(tmin, tmax, bt)) return skip;
  const int meta = __float_as_int(row.f[7]);
  const int kind = (meta >> 8) & 0xF;
  if (kind != kNone) {
    return leaf(kind, __float_as_int(row.f[6]), meta & 0xFF, skip);
  }
  int target = -1;
  if constexpr (K > 0) {
    row.template load<3, PreorderRow<K, true>::kQuads>(node);
    target = first_hit_child(row, r, bt);
  } else {
    if (K == 0 || k == 0) return cur + 1;
    for (int c = 0; c < k; ++c) {
      float b6[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) b6[i] = __ldg(node + 9 + 6 * c + i);
      const int ci = __float_as_int(__ldg(node + 9 + 6 * k + c));
      float ctmin, ctmax;
      slab(b6, r, ctmin, ctmax);
      if (box_hit(ctmin, ctmax, bt) && ci > 0 &&
          (target < 0 || ci < target)) {
        target = ci;
      }
    }
  }
  return target >= 0 ? target : skip;
}

}  // namespace ptk
