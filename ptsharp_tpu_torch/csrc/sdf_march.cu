// A whole sphere trace of one SDF tree in one launch: each lane marches
// its ray to its end, the tree read as a postfix program.
//
// Replaces no TPU kernel: the JAX package marches with lax.while_loop
// (ptsharp_tpu/geometry/sdf.py sphere_trace), whose body XLA fuses. The
// port's plain march (geometry/march.py over geometry/sdf.py's torch ops)
// runs each step as ~100 one-op launches over the active lanes, and the
// lockstep loop runs every march to its slowest lane; here one lane runs
// SDF.cs's loop on its own (step, jump back once, accept under TRACE_EPS,
// stop past t_exit or at max_steps), so a lane takes exactly the steps it
// takes in the lockstep loop, which writes a lane only while it is active,
// and hit_t is the plain march's bit for bit.
//
// The program (geometry/sdf.py compile_program): int32 instructions
// (op, constant offset, flags) in postfix order and a float32 constant
// buffer. A leaf pushes its distance at the current point; a join pops two
// distances and pushes one; a point op (affine, divide, repeat) saves the
// current point and replaces it for its subtree, `pop` restores it. The
// op codes are kernels/sdf_march.py OPS, in order.
//
// Bits: every float op is the one the torch op computes, in the order of
// geometry/sdf.py (vec.sum_last's left-to-right sums, vec.affine's float32
// product then two float64 multiply-adds, constants rounded to float32
// first); the library's -fmad=false keeps each multiply and add separate,
// as torch's one-op kernels do. Where ATen's CUDA kernels differ from a
// plain C expression it follows them: torch.minimum/maximum and clamp
// propagate NaN; torch.remainder is fmod moved to the divisor's sign;
// vec.pow_f32's float64 pow takes ATen's special exponents (0, 1, +-0.5,
// -1, 2, 3, -2) as ATen does.
//
// What bounds it on an H100: float32 operations, ~155 a lane step for
// PTSharp's CSG demo (perfbench/march_ops.py), and steps that vary from 1
// to ~1,000 between neighbouring rays. The design:
//   - persistent warps, bvh_common.cuh's persistent_walk: a grid of the
//     resident 128-thread blocks, each warp taking rays from one counter
//     and refilling its idle lanes when fewer than kRefillBelow are live,
//     so a warp does not carry its slowest lane; a ray that misses the
//     tree's box (active0 false) ends at its first turn, with no step;
//   - the program and constants through the read-only path, one address
//     for the whole warp a step (every live lane runs the same op);
//   - the current point and the top distance in registers, the saved
//     ones in two small per-lane stacks (local memory, kStack deep:
//     geometry/sdf.py compile_program refuses a deeper tree);
//   - launched on the caller's stream; allocates nothing, no sync.
// Each entry returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

#include "bvh_common.cuh"

namespace {

// kernels/sdf_march.py OPS, in order
enum Op : int {
  kSphere = 0,    // r
  kSphereN,       // e, 1/e, r: |p|_e - r
  kCube,          // size xyz
  kCylinder,      // r, height
  kCapsule,       // a xyz, b xyz, r
  kCapsuleN,      // a xyz, b xyz, r, e, 1/e
  kTorus,         // major, minor, e major, 1/e, e minor, 1/e; flags: the
                  // major (1) and minor (2) norms are Euclidean
  kUnion,         // min
  kIntersection,  // max
  kDifference,    // max(d, -e)
  kAffine,        // 3x4 row-major: the point becomes M p
  kDivide,        // f: the point becomes p / f
  kRepeat,        // step xyz: floor-mod tiling
  kPop,           // restore the point saved by the last point op
  kScale,         // f: the distance becomes d * f
};

// saved points and distances a lane (kernels/sdf_march.py STACK)
constexpr int kStack = 16;

// sphere-trace constants (geometry/sdf.py, SDF.cs:34-37), as float32
constexpr float kTraceEps = 1e-5f;
constexpr float kTraceJump = 1e-3f;

struct P3 {
  float x, y, z;
};

// torch.minimum / torch.maximum on the card: NaN in either wins
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
// torch.clamp(v, min=lo), (max=hi): NaN passes
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return v != v ? v : fminf(v, hi);
}
// torch.amax over the last axis: NaN wins
__device__ __forceinline__ float amax2(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float amax3(float a, float b, float c) {
  return amax2(amax2(a, b), c);
}
// torch.remainder: fmod moved to the divisor's sign
__device__ __forceinline__ float floor_mod(float a, float b) {
  float mod = fmodf(a, b);
  if (mod != 0.0f && ((b < 0.0f) != (mod < 0.0f))) mod += b;
  return mod;
}

// torch.pow of a float64 tensor by a Python exponent on the card: ATen's
// special exponents first, then the library pow
__device__ __forceinline__ double aten_pow(double b, double e) {
  if (e == 0.0) return 1.0;
  if (e == 1.0) return b;
  if (e == 0.5) return sqrt(b);
  if (e == -0.5) return rsqrt(b);
  if (e == -1.0) return 1.0 / b;
  if (e == 2.0) return b * b;
  if (e == 3.0) return b * b * b;
  if (e == -2.0) return 1.0 / (b * b);
  return pow(b, e);
}

// vec.pow_f32 of a float32 x: in float64, rounded once
__device__ __forceinline__ float pow_f32(float x, float e) {
  return static_cast<float>(aten_pow(static_cast<double>(x),
                                     static_cast<double>(e)));
}

// vec.length: sqrt(clamp(dot(a, a), min=0)), the dot left to right
__device__ __forceinline__ float length3(float x, float y, float z) {
  return sqrtf(clamp_min(x * x + y * y + z * z, 0.0f));
}

// vec.length_n: (|x|^e + |y|^e + |z|^e)^(1/e), each power vec.pow_f32
__device__ __forceinline__ float length3_n(float x, float y, float z,
                                           float e, float inv) {
  const float s = pow_f32(fabsf(x), e) + pow_f32(fabsf(y), e) +
                  pow_f32(fabsf(z), e);
  return pow_f32(s, inv);
}

// SdfTorus._norm of (a, b): Euclidean (vec.sqrt(vec.dot)) or by exponent
__device__ __forceinline__ float norm2(float a, float b, bool two, float e,
                                       float inv) {
  if (two) return sqrtf(a * a + b * b);
  return pow_f32(pow_f32(fabsf(a), e) + pow_f32(fabsf(b), e), inv);
}

__device__ __forceinline__ float sphere(const float* c, P3 p) {
  return length3(p.x, p.y, p.z) - c[0];
}

__device__ __forceinline__ float sphere_n(const float* c, P3 p) {
  return length3_n(p.x, p.y, p.z, c[0], c[1]) - c[2];
}

__device__ __forceinline__ float cube(const float* c, P3 p) {
  const float qx = fabsf(p.x) - c[0] * 0.5f;
  const float qy = fabsf(p.y) - c[1] * 0.5f;
  const float qz = fabsf(p.z) - c[2] * 0.5f;
  const float outside = length3(clamp_min(qx, 0.0f), clamp_min(qy, 0.0f),
                                clamp_min(qz, 0.0f));
  const float inside = clamp_max(amax3(qx, qy, qz), 0.0f);
  return outside + inside;
}

__device__ __forceinline__ float cylinder(const float* c, P3 p) {
  const float dx = sqrtf(p.x * p.x + p.z * p.z) - c[0];
  const float dy = fabsf(p.y) - c[1] * 0.5f;
  const float ox = clamp_min(dx, 0.0f);
  const float oy = clamp_min(dy, 0.0f);
  const float outside = sqrtf(ox * ox + oy * oy);
  const float inside = clamp_max(amax2(dx, dy), 0.0f);
  return outside + inside;
}

// SdfCapsule: the offset from the segment; the caller takes its length
__device__ __forceinline__ P3 capsule_offset(const float* c, P3 p) {
  const float pax = p.x - c[0], pay = p.y - c[1], paz = p.z - c[2];
  const float bax = c[3] - c[0], bay = c[4] - c[1], baz = c[5] - c[2];
  const float num = pax * bax + pay * bay + paz * baz;
  const float den = clamp_min(bax * bax + bay * bay + baz * baz, 1e-12f);
  const float h = clamp_max(clamp_min(num / den, 0.0f), 1.0f);
  return P3{pax - bax * h, pay - bay * h, paz - baz * h};
}

__device__ __forceinline__ float torus(const float* c, int flags, P3 p) {
  const float a = norm2(p.x, p.y, flags & 1, c[2], c[3]) - c[0];
  return norm2(a, p.z, flags & 2, c[4], c[5]) - c[1];
}

// vec.affine: each row the float32 product of column 0, then columns 1
// and 2 as float64 multiply-adds rounded to float32, then the translation
__device__ __forceinline__ float affine_row(const float* m, P3 p) {
  float q = m[0] * p.x;
  q = static_cast<float>(static_cast<double>(q) +
                         static_cast<double>(m[1]) * static_cast<double>(p.y));
  q = static_cast<float>(static_cast<double>(q) +
                         static_cast<double>(m[2]) * static_cast<double>(p.z));
  return q + m[3];
}

// The tree's distance at p: the program run once.
__device__ float evaluate(const int* __restrict__ prog, int n_ops,
                          const float* __restrict__ k, P3 p) {
  float d = 0.0f;  // the top distance; the ones below it in ds
  float ds[kStack];
  P3 ps[kStack];
  int nd = 0, np = 0;
  for (int pc = 0; pc < n_ops; ++pc) {
    const int op = __ldg(prog + 3 * pc);
    const float* c = k + __ldg(prog + 3 * pc + 1);
    float leaf;
    switch (op) {
      case kSphere:
        leaf = sphere(c, p);
        break;
      case kSphereN:
        leaf = sphere_n(c, p);
        break;
      case kCube:
        leaf = cube(c, p);
        break;
      case kCylinder:
        leaf = cylinder(c, p);
        break;
      case kCapsule: {
        const P3 o = capsule_offset(c, p);
        leaf = length3(o.x, o.y, o.z) - c[6];
        break;
      }
      case kCapsuleN: {
        const P3 o = capsule_offset(c, p);
        leaf = length3_n(o.x, o.y, o.z, c[7], c[8]) - c[6];
        break;
      }
      case kTorus:
        leaf = torus(c, __ldg(prog + 3 * pc + 2), p);
        break;
      case kUnion:
        d = tmin(ds[--nd], d);
        continue;
      case kIntersection:
        d = tmax(ds[--nd], d);
        continue;
      case kDifference:
        d = tmax(ds[--nd], -d);
        continue;
      case kScale:
        d = d * c[0];
        continue;
      case kAffine:
        ps[np++] = p;
        p = P3{affine_row(c, p), affine_row(c + 4, p), affine_row(c + 8, p)};
        continue;
      case kDivide:
        ps[np++] = p;
        p = P3{p.x / c[0], p.y / c[0], p.z / c[0]};
        continue;
      case kRepeat:
        ps[np++] = p;
        p = P3{floor_mod(p.x, c[0]) - c[0] * 0.5f,
               floor_mod(p.y, c[1]) - c[1] * 0.5f,
               floor_mod(p.z, c[2]) - c[2] * 0.5f};
        continue;
      case kPop:
        p = ps[--np];
        continue;
      default:
        continue;
    }
    // a leaf: push its distance
    ds[nd++] = d;
    d = leaf;
  }
  return d;
}

__global__ void __launch_bounds__(ptk::kWalkThreads)
sdf_march_kernel(const int* __restrict__ prog, int n_ops,
                 const float* __restrict__ consts,
                 const float* __restrict__ org, const float* __restrict__ dir,
                 const float* __restrict__ t0,
                 const float* __restrict__ t_exit,
                 const unsigned char* __restrict__ active0, int n,
                 int max_steps, float* __restrict__ hit_out,
                 int* __restrict__ next_ray,
                 unsigned long long* __restrict__ counts) {
  // the lane's ray: origin, direction, t, its exit, its hit t, jump flag
  P3 o{}, d{};
  float t = 0.0f, te = 0.0f, hit_t = ptk::kInf;
  bool jump = false;
  unsigned long long most = 0;
  // a ray marches at node 0 and ends at node 1
  ptk::persistent_walk(
      n, 1, max_steps, next_ray, counts,
      [&](int i) {
        hit_t = ptk::kInf;
        if (!__ldg(active0 + i)) return 1;  // it misses the tree's box
        o = P3{__ldg(org + 3 * i), __ldg(org + 3 * i + 1),
               __ldg(org + 3 * i + 2)};
        d = P3{__ldg(dir + 3 * i), __ldg(dir + 3 * i + 1),
               __ldg(dir + 3 * i + 2)};
        t = __ldg(t0 + i);
        te = __ldg(t_exit + i);
        jump = true;
        return 0;
      },
      [&](int) {
        // sdf.sphere_trace's step on an active lane
        const P3 p{o.x + d.x * t, o.y + d.y * t, o.z + d.z * t};
        const float dist = evaluate(prog, n_ops, consts, p);
        const bool back = jump && dist < 0.0f;
        const bool hit = !back && dist < kTraceEps;
        if (hit) hit_t = t;
        const float stride = (jump && dist < kTraceJump) ? kTraceJump : dist;
        t = back ? t - kTraceJump : t + stride;
        jump = jump && !back;
        return (hit || t > te) ? 1 : 0;
      },
      [&](int i, int steps) {
        hit_out[i] = hit_t;
        const unsigned long long s = steps;
        most = s > most ? s : most;
      });
  if (counts != nullptr) {
    for (int s = 16; s > 0; s >>= 1) {
      const unsigned long long other =
          __shfl_down_sync(ptk::kWarpAll, most, s);
      most = other > most ? other : most;
    }
    if ((threadIdx.x & 31) == 0) atomicMax(counts + 2, most);
  }
}

}  // namespace

// prog: n_ops x (op, constant offset, flags) int32; consts: float32;
// org, dir (n, 3), t0, t_exit (n,) float32 and active0 (n,) bool, as
// geometry/sdf.py sphere_trace makes them; hit_out (n,) float32;
// next_ray: two ints, 0 and 0 (the persistent walks' ray counter, 0 again
// when the kernel ends); counts: null, or three unsigned 64-bit ints to
// which the kernel adds [active lane steps, lane slots] and raises [the
// most steps a lane took].
extern "C" int pt_sdf_march(const int* prog, int n_ops, const float* consts,
                            const float* org, const float* dir,
                            const float* t0, const float* t_exit,
                            const unsigned char* active0, int n,
                            int max_steps, float* hit_out, int* next_ray,
                            unsigned long long* counts, void* stream) {
  static const int resident = ptk::resident_blocks(sdf_march_kernel);
  if (n > 0) {
    sdf_march_kernel<<<ptk::persistent_blocks(n, resident),
                       ptk::kWalkThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        prog, n_ops, consts, org, dir, t0, t_exit, active0, n, max_steps,
        hit_out, next_ray, counts);
  }
  return static_cast<int>(cudaGetLastError());
}
