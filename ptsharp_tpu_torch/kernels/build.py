"""Build and load the CUDA kernels of csrc/ as one shared library.

nvcc compiles each csrc/*.cu for sm_90a into an object, one nvcc process
per source, all started together, and links the objects into
`build/ptsharp_tpu_torch/` (a directory .gitignore lists), at first use,
with a plain C interface that ctypes binds: every pointer and the stream
are c_void_p, each entry returns cudaGetLastError(). The library name
carries a hash of the sources and flags, so an edited source is rebuilt
and an unchanged one is reused. `-fmad=false` keeps every multiply and
add rounding on its own, as the plain PyTorch versions and the JAX
reference round them.

Every wrapper of a C entry (kernels/traverse.py, threefry.py,
sdf_march.py) launches it through `launch`, which also keeps the
persistent kernels' ray counter of each stream. This module imports
nothing from the package.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "ptsharp_tpu_torch")
# traversal stack entries per ray of the ordered kernels (PT_STACK_CAP), as
# the JAX ordered kernels hold per group; ordered scene builds check
# max_stack_bound against it (the full bunny needs 43), and the plain
# ordered walk holds as many (accel/traverse.py STACK_CAPACITY)
STACK_CAPACITY = 128
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-fmad=false",
    "-Xptxas", "-v", f"-DPT_STACK_CAP={STACK_CAPACITY}",
]

_lock = threading.Lock()
_lib = None
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode())
            h.update(f.read())
    return h.hexdigest()[:16]


def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    # the persistent walks over the fat table: fat, rays, t, n, base, end,
    # k, outputs, the ray counter, [steps, lane slots] or null, stream
    persistent_closest = [vp, vp, vp, vp, ci, ci, ci, ci,
                          vp, vp, vp, vp, vp, vp, vp]
    persistent_any = [vp, vp, vp, vp, ci, ci, ci, ci, vp, vp, vp, vp]
    # the persistent ordered walks over the split tables: rows, leaf, rays,
    # t, n, base, end, leaf_size, k, [near], outputs, [steps or null], the
    # ray counter, [steps, lane slots] or null, stream
    closest_split = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci,
                     vp, vp, vp, vp, vp, vp, vp, vp]
    anyhit_split = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp, vp, vp, vp]
    # the warp packets (#10, #11, #12): their tables' row counts after the
    # tables, rays, t, n, base, end, leaf_size, k, outputs, the ray
    # counter, [5] counts or null, stream
    fat_packet = [vp, ci, vp, vp, vp, ci, ci, ci, ci, ci,
                  vp, vp, vp, vp, vp, vp, vp]
    split_packet = [vp, vp, ci, ci, vp, vp, vp, ci, ci, ci, ci, ci,
                    vp, vp, vp, vp, vp, vp, vp]
    # the persistent walk over the split tables: rows, leaf, rays, t, n,
    # base, end, leaf_size, k, outputs, the ray counter, [steps, lane
    # slots] or null, stream
    split_persistent = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                        vp, vp, vp, vp, vp, vp, vp]
    # the persistent walks over the XLA walks' row tables: rows, leaf,
    # their strides, float4 or scalar loads, rays, t, n, base, end,
    # leaf_size, [k], max_iters, outputs, the ray counter, [steps, lane
    # slots] or null, stream
    binary = [vp, vp, ci, ci, ci, vp, vp, vp, ci, ci, ci, ci, ci,
              vp, vp, vp, vp, vp, vp, vp]
    rows_closest = [vp, vp, ci, ci, ci, vp, vp, vp, ci, ci, ci, ci, ci, ci,
                    vp, vp, vp, vp, vp, vp, vp]
    rows_any = [vp, vp, ci, ci, ci, vp, vp, vp, ci, ci, ci, ci, ci, ci,
                vp, vp, vp, vp]
    # the TLAS walks: the TlasScene, the instance's K and leaf loads, rays,
    # t, n, the TLAS head [root, tlas_end), max_iters, outputs (t, kind,
    # index, inst, u, v; or the occlusion), the ray counter, [steps, lane
    # slots] or null, stream
    tlas_closest = [vp, ci, ci, vp, vp, vp, ci, ci, ci, ci,
                    vp, vp, vp, vp, vp, vp, vp, vp, vp]
    tlas_any = [vp, ci, ci, vp, vp, vp, ci, ci, ci, ci, vp, vp, vp, vp]
    for fn, argtypes in ((lib.pt_closest_hit, persistent_closest),
                         (lib.pt_any_hit, persistent_any),
                         (lib.pt_closest_hit_preorder, persistent_closest),
                         (lib.pt_any_hit_preorder, persistent_any),
                         (lib.pt_closest_hit_split, closest_split),
                         (lib.pt_any_hit_split, anyhit_split),
                         (lib.pt_closest_hit_packet, split_persistent),
                         (lib.pt_closest_hit_dual, persistent_closest),
                         (lib.pt_closest_hit_fat_cache, fat_packet),
                         (lib.pt_closest_hit_block_cache, split_packet),
                         (lib.pt_closest_hit_row_stage, split_packet),
                         (lib.pt_closest_hit_binary, binary),
                         (lib.pt_closest_hit_wide_rows, rows_closest),
                         (lib.pt_any_hit_wide_rows, rows_any),
                         (lib.pt_closest_hit_tlas, tlas_closest),
                         (lib.pt_any_hit_tlas, tlas_any)):
        fn.restype = ci
        fn.argtypes = argtypes
    # the threefry draws (csrc/threefry.cu): output, words, the key's words
    # (randint: both sub-keys', the span, the multiplier and minval),
    # stream
    u32, i64 = ctypes.c_uint32, ctypes.c_int64
    for fn, argtypes in (
            (lib.pt_threefry_uniform, [vp, i64, u32, u32, vp]),
            (lib.pt_threefry_randint,
             [vp, i64, u32, u32, u32, u32, u32, u32, i64, vp])):
        fn.restype = ci
        fn.argtypes = argtypes
    # the sphere trace (csrc/sdf_march.cu): the program's code, its op
    # count and constants, org, dir, t0, t_exit, active0, n, max_steps,
    # hit t, the ray counter, [3] counts or null, stream
    lib.pt_sdf_march.restype = ci
    lib.pt_sdf_march.argtypes = [vp, ci, vp, vp, vp, vp, vp, vp, ci, ci,
                                 vp, vp, vp, vp]
    # the warp packets' ring block (table rows), dynamic shared memory and
    # whether their rings prefetch
    for name in ("fat_cache", "block_cache", "row_stage"):
        for what in ("block_rows", "smem", "prefetch"):
            fn = getattr(lib, f"pt_closest_hit_{name}_{what}")
            fn.restype = ci
            fn.argtypes = []
    return lib


def _run(cmds: list[list[str]]) -> str:
    """Run the commands side by side; their stderr (ptxas's report)
    joined, or RuntimeError naming the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    errs = []
    for c, p in zip(cmds, procs):
        _out, err = p.communicate(timeout=900)
        if p.returncode != 0:
            for q in procs:
                q.kill()
                q.wait()
            raise RuntimeError(f"{' '.join(c)} failed ({p.returncode}):\n"
                               f"{err}")
        errs.append(err)
    return "".join(errs)


def _compile(so: str) -> str:
    """Compile every source into an object in parallel and link them
    into `so`; returns ptxas's report."""
    objdir = f"{so}.{os.getpid()}.obj"
    os.makedirs(objdir, exist_ok=True)
    try:
        nvcc = _nvcc()
        objs = [os.path.join(objdir, os.path.basename(src) + ".o")
                for src in _sources()]
        report = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                       for src, obj in zip(_sources(), objs)])
        tmp = f"{so}.{os.getpid()}.tmp"
        _run([[nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, so)
    finally:
        shutil.rmtree(objdir, ignore_errors=True)
    return report


def load():
    """The loaded kernel library, compiling it first if needed. Records
    the compile seconds and nvcc's resource report in `build_info`."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = os.path.join(BUILD_DIR, f"libptkernels_{_digest()}.so")
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            t0 = time.perf_counter()
            build_info["ptxas"] = _compile(so)
            build_info["seconds"] = time.perf_counter() - t0
        else:
            build_info.setdefault("seconds", 0.0)
        build_info["library"] = so
        _lib = _bind(ctypes.CDLL(so))
        return _lib


# (device index, stream) -> the two ints of the persistent kernels' ray
# counter on that stream: zeroed once here, and by the kernel's last warp
# at the end of each launch, so a launch fills nothing first
_RAY_COUNTERS = {}


def launch(wrapper, entry: str, device, *args, persistent: bool = False,
           counts=None, **added: int) -> None:
    """Call the library's C entry `entry` on the current stream of
    `device`: `args`, then for a persistent kernel (whose warps take rays
    from the stream's ray counter) that counter and the pointer of
    `counts` (a tensor the kernel adds to, or null), then the stream. A
    nonzero return raises RuntimeError naming the entry, and drops the
    ray counter, which a failed launch may leave set. Else the launch
    adds one to `wrapper.launches` and each of `added` (its rays, its
    words) to the wrapper's attribute of that name."""
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (device.index, stream)
    if persistent:
        if key not in _RAY_COUNTERS:
            _RAY_COUNTERS[key] = torch.zeros(2, dtype=torch.int32,
                                             device=device)
        args += (_RAY_COUNTERS[key].data_ptr(),
                 None if counts is None else counts.data_ptr())
    err = getattr(load(), entry)(*args, stream)
    if err:
        if persistent:
            del _RAY_COUNTERS[key]
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
    wrapper.launches += 1
    for name, n in added.items():
        setattr(wrapper, name, getattr(wrapper, name) + n)
