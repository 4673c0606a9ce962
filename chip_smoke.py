#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ptsharp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and nvcc. It
builds the CUDA kernels from csrc/ (into build/ptsharp_tpu_torch/), then:

  1. device   name and power limit as nvidia-smi reports them;
  2. build    nvcc build time and each kernel's registers, stack frame,
              spills and static shared memory as ptxas reports them (each
              tlas_walk instance: closest or any, its K, its leaf loads),
              and
              the dynamic shared memory each staged kernel's launch asks
              for;
  2b. rng    the threefry draws of core/rng.py (rng_phase): each
              csrc/threefry.cu entry at the main path's shapes, a
              (4,147,200,) and a (2, 4,147,200) uniform and a (4,147,200,)
              randint over the bunny's one light, against the plain path
              (the torch block on the card) bit for bit, timed beside it
              (card ms by CUDA events, device ms behind a spin kernel)
              and beside its bound (OPS_WORD integer operations a word at
              PEAK_INT32, or WORD_BYTES a word written at PEAK_BYTES,
              whichever is larger); and the host-device syncs a draw
              makes, counted under torch.cuda.set_sync_debug_mode("warn"):
              none by the kernel, one by a CPU key copied to the card as
              the draw did before it;
  2c. march  the SDF sphere trace (march_phase): csrc/sdf_march.cu's one
              launch a march at the sdf_csg configuration's main path
              (examples.build("sdf") at 1920x1080, its 2,073,600 camera
              rays, 1 spp through the thin lens, clipped to the tree's
              box) against the lockstep march on the card (the kernel
              route off), hit t bit for bit and the active lane steps
              alike, timed beside it (card ms: median of 5 CUDA-event
              timings; plain ms once after a warm-up) and beside its bound
              (the active lane steps times perfbench.march_ops's
              operations of a lane step of the configuration's tree, at
              PEAK_F32);
  2d. tsum   the table sum (tsum_phase): the sums of one tape gradient
              of the bunny.train cell's shapes (examples.build("bunny")
              at 1920x1080, 1 spp, the colours a leaf, an MSE to 0.5)
              captured at csrc/table_sum.cu's two call sites (the tape
              backward's material sums, the atlas fetches' texels), each
              against its float64 sum (raising past TSUM_RTOL of the
              sum of its rows' absolute values), timed by kind
              (mid, lm, texels: device ms behind a spin kernel, the
              wrapper's call and index_add_ into zeros alone on the
              same inputs) beside its bound (each lane's id and row read
              once and the table written once, at PEAK_BYTES), with its
              lanes, active lanes and adds (profiling.
              table_sum_counters()) and ptxas's registers and spills;
  3. bunny    examples.build("bunny", intersector="pallas", wide_k=8): the
              full 81,920-triangle bunny, its BVH builder, table size and
              max_stack_bound;
  4. kernels  all four fat-table kernels, each persistent, against their
              plain versions, on Morton-ordered camera rays plus scattered
              bounce rays from their hit points, 2**16 + 2**16 rays and the
              1080p main-path width: closest-hit (t, slot, u and v equal on
              every lane), any-hit on shadow rays from the bounce origins
              toward the light, t_cut formed as sample_lights forms it
              (equal on every lane); and the two walk orders against each
              other on the same rays (any-hit equal except in a band around
              t_cut); then, at the main width, each walk order's kernels
              (ordered #1 and #2, preorder #4 and #7) per ray kind (camera,
              bounce, shadow): time, lane use and step count as the kernels
              count them (the steps equal to their plain versions'), steps
              per ray, and a launch of 17 rays, fewer than a warp, against
              the plain version;
  5. dragon   examples.build("dragon_hd", intersector="pallas", wide_k=8,
              pallas_ordered=False): 1,310,720 triangles, built once, its
              child boxes checked as an ordered build checks them; the
              kernel phase of 4 again on 518,400 + 518,400 rays (960x540);
              and the bench's dragon_hd closest-hit shape (bench.py
              run_closest_hit): 4 x 1,048,576 Morton-ordered jittered
              camera rays over 1920x1080 pixels through #1, 65,536 rays
              of each chunk held against the plain version on every
              lane, the four launches timed in full;
  5b. split   the kernel-level entry points over the split tables
              (split_fat of the fat table, held to check_child_boxes; the
              bunny's K=8, leaf 14, on the rays of 4 at the 1080p
              main-path width, then dragon_hd's on the rays of 5), driven
              once with every launch count set to 0 just before and read
              just after, each with its kernel-counted steps: the
              persistent ordered closest-hit (#5) in both push orders
              with each ray's step count, the persistent ordered any-hit
              (#8), and the persistent preorder closest-hit (#13); then
              each against its plain version (every output and each
              ray's steps on every lane, #8 in both orders; the counted
              steps equal) and against its fat-table twin on the same
              rays (#5 "near" equal to #1 on every lane and in its
              counted steps, #8 to #2, #13 to #4); step-count mean, p50,
              p99 and a static lane use (steps taken over the steps each
              warp of consecutive rays runs, one and two rays a thread)
              per order; times against the plain versions and, per ray
              kind (camera, bounce; shadow for #8), each kernel's time,
              kernel-counted lane use and steps beside the twins' times;
  5c. stack   the ordered kernels, fat and split, on hand-built chains
              whose max_stack_bound lies in (64, 128], against the
              preorder walk;
  5d. staged  the four memory-schedule kernels on the closest-hit rays of
              4 at the bunny's 1080p main-path width and of 5 on
              dragon_hd (whose table does not fit the card's L2), over
              split_fat tables, padded with pad_rows once per scene for
              #10: the ordered walk over the fat table with two rays a
              lane in persistent warps (#9), and the preorder walk in
              warp packets of 32 rays through TMA-filled shared memory
              (#12 over the fat table and #10 over the padded split
              tables through rings, #11 over the unpadded split tables
              through one-row stages); driven once with every launch
              count set to 0 just before and read just after, each with
              its counts; each against its plain version and its twin
              (dual = closest_hit; the warp packets =
              closest_hit_preorder) in t, slot, u and v on every lane;
              #9's steps equal to #1's, both counted in the kernels; the
              warp packets' counts (packet steps, lane steps, demand
              copies, prefetches used and discarded) equal to the plain
              model of their schedule (warp_packet_plain) and their lane
              steps to #4's steps; times per ray kind beside the plain
              versions and #1, #4 and #13, with the warp packets' lane
              use, copies a packet step and prefetch hit rate, and #9's
              and #1's lane use; their ptxas lines and dynamic shared
              memory;
  5e. rows    the XLA walks' kernels over the row tables of
              examples.build("bunny", intersector="walk") (leaf 8, K=4) on
              the rays of 4 at the 1080p main-path width, and of dragon_hd
              built once with intersector="cluster" (the same u_rows,
              w_rows and leaf_rows as a "walk" build, which the bunny's
              two builds show, plus the cluster tables) on the rays of 5:
              the persistent binary walk over u_rows (#14) and the
              persistent K-wide closest-hit over w_rows (4w, #4's walk) on
              the closest-hit rays, the persistent K-wide any-hit over
              w_rows (#7's walk) on the shadow rays, driven once with
              every launch count set to 0 just before and read just after;
              each against its plain version (every output on every
              lane), the two closest-hits against each other (the wide
              tree collapses the same binary tree over the same
              leaf_rows: t within CLOSEST_TOL, slots equal except ties,
              bit-equal lanes counted), and the any-hit against the
              bounded closest-hit's t < INF on every shadow lane (the JAX
              package's route for these shadow rays); times per ray kind
              beside the plain versions, with kernel-counted lane use and
              steps (equal to the plain versions' counts); then one
              "cluster" chunk of each scene: its first 8,192 bounce rays
              through the plain cull of a "cluster" build, and #14 on the
              chunk with t_max the cull's best t where unresolved, else
              -INF, as intersect_clustered calls it, held against its
              plain version in every output and step count, with its time,
              lane use and steps; then the row walks' scalar-load
              instances on a leaf-6 "wide" build of the bunny (leaf_rows
              of 54 floats, not a 16-byte stride): the K-wide walks, and
              #14 over its u_rows, each held against its plain version on
              every lane and in its step count;
  5f. tlas    the TLAS walk (csrc/tlas_walk.cu: closest_hit_tlas,
              any_hit_tlas) over examples.build("toybrick") at 1920x1080
              (36 brick instances, the default "wide" build, K=4, leaf 4):
              2,073,600 Morton-ordered camera rays, 2,073,600 scattered
              bounce rays from their hits and the shadow rays from those,
              driven once with every launch count set to 0 just before and
              read just after; each against its plain version in every
              output on every lane, the any-hit against the bounded
              closest-hit's kind != PT_NONE on every shadow lane; the
              tlas_walk.cu instance each launch ran (traverse.
              tlas_instance); times (CUDA events around the call, and the
              device time: CUDA events queued behind a spin kernel, as
              device_ms takes them) beside the plain versions and the
              bound; per ray kind the kernel-counted steps (equal to the
              plain versions'), lane use and both times; then the same
              over toybrick's binary rows (the "walk" walk of the same
              tables) and over cube_field at 1920x1080 (145 analytic
              primitives, no mesh); then every other instance
              (tlas_instance_phase: toybrick rebuilt at K=8, at leaf 6,
              at K=8 and leaf 6, its binary rows at leaf 6, at K=3 and
              with its rows off a 16-byte boundary, the run-time-K
              instance) on 65,536 camera + 65,536 bounce rays and their
              shadow rays, each launch's instance named, every output and
              the counted steps against the plain version on every lane;
  5g. inst    four instances of dragon_hd's mesh built in this script
              (4 x 1,310,720 triangles, past FLAT_TRI_CAP): the "pallas"
              build (K=8, leaf 14) keeps one table of the one mesh (checked:
              one node range, the table's rows twice its nodes), and its
              per-instance path runs #1 and #2, then on the preorder walk
              #4 and #7, once an instance on 518,400 camera + 518,400
              bounce rays (960x540) and their shadow rays, each launch
              against its plain version on every lane; the "wide" build
              of the same four walks the TLAS that re-enters the 1.3M-
              triangle BLAS: 5f's kernels and checks on the same rays;
  6. render   Renderer.render() at 1 spp of the bunny at 1920x1080 in both
              walk orders, of dragon_hd at 960x540 in both walk orders,
              of the bunny at 1920x1080 with the XLA intersectors
              ("wide", the default build, "walk" and "cluster"), of
              toybrick and cube_field at 1920x1080 (the TLAS walk) and of
              the four dragons of 5g at 960x540 ("pallas" per instance in
              both walk orders, whose launches must be a multiple of the
              instances, and "wide" through the TLAS), each with
              every launch count set to 0 just before and read just after
              (exactly the build's kernels must have launched: the walk's
              two fat-table kernels for "pallas", closest_hit_wide_rows and
              any_hit_wide_rows for "wide", closest_hit_binary and
              any_hit_wide_rows for "walk" and "cluster", closest_hit_tlas
              and any_hit_tlas for a TLAS build); one cornell pass at
              512x512; and 32x24 renders on the card, the bunny in both
              walk orders, "walk" and "wide", and toybrick, equal bit for
              bit to the same renders on the CPU (the plain versions);
  6b. modes   Renderer.render() at 1 spp, 1920x1080, of the bunny of 3
              (pallas ordered, K=8: #1/#2) and of its default "wide"
              build (4w/7w) under the integrator modes (MODES:
              specular "first" with light "all", veach's; specular "all"
              at all_split_depth 2, four wavefronts, with its peak device
              memory; closest-hit shadow rays); of the lit bunny built in
              this script (lit_bunny: the bunny's mesh under a 512x512
              normal map and a 512x512 bump map, a ground plane, an
              emissive quad_mesh, a cube whose per-triangle materials make
              four of its twelve triangles emissive, and a sphere light:
              three lights), as "pallas" (one flat tree over its three
              instances: #1/#2) and as "wide" (the TLAS: tw/ta), each
              with any-hit shadows, closest-hit shadows and light "all";
              and of examples.veach (analytic, no launch); each with every
              launch count set to 0 just before and read just after:
              exactly the build's kernels, the closest-hit alone (any-hit
              0 launches) with closest-hit shadows, none for veach; and
              32x24 versions (bunny subdivisions=3) on the card against
              the CPU, as in 6 (each with its mean and largest absolute
              difference);
  6c. geometry  first numerics_check, the card against the CPU bit for
              bit (core/vec.py's functions; the divisions by Python
              numbers, which the port takes by a float32 tensor on the
              operand's device, vec.div: the bump map's luminance, the
              cone, env_uv, sphere_uv; the marches); then the marched
              shapes and the mesh I/O at 1920x1080, 1 spp
              (geometry_phase): the bunny's mesh (81,920 triangles)
              written with obj.save_obj into an OBJ with an MTL (its
              triangles under a Kd material, an emissive quad under a Ke
              one, no texture), read back by load_obj(builder=...) into a
              "pallas" ordered build (#1/#2; the quad a mesh light), and
              round-tripped through save_stl/load_stl (equal arrays); then
              the eight catalog scenes of GEOMETRY_SCENES at their own
              max_bounces: teapot (a marching-tetrahedra mesh, "wide":
              4w/7w), ellipsoid and mol (analytic), sdf (an SDF tree under
              depth of field), volume, heightfield and love (marched), sh
              (two instances: the TLAS); each through render_main with its
              seconds, Mrays/s, launches (exactly the build's kernels, none
              for the analytic and marched scenes), peak MB and the march
              counts (marches, steps, lane steps) of its closest-hit and
              shadow queries; 32x24 versions of the nine (the OBJ bunny's
              mesh at subdivisions 3) on the card against the CPU, as in 6;
  6d. catalog  the rest of the catalog (catalog_phase): the fourteen
              scenes of CATALOG_SCENES at 1920x1080, 1 spp, each built on
              the card (its build seconds, instances, analytic
              primitives, lights, walk) and rendered through render_main
              (seconds, Mrays/s, peak MB, launches: 4w/7w for mesh,
              dragon and suzanne, tw/ta for craft, runway, qbert and maze,
              none for the seven analytic scenes; the walk each build
              takes checked against CATALOG_SCENES); their 32x24 versions
              join the card-vs-CPU renders of 6 (bit for bit); then
              compacted_phase: integrator.trace_compacted (one host sync)
              on cornell's Russian-roulette configuration at 1920x1080
              beside trace and trace_compacted_static on the same camera
              rays and key (lines "compacted cornell ...": seconds, rays,
              Mrays/s, the mean against trace's, within 1%; for
              trace_compacted the compacted width, the survivors at the
              compaction depth, and every lane dead before it equal to
              trace's bit for bit); then cli_phase (lines "cli ..."):
              examples.main([CLI_SCENE, CLI_ITERS, <tmp>/maze_%d.png]) on
              the card, its PNGs decoded with zlib (decode_png);
              iterative_render of the same scene with a checkpoint every
              iteration, denoise=True and a ViewerServer on a free
              loopback port (frame.png fetched with urllib, equal to the
              last frame's encoding), the last PNG and *_denoised.png equal
              to the quantised film and denoised film; a resume from the
              checkpoint to RESUME_ITERS iterations equal bit for bit to an
              uninterrupted run; denoise_film's milliseconds on a 1080p
              film of the scene (CUDA events); render_animation of
              BEADS_FRAMES beads frames, decoded;
  7. grad     the gradient path on the bunny of 3 (pallas ordered, K=8)
              at 1920x1080, 1 spp, through diff.render_image, with
              respect to the DiffParams leaves (material color,
              emittance, tint, environment color, texels): forward only,
              then forward and backward by the tape and by autograd under
              remat "full", "hits" and off, twice each, with wall ms, peak
              device memory and launches, each half's counts set to 0 just
              before and read just after (every forward launches #1 and #2
              once a depth; the tape's backward launches nothing, "full"
              re-launches both once a checkpointed depth, "hits" #2 only,
              off nothing); every gradient finite, each autograd mode's
              equal to the tape's per leaf (GRAD_RTOL, GRAD_ATOL_REL), the
              textured material's color row without gradient and the
              texels with; one tape and one "full" step under
              torch.profiler (device ms, idle share, index_add_'s share,
              the top kernels); three SGD steps on the material colors (lr
              0.5, clipped to [0, 1], as shard.make_train_step) toward a
              target rendered from scaled colors, the last loss below the
              first; a 32x24 bunny's tape gradients on the card against
              the CPU's; and bench.py run_grad's shape through the port
              (cornell 1920x1080, 8 chunks of 1,048,576 rays, fwd+bwd
              Mrays/s by the tape and by autograd through
              trace_compacted_static; no kernel launches there);
  8. shard    parallel/ on torch.distributed (shard_phase): a world-1 NCCL
              group on cuda:0 (distributed.initialize at a free localhost
              port, global_mesh(1, 1), process_summary printed) over the
              bunny of 3 at 1920x1080, 1 spp: render_image_sharded equal
              bit for bit to render_shard(..., 0, 0), finite and positive,
              launching #1 and #2 once a depth (seconds, closest-hit
              Mrays/s, peak MB); three make_train_step steps (tape, lr
              0.5) toward a target rendered from scaled colors, each with
              its wall ms, peak MB and the launches of its forward and of
              its backward (none: the tape), the last loss below the
              first, step 1's gradient equal to autograd through trace of
              the same shard's loss (GRAD_RTOL, GRAD_ATOL_REL); the group
              destroyed; then four gloo ranks that share cuda:0
              (ranks_phase: `chip_smoke.py --shard-rank` children under
              distributed.run_ranks, dp=2, sp=2, test_distributed's cube
              built "pallas" K=8 at 256x144, 2 spp): each rank's image
              equal bit for bit to this process's emulation of the mesh
              (four render_shard calls), the loss, gradient and new colors
              the same bits on every rank, the gradient equal to autograd
              over the emulated mesh, each rank's render and step
              launching #1 and #2 once a depth; and
              entry.dryrun_multichip(1) over NCCL in a process of its own
              (its OK line).

`python3 chip_smoke.py --rng` runs phases 1, 2 and 2b alone and prints
their JSON line; `python3 chip_smoke.py --march` runs phases 1, 2 and 2c
alone and prints theirs; `python3 chip_smoke.py --tsum` phases 1, 2 and
2d.

`python3 chip_smoke.py --shard-cards`, on a machine with four cards, runs
the same check over NCCL, one rank a card (the bunny at 1920x1080, 2 spp,
dp=2, sp=2), against the emulated mesh on cuda:0, then
entry.dryrun_multichip(4).

Every kernel's least time on the card (bound_ms) is computed from the
work its plain version did on the main-path rays (accel.traverse.
count_work): operations are box tests and triangle tests (a leaf's
`count` triangles, not its padding slots, and an any-hit's only up to its
first accepted one), and for the TLAS walk its analytic leaf tests,
affine ray transforms and instance entries (OPS_ANALYTIC, OPS_AFFINE),
counted from csrc/bvh_common.cuh, over the card's float32 rate; bytes
are each ray's
inputs and outputs once and each table row the walks read once (the
columns a read uses), over its memory rate; the larger of the two bounds
it.

Any failed check raises, so the exit code is non-zero; without a CUDA
device, or without the package beside it, it exits non-zero before
printing any result. The second-to-last line is a JSON object with each
of the sixteen traversal entry points' launches over the main-path renders,
the grad phase's main-path runs and SGD steps and the shard phase's
render and train steps (the split-table and
the staged kernels': over their phases' driven calls, both scenes), its
largest
error against its plain version, its times at the bunny's 1080p
main-path width (the TLAS walk's at toybrick's, with its device time)
and its bound there, and phase 2b's threefry rows, each with its
kernel's launches and words over the main-path renders (every one of
which must launch the threefry uniform), and phase 2c's march row, with its launches and rays over the main-path
renders (each SDF march of which must launch it); the
last line is {"ok": true,
"device": {...}}.
"""

from __future__ import annotations

import functools
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import types
import zlib
from dataclasses import replace

import numpy as np
import torch

# the least time of a walk or a draw on the card: the benchmark's H100 SXM
# peaks (float32 outside the tensor cores, device memory) and the rays'
# contract bytes
from perfbench.common import (
    ANY_OUT_BYTES,
    CLOSEST_OUT_BYTES,
    PEAK_BYTES,
    PEAK_F32,
    RAY_BYTES,
)

REPO = os.path.dirname(os.path.abspath(__file__))
INF = 1e9
CLOSEST_TOL = dict(rtol=1e-5, atol=1e-5)
ANYHIT_EDGE = 1e-5          # relative band around t_cut
ANYHIT_MAX_EDGE_FRAC = 1e-4  # share of lanes allowed in that band
DRAGON_TRIANGLES = 1_310_720

# walk order -> its (closest-hit, any-hit) wrappers in kernels/traverse.py
WALKS = {
    "ordered": ("closest_hit", "any_hit"),
    "preorder": ("closest_hit_preorder", "any_hit_preorder"),
}
# wrapper -> (its CUDA source, the TPU kernels it replaces)
KERNELS = {
    "closest_hit": ("ptsharp_tpu_torch/csrc/closest_hit.cu",
                    ["ptsharp_tpu/pallas/ordered_kernel.py:597"]),
    "any_hit": ("ptsharp_tpu_torch/csrc/any_hit.cu",
                ["ptsharp_tpu/pallas/wide_kernel.py:604",
                 "ptsharp_tpu/pallas/ordered_kernel.py:758"]),
    "closest_hit_preorder": ("ptsharp_tpu_torch/csrc/closest_hit_preorder.cu",
                             ["ptsharp_tpu/pallas/wide_kernel.py:449",
                              "ptsharp_tpu/pallas/hbm_kernel.py:570"]),
    "any_hit_preorder": ("ptsharp_tpu_torch/csrc/any_hit_preorder.cu",
                         ["ptsharp_tpu/pallas/hbm_kernel.py:862"]),
    "closest_hit_split": ("ptsharp_tpu_torch/csrc/closest_hit.cu",
                          ["ptsharp_tpu/pallas/ordered_kernel.py:875"]),
    "any_hit_split": ("ptsharp_tpu_torch/csrc/any_hit.cu",
                      ["ptsharp_tpu/pallas/ordered_kernel.py:816"]),
    "closest_hit_packet": ("ptsharp_tpu_torch/csrc/closest_hit_preorder.cu",
                           ["ptsharp_tpu/pallas/wide_kernel.py:304"]),
    "closest_hit_dual": ("ptsharp_tpu_torch/csrc/closest_hit_dual.cu",
                         ["ptsharp_tpu/pallas/ordered_kernel.py:1117"]),
    "closest_hit_fat_cache": ("ptsharp_tpu_torch/csrc/closest_hit_fat_cache.cu",
                              ["ptsharp_tpu/pallas/hbm_kernel.py:718"]),
    "closest_hit_block_cache": (
        "ptsharp_tpu_torch/csrc/closest_hit_block_cache.cu",
        ["ptsharp_tpu/pallas/hbm_kernel.py:918"]),
    "closest_hit_row_stage": ("ptsharp_tpu_torch/csrc/closest_hit_row_stage.cu",
                              ["ptsharp_tpu/pallas/hbm_kernel.py:412"]),
    "closest_hit_binary": ("ptsharp_tpu_torch/csrc/closest_hit_binary.cu",
                           ["ptsharp_tpu/pallas/traverse_kernel.py:144"]),
    # #4's and #7's walks over the XLA walk's row tables: the JAX package
    # runs these rays through no Pallas kernel (NOTES)
    "closest_hit_wide_rows": ("ptsharp_tpu_torch/csrc/closest_hit_preorder.cu",
                              []),
    "any_hit_wide_rows": ("ptsharp_tpu_torch/csrc/any_hit_preorder.cu", []),
    # the TLAS walk: the counterpart of the JAX package's XLA
    # traverse_scene, no Pallas kernel (NOTES)
    "closest_hit_tlas": ("ptsharp_tpu_torch/csrc/tlas_walk.cu",
                         ["ptsharp_tpu/intersect.py:150"]),
    "any_hit_tlas": ("ptsharp_tpu_torch/csrc/tlas_walk.cu",
                     ["ptsharp_tpu/intersect.py:150"]),
}
# what a kernel with no TPU kernel of its own stands in for
NOTES = {
    "closest_hit_wide_rows": "XLA traverse_wide over w_rows + leaf_rows "
                             "(ptsharp_tpu/accel/traverse.py:309)",
    "any_hit_wide_rows": "XLA traverse_wide over w_rows + leaf_rows, "
                         "bounded by t_cut, tested t < INF "
                         "(ptsharp_tpu/intersect.py:722-728)",
    "closest_hit_tlas": "XLA traverse_scene, the TLAS walk over the "
                        "unified node rows, not a Pallas kernel "
                        "(ptsharp_tpu/intersect.py:150-342)",
    "any_hit_tlas": "XLA traverse_scene bounded by t_cut, tested kind != "
                    "PT_NONE (ptsharp_tpu/intersect.py:624-626), not a "
                    "Pallas kernel",
}
# tlas_walk.cu's K template argument: 0 binary rows, -1 K at run time
TLAS_K = {0: "binary", -1: "run-time K"}
# the XLA walks' kernels
ROWS = ("closest_hit_binary", "closest_hit_wide_rows", "any_hit_wide_rows")
# the kernels a render of each build launches, exactly: the XLA builds'
# shadow rays go through the any-hit over w_rows
RENDER_KERNELS = {
    "ordered": {"closest_hit", "any_hit"},
    "preorder": {"closest_hit_preorder", "any_hit_preorder"},
    "wide": {"closest_hit_wide_rows", "any_hit_wide_rows"},
    "walk": {"closest_hit_binary", "any_hit_wide_rows"},
    "cluster": {"closest_hit_binary", "any_hit_wide_rows"},
    "tlas": {"closest_hit_tlas", "any_hit_tlas"},
    "none": set(),  # analytic primitives outside a TLAS: no kernel
}
# the integrator modes of the modes phase: (label, IntegratorConfig fields)
MODES = (
    ("specular first, light all", dict(specular_mode="first",
                                       light_mode="all")),
    ("specular all", dict(specular_mode="all", all_split_depth=2)),
    ("closest-hit shadows", dict(anyhit_shadows=False)),
)
# the lit bunny's renders: its build's shadow and light modes
LIT_MODES = (
    ("any-hit shadows", dict()),
    ("closest-hit shadows", dict(anyhit_shadows=False)),
    ("light all", dict(light_mode="all")),
)
MAP_SIZE = 512  # texels a side of the lit bunny's normal and bump maps
XLA_INTERSECTORS = ("wide", "walk", "cluster")
# the split-table kernels: no render launches them
SPLIT = ("closest_hit_split", "any_hit_split", "closest_hit_packet")
# the memory-schedule kernels: no render launches them either
STAGED = ("closest_hit_dual", "closest_hit_fat_cache",
          "closest_hit_block_cache", "closest_hit_row_stage")
# the warp-packet kernels (#12, #10, #11), whose launches ask for dynamic
# shared memory (traverse.cache_layout) and count their packets and copies
PACKETS = ("closest_hit_fat_cache", "closest_hit_block_cache",
           "closest_hit_row_stage")
# rays a chunk and candidate clusters a ray takes, intersect_clustered's
# defaults (which intersect.py takes)
CLUSTER_CHUNK = 8192
CLUSTER_K_CAND = 12

# operations counted from csrc/bvh_common.cuh (each add, multiply, divide,
# min, max, abs and compare one operation)
OPS_RAY = 9    # safe_inv of the direction: 3 x (abs, compare, divide)
OPS_BOX = 25   # slab: 6 sub, 6 mul, 10 min/max; box_hit: max, 2 compares
OPS_MT = 55    # mt: 45 arithmetic, 9 compares, 1 add; and tt < best t
# the TLAS walk's analytic leaves (csrc/bvh_common.cuh sphere_t, cube_t,
# cyl_t, each with its t < best t), by type code: sphere 38 (oc 3, a 5,
# b 6, cq 7, disc 4, sqrt and max 2, inv2a 2, t0 and t1 5, 3 compares),
# cube 34 (safe inverse 9, slabs 12, min/max 10, 2 compares), cylinder
# 68 (cap planes 8, two cap tests 20, a 3, b 4, c 5, disc 4, sqrt and max
# 2, inv2a 2, tl0 and tl1 5, two side tests 12, 2 min); an affine
# transform of a ray (a transformed primitive's or an instance's) 33:
# origin 9 mul 9 add, direction 9 mul 6 add; an instance entry also its
# direction's safe inverse (OPS_RAY)
OPS_ANALYTIC = {1: 38, 3: 34, 4: 68}
OPS_AFFINE = 33
# the bytes out of a ray: t, slot, u, v; one bool; the TLAS walk's t,
# kind, index, inst, u, v
OUT_BYTES = {"closest": CLOSEST_OUT_BYTES, "any": ANY_OUT_BYTES, "tlas": 24}
# the threefry draws' least time: the H100 SXM's 32-bit integer rate,
# one instruction a lane a clock on each of an SM's four sub-partitions
# (its dispatch limit: the compiler runs adds on the FMA pipe as IMAD beside
# the integer pipe), 132 SMs at the 1.98 GHz boost clock
PEAK_INT32 = 132 * 4 * 32 * 1.98e9  # operations/s
# integer operations a word, counted from csrc/threefry.cu's loop over a
# thread's words: the block 73 (2 adds of the key to the counter, 20
# rounds of add, rotate and xor, 5 injections of 2 adds, the output xor;
# the key schedule's xors and the injections' constants are computed once
# a thread); a uniform's shift, or and subtract 3; a randint two blocks
# and its three modulus, a multiply and two adds (each % counted as one
# operation, the index and address arithmetic not at all: a lower bound)
OPS_BLOCK = 73
OPS_WORD = {"uniform": OPS_BLOCK + 3, "randint": 2 * OPS_BLOCK + 6}
WORD_BYTES = {"uniform": 4, "randint": 4}  # float32, int32 written
# the main path's draws: a pass's full-width uniforms, the camera jitter's
# and lens's (2, r) pairs, NEE's light pick over the bunny's one light
# a sphere trace's ray: active0 (bool) in and hit t out for every ray;
# org, dir, t0 and t_exit (float32) in only for a ray that enters the
# tree's box (active0 set)
MARCH_RAY_BYTES = 1 + 4
MARCH_ENTER_BYTES = 12 + 12 + 4 + 4
RNG_DRAWS = (("uniform", (4_147_200,)), ("uniform", (2, 4_147_200)),
             ("randint", (4_147_200,)))


def log(msg: str) -> None:
    print(msg, flush=True)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# a plain version repeats its kernel's arithmetic in tensor ops and takes
# about a second at the main-path widths: it is timed once after a warm-up
PLAIN_REPS = 1


def _reps(name: str) -> int:
    return PLAIN_REPS if name.endswith("_plain") else 5


def time_ms(fn, device, reps: int = 5) -> float:
    """Median of `reps` timed calls after one warm-up: CUDA events on the
    card, the host clock elsewhere (a rehearsal only)."""
    fn()
    sync(device)
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# clock cycles of the spin kernel that holds the card while the host queues
# a call for device_ms: about 2.5 ms on an H100, over ten times the
# host's work of a wrapper call
SPIN_CYCLES = 5_000_000


def device_ms(fn, reps: int = 20) -> float:
    """Median device milliseconds of fn's launches over `reps` calls after
    one warm-up, for a call shorter than the host's work of making it
    (CUDA events around the call would time the host): a spin kernel
    (torch.cuda._sleep) holds the card while the host queues the first
    event, fn's launches and the second event, so the card runs the three
    back to back. Raises if the card reached the first event before the
    second was queued: then the events would have timed the host. The
    garbage collector is off over the calls, as timeit turns it off: a
    collection that starts inside one (1-5 ms, a full one 40-100 ms in
    this process on the H100's host) outlasts the spin."""
    fn()
    torch.cuda.synchronize()
    times = []
    collecting = gc.isenabled()
    gc.disable()
    try:
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES)
            a.record()
            fn()
            b.record()
            if a.query():
                raise AssertionError("the card ran out of queued work "
                                     "before the timed call was queued")
            b.synchronize()
            times.append(a.elapsed_time(b))
    finally:
        if collecting:
            gc.enable()
    return statistics.median(times)


def bound(work, n_rays: int, kind: str) -> dict:
    """The least time of the work a plain walk counted (accel.traverse.
    count_work) on n_rays rays: the larger of its operations over
    PEAK_F32 and its bytes over PEAK_BYTES."""
    ops = (n_rays * OPS_RAY + work.boxes * OPS_BOX + work.triangles * OPS_MT
           + sum(OPS_ANALYTIC[k] * n for k, n in work.analytic.items())
           + work.affine * OPS_AFFINE + work.instances * OPS_RAY)
    nbytes = n_rays * (RAY_BYTES + OUT_BYTES[kind]) + work.table_bytes
    t_ops, t_bytes = ops / PEAK_F32, nbytes / PEAK_BYTES
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                ops=ops, bytes=nbytes)


def bound_text(res: dict) -> str:
    return (f"bound_ms={res['bound_ms']:.4f} ({res['bound_by']}: "
            f"{res['ops']:.4g} ops, {res['bytes']:.4g} B)")


def ptxas_report(text: str) -> dict:
    """{kernel<K>: {registers, stack, spill_stores, spill_loads, smem}}
    from nvcc's -Xptxas -v report (smem: static shared memory bytes)."""
    rows, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        # tlas_walk<kAny, K, kVecLeaf>; earlier trees had <kAny, kWide>
        tlas = m and re.search(r"tlas_walk_kernelILb(\d)E(?:Lb(\d)E|"
                               r"Li(n?\d+)ELb(\d)E)", m.group(1))
        if tlas:
            walk = ("closest", "any")[int(tlas.group(1))]
            if tlas.group(2) is not None:
                kind = ("binary", "wide")[int(tlas.group(2))]
            else:
                k = int(tlas.group(3).replace("n", "-"))
                kind = (f"{TLAS_K.get(k, f'K={k}')},"
                        f"{('scalar', 'float4')[int(tlas.group(4))]} leaves")
            name = f"tlas_walk<{walk},{kind}>"
            rows[name] = {"smem": 0}
            continue
        # threefry_words<T>, threefry_randint, threefry_uniform_keys
        fry = m and re.search(r"\d(threefry_[a-z_]+?)(?:I([a-z])E)?E",
                              m.group(1))
        if fry:
            name = fry.group(1) + (f"<{fry.group(2)}>" if fry.group(2)
                                   else "")
            rows[name] = {"smem": 0}
            continue
        # table_sum_kernel<Id, kShared>
        tsum = m and re.search(r"table_sum_kernelI([il])Lb(\d)E", m.group(1))
        if tsum:
            name = (f"table_sum<{dict(i='int32', l='int64')[tsum.group(1)]},"
                    f"{('global', 'shared')[int(tsum.group(2))]}>")
            rows[name] = {"smem": 0}
            continue
        if m:
            k = re.search(r"([a-z_]+)_kernel(?:I(?:Li(\d+)E)?)?(?:Lb(\d)E)?"
                          r"(?:LN3ptk4PushE(\d)E)?"
                          r"(?:N(?:3ptk|S\d*_)\d+([A-Z][a-z]+Table)E)?",
                          m.group(1))
            loads = {None: None, "0": "scalar", "1": "float4"}
            push = {None: None, "0": "full", "1": "near"}
            args = ",".join(x for x in (
                k.group(2), loads[k.group(3)], push[k.group(4)], k.group(5))
                if x) if k else ""
            name = f"{k.group(1)}<{args}>" if k else m.group(1)
            rows[name] = {"smem": 0}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            rows[name].update(stack=int(m.group(1)),
                              spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows[name]["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            if smem:
                rows[name]["smem"] = int(smem.group(1))
    return rows


# ---- rays -----------------------------------------------------------------


def camera_rays(scene, cam, width, height, n, seed=0):
    """n primary rays of a width x height image. For the full frame, the
    renderer's own ray generation (Morton order, as the main path gives
    them); otherwise a centred square block in 2D-Morton order."""
    from ptsharp_tpu_torch.core import rng
    from ptsharp_tpu_torch.renderer import (
        RenderConfig, Renderer, _expand_bits16,
    )

    if n == width * height:
        r = Renderer(scene, cam, RenderConfig(width, height, spp=1))
        org, dirn, *_ = r._raygen(rng.PRNGKey(seed), 0, height, 1)
        return org, dirn
    device = scene.device
    side = int(round(n ** 0.5))
    x0, y0 = (width - side) // 2, (height - side) // 2
    ys, xs = torch.meshgrid(torch.arange(side, device=device),
                            torch.arange(side, device=device), indexing="ij")
    key = _expand_bits16(xs) | (_expand_bits16(ys) << 1)
    order = torch.argsort(key.reshape(-1), stable=True)
    px = xs.reshape(-1)[order] + x0
    py = ys.reshape(-1)[order] + y0
    g = torch.Generator(device="cpu").manual_seed(seed)
    ju, jv = torch.rand((2, px.shape[0]), generator=g).to(device)
    return cam.cast_rays(px, py, width, height, ju, jv)


def phase_rays(scene, cam, width, height, n_cam, n_bounce):
    """The kernel phases' rays: camera rays then bounce rays from their
    hits (closest-hit), and shadow rays from the bounce origins with
    their t_cut and their nearest hit t (any-hit)."""
    from ptsharp_tpu_torch.kernels import traverse
    from tests.torch_walk_cases import bounce_rays, shadow_cut

    oc, dc = camera_rays(scene, cam, width, height, n_cam)
    ob, db = bounce_rays(scene, oc, dc, n_bounce)
    ds, t_cut = shadow_cut(scene, ob)
    t_near, _s, _u, _v = traverse.closest_hit(
        scene.p_fat, ob, ds, torch.full_like(t_cut, INF), *_args(scene))
    return dict(org=torch.cat([oc, ob]).contiguous(),
                dirn=torch.cat([dc, db]).contiguous(), n_cam=n_cam,
                shadow_org=ob, shadow_dirn=ds, t_cut=t_cut, t_near=t_near)


# ---- kernel checks ----------------------------------------------------------


def _args(scene):
    return (scene.p_inst_base[0], scene.p_inst_end[0], scene.max_leaf,
            scene.wide_k)


def _slot_triangles(scene):
    """(kernel slot // leaf_size -> fat node) lookup over the fat table."""
    fat = scene.p_fat
    bits = fat[0::2].view(torch.int32)
    leaf = (bits[:, 7] & 0xFF) > 0
    nodes = torch.nonzero(leaf).squeeze(1)
    first = bits[nodes, 6].long() // scene.max_leaf
    leaf_node = torch.empty(int(first.max()) + 1, dtype=torch.long,
                            device=fat.device)
    leaf_node[first] = nodes
    return leaf_node


def _ties(scene, org, dirn, slot_a, slot_b, t_ref):
    """Of the lanes where two slots differ, those where both triangles hit
    at t within the closest-hit tolerance of each other: ties."""
    from ptsharp_tpu_torch.accel.traverse import mt

    lanes = torch.nonzero(slot_a != slot_b).squeeze(1)
    if lanes.numel() == 0:
        return lanes, torch.zeros(0, dtype=torch.bool, device=org.device)
    ls = scene.max_leaf
    if scene.p_fat.shape[0]:
        leaf_node = _slot_triangles(scene)
    tts = []
    for s in (slot_a[lanes].long(), slot_b[lanes].long()):
        if bool((s < 0).any()):
            return lanes, torch.zeros(lanes.numel(), dtype=torch.bool,
                                      device=org.device)
        if scene.p_fat.shape[0]:
            rows = scene.p_fat[2 * leaf_node[s // ls] + 1]
            cols = (s % ls)[:, None] * 9 + torch.arange(9, device=org.device)
            tri = torch.gather(rows, 1, cols)[:, None, :]
        else:  # the XLA walks' slots index leaf_rows' triangles
            tri = scene.leaf_rows.reshape(-1, 9)[s][:, None, :]
        ok, tt, _u, _v = mt(tri, org[lanes], dirn[lanes])
        tts.append(torch.where(ok[:, 0], tt[:, 0], torch.full_like(t_ref[lanes], INF)))
    tol = CLOSEST_TOL["atol"] + CLOSEST_TOL["rtol"] * t_ref[lanes].abs()
    return lanes, (tts[0] - tts[1]).abs() <= tol


def _band(t_near, t_cut, occ_a, occ_b, what):
    """Lanes where two any-hit results differ; raises unless every one
    lies in the t_cut band and they are few. Returns (mismatches, band)."""
    edge = (t_near - t_cut).abs() <= ANYHIT_EDGE * t_cut.abs()
    diff = occ_a != occ_b
    off_edge = diff & ~edge
    if bool(off_edge.any()):
        raise AssertionError(f"{what} differs on {int(off_edge.sum())} "
                             f"lanes off the t_cut band")
    n_edge = int((diff & edge).sum())
    if n_edge > ANYHIT_MAX_EDGE_FRAC * t_cut.shape[0]:
        raise AssertionError(f"{what} differs on {n_edge} lanes at t_cut")
    return n_edge, edge


def check_closest(scene, org, dirn, label, walk):
    """The walk's closest-hit kernel against its plain version: t, slot,
    u and v equal on every lane (each persistent kernel takes its plain
    version's steps in the same order)."""
    from ptsharp_tpu_torch.accel import traverse as walks
    from ptsharp_tpu_torch.kernels import traverse

    name = WALKS[walk][0]
    kernel = getattr(traverse, name)
    plain = getattr(walks, f"{name}_plain")
    args = _args(scene)
    tmax = torch.full((org.shape[0],), INF, device=org.device)
    t, s, u, v = kernel(scene.p_fat, org, dirn, tmax, *args)
    with walks.count_work() as work:
        tp, sp, up, vp = plain(scene.p_fat, org, dirn, tmax, *args)
    sync(org.device)
    bnd = bound(work, org.shape[0], "closest")
    close = torch.isclose(t, tp, **CLOSEST_TOL)
    if not bool(close.all()):
        bad = torch.nonzero(~close).squeeze(1)[:5].tolist()
        raise AssertionError(f"{name} t differs on {int((~close).sum())} "
                             f"lanes, e.g. {bad}")
    _equal(f"{name} against its plain version", (t, s, u, v),
           (tp, sp, up, vp))
    err = float((t - tp).abs().max())
    ms = time_ms(lambda: kernel(scene.p_fat, org, dirn, tmax, *args),
                 org.device)
    plain_ms = time_ms(lambda: plain(scene.p_fat, org, dirn, tmax, *args),
                       org.device, PLAIN_REPS)
    hits = float((tp < INF).float().mean())
    log(f"{name} [{label}] rays={org.shape[0]} hit_frac={hits:.4f} "
        f"max_abs_err_t={err:.3e} slot_mismatches=0 "
        f"kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} {bound_text(bnd)}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, t=t, slot=s,
                **bnd)


def check_any(scene, org, dirn, t_cut, label, walk):
    """The walk's any-hit kernel against its plain version, equal on every
    lane."""
    from ptsharp_tpu_torch.accel import traverse as walks
    from ptsharp_tpu_torch.kernels import traverse

    name = WALKS[walk][1]
    kernel = getattr(traverse, name)
    plain = getattr(walks, f"{name}_plain")
    args = _args(scene)
    occ = kernel(scene.p_fat, org, dirn, t_cut, *args)
    with walks.count_work() as work:
        occ_p = plain(scene.p_fat, org, dirn, t_cut, *args)
    sync(org.device)
    bnd = bound(work, org.shape[0], "any")
    _equal(f"{name} against its plain version", (occ,), (occ_p,))
    err = float((occ.float() - occ_p.float()).abs().max())
    ms = time_ms(lambda: kernel(scene.p_fat, org, dirn, t_cut, *args),
                 org.device)
    plain_ms = time_ms(lambda: plain(scene.p_fat, org, dirn, t_cut, *args),
                       org.device, PLAIN_REPS)
    log(f"{name} [{label}] rays={org.shape[0]} active="
        f"{float((t_cut > 0).float().mean()):.4f} occluded="
        f"{float(occ_p.float().mean()):.4f} equal on every lane "
        f"kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} {bound_text(bnd)}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, occ=occ, **bnd)


def kernel_phase(scene, rays, label):
    """All four fat-table kernels against their plain versions on camera
    rays plus bounce rays (closest-hit), then on shadow rays from the
    bounce origins (any-hit); then the two walk orders' kernels against
    each other. Returns {wrapper name: {max_abs_err, ms, plain_ms}}."""
    org, dirn = rays["org"], rays["dirn"]
    ob, ds = rays["shadow_org"], rays["shadow_dirn"]
    t_cut, t_near = rays["t_cut"], rays["t_near"]
    closest = {w: check_closest(scene, org, dirn, label, w) for w in WALKS}
    anyhit = {w: check_any(scene, ob, ds, t_cut, label, w) for w in WALKS}

    a, b = closest["preorder"], closest["ordered"]
    close = torch.isclose(a["t"], b["t"], **CLOSEST_TOL)
    if not bool(close.all()):
        raise AssertionError(f"the two closest-hit walks differ in t on "
                             f"{int((~close).sum())} lanes")
    lanes, tie = _ties(scene, org, dirn, a["slot"], b["slot"], b["t"])
    if not bool(tie.all()):
        raise AssertionError(f"the two closest-hit walks differ in slot off "
                             f"ties on {int((~tie).sum())} lanes")
    n_edge, _edge = _band(t_near, t_cut, anyhit["preorder"]["occ"],
                          anyhit["ordered"]["occ"], "the two any-hit walks")
    log(f"cross-order [{label}]: closest-hit max_abs_diff_t="
        f"{float((a['t'] - b['t']).abs().max()):.3e} slot_mismatches="
        f"{lanes.numel()} (all ties); any-hit edge_mismatches={n_edge}")
    out = {}
    for w, names in WALKS.items():
        for name, res in zip(names, (closest[w], anyhit[w])):
            out[name] = {k: res[k] for k in RESULT_KEYS}
    return out


RESULT_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")


def _steps_text(steps):
    x = steps.float()
    q = torch.quantile(x, torch.tensor([0.5, 0.99], device=x.device))
    return (f"steps mean={float(x.mean()):.3f} p50={float(q[0]):.0f} "
            f"p99={float(q[1]):.0f}")


def _kind_stats(kernel, plain, tables, o, d, t, args, counted, dev, **kw):
    """One ray kind through a persistent kernel: its kernel-counted steps
    (equal to its plain version's) and lane use, and its time. `counted`
    names the ray kind for the messages; `kw` goes to both. Returns (ms,
    lane use, steps)."""
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    kernel(*tables, o, d, t, *args, counts=counts, **kw)
    steps = plain(*tables, o, d, t, *args, return_iters=True, **kw)[-1]
    taken, slots = counts.tolist()
    if taken != int(steps.sum()):
        raise AssertionError(f"{kernel.__name__} took {taken} steps on "
                             f"{counted}, its plain version "
                             f"{int(steps.sum())}")
    ms = time_ms(lambda: kernel(*tables, o, d, t, *args, **kw), dev)
    return ms, taken / slots, steps


def walk_stats(scene, rays, label, walk):
    """The persistent kernels of a walk order over the fat table (ordered:
    #1 and #2; preorder: #4 and #7) per ray kind (camera and bounce rays
    through closest-hit, shadow rays through any-hit): time, lane use (the
    steps their rays took over the lane slots their warps ran, both
    counted in the kernel), and steps per ray from the plain version,
    whose total the kernel's count must equal. Also one launch of fewer
    rays than a warp against the plain version. Returns {kind: ms}."""
    from ptsharp_tpu_torch.accel import traverse as walks
    from ptsharp_tpu_torch.kernels import traverse

    dev = scene.p_fat.device
    args = _args(scene)
    n_cam = rays["n_cam"]
    org, dirn = rays["org"], rays["dirn"]
    cam = (org[:n_cam].contiguous(), dirn[:n_cam].contiguous())
    bounce = (org[n_cam:].contiguous(), dirn[n_cam:].contiguous())
    closest, anyhit = WALKS[walk]
    kinds = {
        "camera": (closest, *cam, torch.full((n_cam,), INF, device=dev)),
        "bounce": (closest, *bounce,
                   torch.full((bounce[0].shape[0],), INF, device=dev)),
        "shadow": (anyhit, rays["shadow_org"], rays["shadow_dirn"],
                   rays["t_cut"]),
    }
    out = {}
    for kind, (name, o, d, t) in kinds.items():
        kernel = getattr(traverse, name)
        plain = getattr(walks, f"{name}_plain")
        out[kind], use, steps = _kind_stats(
            kernel, plain, (scene.p_fat,), o, d, t, args,
            f"the {kind} rays", dev)
        few = [x[:17].contiguous() for x in (o, d, t)]
        got, want = (kernel(scene.p_fat, *few, *args),
                     plain(scene.p_fat, *few, *args))
        if name == anyhit:
            got, want = (got,), (want,)
        _equal(f"{name} on 17 {kind} rays", got, want)
        log(f"{name} [{label}] {kind} rays={o.shape[0]} kernel_ms="
            f"{out[kind]:.4f} lane_use={use:.3f} "
            f"{_steps_text(steps)} (kernel's step count equal); 17 rays "
            f"equal to the plain version")
    return out


def bench_closest_rays(cam, chunk, ci, width=1920, height=1080, seed=7):
    """Chunk ci of the bench's closest-hit rays (bench.py
    run_closest_hit): `chunk` camera rays of a width x height image in
    2D-Morton pixel order from pixel ci * chunk on, jittered by
    uniform(fold_in(PRNGKey(seed), ci), (2, chunk))."""
    from ptsharp_tpu_torch.core import rng
    from ptsharp_tpu_torch.renderer import _expand_bits16

    dev = cam.p.device
    ys, xs = torch.meshgrid(torch.arange(height, device=dev),
                            torch.arange(width, device=dev), indexing="ij")
    key = _expand_bits16(xs) | (_expand_bits16(ys) << 1)
    morder = torch.argsort(key.reshape(-1), stable=True)
    idx = morder[(ci * chunk + torch.arange(chunk, device=dev))
                 % (width * height)]
    ju, jv = rng.uniform(rng.fold_in(rng.PRNGKey(seed), ci), (2, chunk),
                         device=dev)
    org, dirn = cam.cast_rays(idx % width, idx // width, width, height, ju,
                              jv)
    return org.contiguous(), dirn.contiguous()


def bench_shape_phase(scene, cam, label, chunks=4, chunk=1 << 20,
                      sample=1 << 16):
    """The bench's dragon_hd closest-hit shape through #1: `chunks`
    launches of `chunk` Morton-ordered jittered camera rays over 1920x1080
    pixels; the first `sample` rays of each chunk held against the plain
    version (t, slot, u and v on every lane), all chunks timed in full.
    Returns the ms of the full shape."""
    from ptsharp_tpu_torch.accel import traverse as walks
    from ptsharp_tpu_torch.kernels import traverse

    dev = scene.p_fat.device
    args = _args(scene)
    rays = [bench_closest_rays(cam, chunk, ci) for ci in range(chunks)]
    tmax = torch.full((chunk,), INF, device=dev)
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    hits = 0
    for org, dirn in rays:
        got = traverse.closest_hit(scene.p_fat, org, dirn, tmax, *args,
                                   counts=counts)
        hits += int((got[0] < INF).sum())
        few = (org[:sample].contiguous(), dirn[:sample].contiguous(),
               tmax[:sample].contiguous())
        _equal("closest_hit on the bench shape's sample",
               tuple(x[:sample] for x in got),
               walks.closest_hit_plain(scene.p_fat, *few, *args))
    taken, slots = counts.tolist()

    def run():
        for org, dirn in rays:
            traverse.closest_hit(scene.p_fat, org, dirn, tmax, *args)

    ms = time_ms(run, dev)
    log(f"closest_hit [{label}] bench shape {chunks} x {chunk} Morton-ordered "
        f"jittered camera rays over 1920x1080: kernel_ms={ms:.4f} "
        f"({chunks * chunk / ms / 1e3:.1f} Mrays/s) hit_frac="
        f"{hits / (chunks * chunk):.4f} lane_use={taken / slots:.3f} "
        f"steps/ray={taken / (chunks * chunk):.3f}; {chunks} x {sample} "
        f"sampled rays equal to the plain version")
    return ms


def _equal(what, got, want):
    """Raise unless two tuples of result tensors are equal on every lane."""
    for a, b in zip(got, want):
        diff = a != b
        if bool(diff.any()):
            raise AssertionError(f"{what} differs on {int(diff.sum())} lanes")


def _lane_use(x, rays_a_thread):
    """Steps taken over steps a warp runs, for a kernel that walks
    `rays_a_thread` rays a thread (ray i and i + ceil(n / 2) for two) and
    runs each warp of 32 threads until its longest walk ends."""
    total = float(x.sum())
    if rays_a_thread == 2:
        h = (x.shape[0] + 1) // 2
        b = torch.zeros(h, dtype=x.dtype, device=x.device)
        b[:x.shape[0] - h] = x[h:]
        x = torch.maximum(x[:h], b)
    pad = (-x.shape[0]) % 32
    warps = torch.cat([x, x.new_zeros(pad)]).view(-1, 32).amax(dim=1)
    return total / (32 * rays_a_thread * float(warps.sum()))


def _steps_line(steps, n_cam):
    parts = []
    for kind, x in (("camera", steps[:n_cam]), ("bounce", steps[n_cam:])):
        x = x.float()
        q = torch.quantile(x, torch.tensor([0.5, 0.99], device=x.device))
        parts.append(f"{kind} mean={float(x.mean()):.3f} "
                     f"p50={float(q[0]):.0f} p99={float(q[1]):.0f} "
                     f"lane_use={_lane_use(x, 1):.3f} "
                     f"(two rays a thread {_lane_use(x, 2):.3f})")
    return "; ".join(parts)


def split_tables(fat, leaf_size: int, k: int, device):
    """split_fat of a fat table, held to the child-box check that the
    ordered walks need (accel.tables.check_child_boxes), on `device`."""
    from ptsharp_tpu_torch.accel import tables

    rows, leaf = tables.split_fat(np.asarray(fat), leaf_size)
    tables.check_child_boxes(rows, k)
    return rows, leaf, tuple(torch.from_numpy(x).to(device)
                             for x in (rows, leaf))


def split_phase(scene, rays, label):
    """The split-table entry points, driven once on the rays of the main
    path with the launch counts set to 0 just before and read just after,
    each with its counts; then each held against its plain version (every
    output on every lane, and each ray's steps) and its fat-table twin,
    and timed, per ray kind with lane use. Returns ({wrapper name:
    {max_abs_err, ms, plain_ms}}, {wrapper name: launches})."""
    from ptsharp_tpu_torch.accel import traverse as walks
    from ptsharp_tpu_torch.kernels import traverse

    dev = scene.p_fat.device
    t0 = time.perf_counter()
    _rows, _leaf, tab = split_tables(scene.p_fat.cpu().numpy(),
                                     scene.max_leaf, scene.wide_k, dev)
    log(f"split tables [{label}]: rows {tuple(tab[0].shape)}, leaf "
        f"{tuple(tab[1].shape)}, child boxes checked, "
        f"{time.perf_counter() - t0:.2f} s")
    org, dirn, n_cam = rays["org"], rays["dirn"], rays["n_cam"]
    ob, ds, t_cut = rays["shadow_org"], rays["shadow_dirn"], rays["t_cut"]
    args = _args(scene)
    tmax = torch.full((org.shape[0],), INF, device=dev)

    def new_counts():
        return torch.zeros(2, dtype=torch.int64, device=dev)

    # the path: each entry point once, as a caller of the kernel-level
    # API calls it, each with its counts
    counts = {name: new_counts() for name in
              (*walks.ORDER_MODES, "any_hit_split", "closest_hit_packet")}
    traverse.reset_launch_counts()
    ordered = {m: traverse.closest_hit_split(*tab, org, dirn, tmax, *args,
                                             order_mode=m, return_iters=True,
                                             counts=counts[m])
               for m in walks.ORDER_MODES}
    occ = traverse.any_hit_split(*tab, ob, ds, t_cut, *args,
                                 counts=counts["any_hit_split"])
    packet = traverse.closest_hit_packet(*tab, org, dirn, tmax, *args,
                                         counts=counts["closest_hit_packet"])
    sync(dev)
    launches = {w.__name__: w.launches for w in traverse.WRAPPERS}
    launch_rays = {w.__name__: w.rays for w in traverse.WRAPPERS}
    for name, count in launches.items():
        want = dict(closest_hit_split=2, any_hit_split=1,
                    closest_hit_packet=1).get(name, 0)
        if count != want:
            raise AssertionError(f"split phase launched {name} {count} "
                                 f"times, not {want}")
    log(f"split path [{label}]: launches={launches}")

    def counted_steps(name, c, steps_p):
        if int(c[0]) != int(steps_p.sum()):
            raise AssertionError(f"{name} took {int(c[0])} steps, its plain "
                                 f"version {int(steps_p.sum())}")
        return f"lane_use={int(c[0]) / int(c[1]):.3f}"

    out = {}
    # #5 against its plain version in every output and each ray's steps
    errs = []
    for mode, got in ordered.items():
        name = f"closest_hit_split ({mode})"
        with walks.count_work() as work:
            want = walks.closest_hit_split_plain(
                *tab, org, dirn, tmax, *args, order_mode=mode,
                return_iters=True)
        sync(dev)
        bnd = bound(work, org.shape[0], "closest")
        _equal(f"{name} against its plain version", got, want)
        use = counted_steps(name, counts[mode], want[4])
        errs.append(float((got[0] - want[0]).abs().max()))
        ms = time_ms(lambda: traverse.closest_hit_split(
            *tab, org, dirn, tmax, *args, order_mode=mode), dev)
        plain_ms = time_ms(lambda: walks.closest_hit_split_plain(
            *tab, org, dirn, tmax, *args, order_mode=mode), dev,
            PLAIN_REPS)
        log(f"{name} [{label}] rays={org.shape[0]} max_abs_err_t="
            f"{errs[-1]:.3e}, every output and each ray's steps equal to its "
            f"plain version; {use} kernel_ms={ms:.3f} plain_ms="
            f"{plain_ms:.3f} {bound_text(bnd)}")
        log(f"  steps per ray, order={mode}: {_steps_line(got[4], n_cam)}")
        if mode == "full":
            out["closest_hit_split"] = dict(ms=ms, plain_ms=plain_ms, **bnd)
    out["closest_hit_split"]["max_abs_err"] = max(errs)
    # #1 pushes "near", the order the JAX package asks of its kernel
    fat_counts = new_counts()
    _equal("closest_hit_split (near) against closest_hit",
           ordered["near"][:4], traverse.closest_hit(
               scene.p_fat, org, dirn, tmax, *args, counts=fat_counts))
    if int(fat_counts[0]) != int(counts["near"][0]):
        raise AssertionError(f"closest_hit took {int(fat_counts[0])} steps, "
                             f"closest_hit_split (near) "
                             f"{int(counts['near'][0])}")

    # #8 against its plain version on every lane, in either order, and
    # against #2
    with walks.count_work() as work:
        occ_p, steps_p = walks.any_hit_split_plain(
            *tab, ob, ds, t_cut, *args,
            order_mode=traverse.SPLIT_ANY_HIT_ORDER, return_iters=True)
    sync(dev)
    bnd = bound(work, ob.shape[0], "any")
    _equal("any_hit_split against its plain version", (occ,), (occ_p,))
    use = counted_steps("any_hit_split", counts["any_hit_split"], steps_p)
    err = float((occ.float() - occ_p.float()).abs().max())
    _equal("any_hit_split (full) against its plain version",
           (traverse.any_hit_split(*tab, ob, ds, t_cut, *args,
                                   order_mode="full"),),
           (walks.any_hit_split_plain(*tab, ob, ds, t_cut, *args,
                                      order_mode="full"),))
    _equal("any_hit_split against any_hit", (occ,),
           (traverse.any_hit(scene.p_fat, ob, ds, t_cut, *args),))
    ms = time_ms(lambda: traverse.any_hit_split(*tab, ob, ds, t_cut, *args),
                 dev)
    plain_ms = time_ms(lambda: walks.any_hit_split_plain(
        *tab, ob, ds, t_cut, *args, order_mode=traverse.SPLIT_ANY_HIT_ORDER),
        dev, PLAIN_REPS)
    log(f"any_hit_split [{label}] rays={ob.shape[0]} occluded="
        f"{float(occ_p.float().mean()):.4f}, equal to its plain version (both "
        f"orders) and to any_hit on every lane, steps equal; {use} "
        f"kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} {bound_text(bnd)}")
    out["any_hit_split"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                **bnd)

    # #13 against its plain version (every output and the step count) and
    # against #4, on every lane
    with walks.count_work() as work:
        *pp, psteps = walks.closest_hit_packet_plain(
            *tab, org, dirn, tmax, *args, return_iters=True)
    sync(dev)
    bnd = bound(work, org.shape[0], "closest")
    _equal("closest_hit_packet against its plain version", packet, pp)
    use = counted_steps("closest_hit_packet", counts["closest_hit_packet"],
                        psteps)
    _equal("closest_hit_packet against closest_hit_preorder", packet,
           traverse.closest_hit_preorder(scene.p_fat, org, dirn, tmax,
                                         *args))
    err = float((packet[0] - pp[0]).abs().max())
    ms = time_ms(lambda: traverse.closest_hit_packet(*tab, org, dirn, tmax,
                                                     *args), dev)
    plain_ms = time_ms(lambda: walks.closest_hit_packet_plain(
        *tab, org, dirn, tmax, *args), dev, PLAIN_REPS)
    log(f"closest_hit_packet [{label}] rays={org.shape[0]} "
        f"max_abs_err_t={err:.3e}, every output and the step count equal to "
        f"its plain version, equal to closest_hit_preorder; {use} "
        f"kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} {bound_text(bnd)}")
    out["closest_hit_packet"] = dict(max_abs_err=err, ms=ms,
                                     plain_ms=plain_ms, **bnd)

    # per ray kind: each split kernel's time, lane use and steps, beside
    # its fat twin's time
    kinds = {"camera": (org[:n_cam].contiguous(), dirn[:n_cam].contiguous(),
                        tmax[:n_cam].contiguous()),
             "bounce": (org[n_cam:].contiguous(), dirn[n_cam:].contiguous(),
                        tmax[n_cam:].contiguous()),
             "shadow": (ob, ds, t_cut)}
    for kind, (o, d, tm) in kinds.items():
        if kind == "shadow":
            runs = {"any_hit_split": (
                traverse.any_hit_split, walks.any_hit_split_plain,
                dict(order_mode=traverse.SPLIT_ANY_HIT_ORDER))}
            twins = {"any_hit (fat)": lambda: traverse.any_hit(
                scene.p_fat, o, d, tm, *args)}
        else:
            runs = {f"closest_hit_split {m}": (
                traverse.closest_hit_split, walks.closest_hit_split_plain,
                dict(order_mode=m)) for m in walks.ORDER_MODES}
            runs["closest_hit_packet"] = (traverse.closest_hit_packet,
                                          walks.closest_hit_packet_plain,
                                          {})
            twins = {"closest_hit (fat)": lambda: traverse.closest_hit(
                         scene.p_fat, o, d, tm, *args),
                     "closest_hit_preorder (fat)": lambda:
                         traverse.closest_hit_preorder(scene.p_fat, o, d, tm,
                                                       *args)}
        times = []
        for name, (kernel, plain, kw) in runs.items():
            ms, use, steps = _kind_stats(kernel, plain, tab, o, d, tm, args,
                                         f"the {kind} rays", dev, **kw)
            log(f"{name} [{label}] {kind} rays={o.shape[0]} "
                f"kernel_ms={ms:.4f} lane_use={use:.3f} {_steps_text(steps)} "
                f"(kernel's step count equal)")
            times.append(f"{name} {ms:.3f}")
        times += [f"{name} {time_ms(fn, dev):.3f}"
                  for name, fn in twins.items()]
        log(f"  {kind} rays ({o.shape[0]}) kernel ms: " + ", ".join(times))
    return out, {name: (launches[name], launch_rays[name])
                 for name in SPLIT}


def dynamic_smem(name: str) -> int:
    """Dynamic shared memory a launch of the staged kernel `name` asks for
    (the warp packets' rings; the others use none)."""
    from ptsharp_tpu_torch.kernels import traverse

    if name not in PACKETS:
        return 0
    return traverse.cache_layout(getattr(traverse, name))[1]


def _packet_text(c) -> str:
    """Lane use, copies a packet step and prefetch hit rate from a warp
    packet's counts (accel.traverse.PACKET_COUNTS)."""
    steps, lanes, demand, used, discarded = c
    return (f"packet_steps={steps} lane_use={lanes / (32 * steps):.3f} "
            f"copies/packet_step={(demand + used + discarded) / steps:.4f} "
            f"(demand {demand / steps:.4f}) prefetch_hit_rate="
            f"{used / max(used + discarded, 1):.3f} (used {used}, discarded "
            f"{discarded}, demand {demand})")


def staged_phase(scene, rays, label):
    """The four memory-schedule kernels (two rays a lane, and the warp
    packets over a fat-pair ring, node and leaf rings, and one-row
    stages), driven once on the closest-hit rays of the main path with
    every launch count set to 0 just before and read just after, each
    with its counts; then each held against its plain version and its
    twin (#9 = #1, #10-#12 = #4) in every output on every lane, #9's
    steps against #1's, the warp packets' counts against the plain model
    of their schedule, and timed per ray kind beside its plain version
    and #1, #4 and #13, with #9's and #1's lane use. Returns ({wrapper
    name: {max_abs_err, ms, plain_ms}}, {wrapper name: launches})."""
    from ptsharp_tpu_torch.accel import tables
    from ptsharp_tpu_torch.accel import traverse as walks
    from ptsharp_tpu_torch.kernels import build, traverse

    dev = scene.p_fat.device
    fat = scene.p_fat
    *split_np, split = split_tables(fat.cpu().numpy(), scene.max_leaf,
                                    scene.wide_k, dev)
    padded = tuple(torch.from_numpy(tables.pad_rows(
        x, traverse.CACHE_BLOCK_ROWS)).to(dev) for x in split_np)
    log(f"staged tables [{label}]: rows {tuple(split[0].shape)}, leaf "
        f"{tuple(split[1].shape)}, padded to {tuple(padded[0].shape)} and "
        f"{tuple(padded[1].shape)}; "
        f"{sum(x.numel() for x in padded) * 4 / 2**20:.2f} MB padded, fat "
        f"{fat.numel() * 4 / 2**20:.2f} MB")
    org, dirn, n_cam = rays["org"], rays["dirn"], rays["n_cam"]
    args = _args(scene)
    tmax = torch.full((org.shape[0],), INF, device=dev)
    # wrapper -> (its tables, the twin it equals on every lane); #11 runs
    # on the unpadded split tables, which the JAX kernel misreads
    kernels = {
        "closest_hit_dual": ((fat,), "closest_hit"),
        "closest_hit_fat_cache": ((fat,), "closest_hit_preorder"),
        "closest_hit_block_cache": (padded, "closest_hit_preorder"),
        "closest_hit_row_stage": (split, "closest_hit_preorder"),
    }

    def run(name, o, d, tm, plain=False, counts=None):
        fn = getattr(walks, f"{name}_plain") if plain \
            else getattr(traverse, name)
        if counts is not None:
            return fn(*kernels[name][0], o, d, tm, *args, counts=counts)
        return fn(*kernels[name][0], o, d, tm, *args)

    def new_counts(name):
        n = len(walks.PACKET_COUNTS) if name in PACKETS else 2
        return torch.zeros(n, dtype=torch.int64, device=dev)

    # the path: each entry point once, as a caller of the kernel-level
    # API calls it, each with its counts
    kernel_counts = {name: new_counts(name) for name in kernels}
    traverse.reset_launch_counts()
    got = {name: run(name, org, dirn, tmax, counts=kernel_counts[name])
           for name in kernels}
    sync(dev)
    launches = {w.__name__: w.launches for w in traverse.WRAPPERS}
    launch_rays = {w.__name__: w.rays for w in traverse.WRAPPERS}
    for name, count in launches.items():
        if count != int(name in kernels):
            raise AssertionError(f"staged phase launched {name} {count} "
                                 f"times")
    log(f"staged path [{label}]: launches={launches}")

    twin_counts = {name: torch.zeros(2, dtype=torch.int64, device=dev)
                   for name in ("closest_hit", "closest_hit_preorder")}
    twins = {name: getattr(traverse, name)(fat, org, dirn, tmax, *args,
                                           counts=c)
             for name, c in twin_counts.items()}
    out = {}
    for name, (_tabs, twin) in kernels.items():
        with walks.count_work() as work:
            plain = run(name, org, dirn, tmax, plain=True)
        sync(dev)
        bnd = bound(work, org.shape[0], "closest")
        _equal(f"{name} against its plain version", got[name], plain)
        _equal(f"{name} against {twin}", got[name], twins[twin])
        err = float((got[name][0] - plain[0]).abs().max())
        ms = time_ms(lambda: run(name, org, dirn, tmax), dev)
        plain_ms = time_ms(lambda: run(name, org, dirn, tmax, plain=True),
                           dev, PLAIN_REPS)
        log(f"{name} [{label}] rays={org.shape[0]} max_abs_err_t={err:.3e} "
            f"slot_mismatches=0, equal to {twin} on every lane; "
            f"kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} {bound_text(bnd)}")
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bnd)

    report = ptxas_report(build.build_info.get("ptxas", ""))

    def ptxas_lines(name, smem=0):
        for kname, row in sorted(report.items()):
            if kname.startswith(name + "<"):
                log(f"  ptxas {kname}: {row.get('registers')} registers, "
                    f"stack frame {row.get('stack')} B, spill stores "
                    f"{row.get('spill_stores')} B, spill loads "
                    f"{row.get('spill_loads')} B, static smem {row['smem']} "
                    f"B, dynamic smem {smem} B")

    # #9's steps against #1's, both counted in the kernels
    dual, ordered = (c.tolist() for c in (kernel_counts["closest_hit_dual"],
                                          twin_counts["closest_hit"]))
    if dual[0] != ordered[0]:
        raise AssertionError(f"closest_hit_dual took {dual[0]} steps, "
                             f"closest_hit {ordered[0]}")
    log(f"closest_hit_dual [{label}] steps equal to closest_hit's: "
        f"{dual[0]}; lane use {dual[0] / dual[1]:.3f} (two slots a lane), "
        f"closest_hit's {ordered[0] / ordered[1]:.3f}")
    ptxas_lines("closest_hit_dual")

    # the warp packets' counts against the plain model of their schedule,
    # and their lanes' steps against #4's
    totals = {}
    pre_steps = int(twin_counts["closest_hit_preorder"][0])
    for name in PACKETS:
        wrapper = getattr(traverse, name)
        block_rows, smem, prefetch = traverse.cache_layout(wrapper)
        tabs = kernels[name][0]
        *model, mc = walks.warp_packet_plain(
            tabs[0], tabs[1] if len(tabs) > 1 else None, org, dirn, tmax,
            *args, block_rows=block_rows, prefetch=prefetch)
        _equal(f"{name} against the plain model of its schedule", got[name],
               model)
        want = [int(mc[key].sum()) for key in walks.PACKET_COUNTS]
        counted = totals[name] = kernel_counts[name].tolist()
        if counted != want:
            raise AssertionError(f"{name} counted {counted}, the plain model "
                                 f"of its schedule {want} "
                                 f"({walks.PACKET_COUNTS})")
        if counted[1] != pre_steps:
            raise AssertionError(f"{name}'s lanes took {counted[1]} steps, "
                                 f"closest_hit_preorder's rays {pre_steps}")
        log(f"{name} [{label}] counts equal to warp_packet_plain's and lane "
            f"steps to closest_hit_preorder's: {_packet_text(counted)}; "
            f"ring block {block_rows} rows, "
            f"{'prefetch' if prefetch else 'no prefetch'}, dynamic smem "
            f"{smem} B")
        ptxas_lines(name, smem)

    kind_counts = {name: [] for name in PACKETS}
    for kind, sl in (("camera", slice(0, n_cam)),
                     ("bounce", slice(n_cam, None))):
        o, d = org[sl].contiguous(), dirn[sl].contiguous()
        tm = tmax[sl].contiguous()
        times = {"#1 closest_hit": lambda: traverse.closest_hit(
                     fat, o, d, tm, *args),
                 "#4 closest_hit_preorder": lambda:
                     traverse.closest_hit_preorder(fat, o, d, tm, *args),
                 "#13 closest_hit_packet": lambda:
                     traverse.closest_hit_packet(*split, o, d, tm, *args)}
        for name in kernels:
            times[name] = functools.partial(run, name, o, d, tm)
            times[f"{name}_plain"] = functools.partial(run, name, o, d, tm,
                                                       plain=True)
        log(f"  {kind} rays ({o.shape[0]}) ms: " + ", ".join(
            f"{name} {time_ms(fn, dev, _reps(name)):.3f}"
            for name, fn in times.items()))
        for name in PACKETS:
            c = new_counts(name)
            run(name, o, d, tm, counts=c)
            kind_counts[name].append(c.tolist())
            log(f"{name} [{label}] {kind} rays={o.shape[0]} "
                f"{_packet_text(kind_counts[name][-1])}")
        dual_c, ordered_c = (new_counts("closest_hit_dual") for _ in "ab")
        run("closest_hit_dual", o, d, tm, counts=dual_c)
        traverse.closest_hit(fat, o, d, tm, *args, counts=ordered_c)
        (steps, slots), (ordered_steps, ordered_slots) = (
            dual_c.tolist(), ordered_c.tolist())
        if steps != ordered_steps:
            raise AssertionError(f"closest_hit_dual took {steps} steps on "
                                 f"the {kind} rays, closest_hit "
                                 f"{ordered_steps}")
        log(f"closest_hit_dual [{label}] {kind} rays={o.shape[0]} lane_use="
            f"{steps / slots:.3f} (closest_hit "
            f"{ordered_steps / ordered_slots:.3f}), steps equal "
            f"({steps / o.shape[0]:.3f} a ray)")
    # the two kinds' packets make up the whole run's where n_cam is a
    # multiple of the packet width
    for name in PACKETS:
        both = [sum(x) for x in zip(*kind_counts[name])]
        if n_cam % walks.PACKET_WIDTH == 0 and both != totals[name]:
            raise AssertionError(f"{name}'s counts per ray kind do not add "
                                 f"up to the whole run's")
    return out, {name: (launches[name], launch_rays[name])
                 for name in kernels}


def rows_phase(scene, rays, label):
    """The XLA walks' kernels on the rays of the main path, over the row
    tables of a "walk" (or "cluster") build (object-space rays of its one
    instance): the binary walk over u_rows (#14) and the K-wide
    closest-hit over w_rows (4w) on the closest-hit rays, the K-wide
    any-hit over w_rows on the shadow rays; driven once with every launch
    count set to 0 just before and read just after; each held against its
    plain version (every output on every lane), the two closest-hits
    against each other (t within CLOSEST_TOL, slots equal except ties),
    and the any-hit against the bounded closest-hit's t < INF on every
    shadow lane (the route the JAX package takes); per ray kind the times
    beside the plain versions, with lane use and steps counted in the
    kernels (equal to the plain versions'). Returns ({wrapper name:
    {max_abs_err, ms, plain_ms, bound_ms, bound_by}}, {wrapper name:
    launches})."""
    from ptsharp_tpu_torch.accel import traverse as walks
    from ptsharp_tpu_torch.intersect import _instance_rays
    from ptsharp_tpu_torch.kernels import traverse

    if scene.inst_inv.shape[0] != 1:
        raise AssertionError("the rows phase takes a one-instance scene")
    dev = scene.device
    org, dirn = _instance_rays(scene, 0, rays["org"], rays["dirn"])
    so, sd = _instance_rays(scene, 0, rays["shadow_org"], rays["shadow_dirn"])
    t_cut = rays["t_cut"]
    n_cam = rays["n_cam"]
    tmax = torch.full((org.shape[0],), INF, device=dev)
    ls, k = scene.max_leaf, scene.wide_k
    binary = (scene.u_rows, scene.leaf_rows)
    binary_args = (scene.u_inst_base[0], scene.u_inst_end[0], ls)
    wide = (scene.w_rows, scene.leaf_rows)
    wide_args = (scene.w_inst_base[0], scene.w_inst_end[0], ls, k)
    # wrapper -> (kernel, plain version, the rays it takes, result kind)
    runs = {
        "closest_hit_binary": (
            lambda o, d, t: traverse.closest_hit_binary(*binary, o, d, t,
                                                        *binary_args),
            lambda o, d, t: walks.traverse_packed(*binary, o, d, t,
                                                  *binary_args),
            (org, dirn, tmax), "closest"),
        "closest_hit_wide_rows": (
            lambda o, d, t: traverse.closest_hit_wide_rows(*wide, o, d, t,
                                                           *wide_args),
            lambda o, d, t: walks.traverse_wide(*wide, o, d, t, *wide_args),
            (org, dirn, tmax), "closest"),
        "any_hit_wide_rows": (
            lambda o, d, t: traverse.any_hit_wide_rows(*wide, o, d, t,
                                                       *wide_args),
            lambda o, d, t: walks.any_hit_wide_rows_plain(*wide, o, d, t,
                                                          *wide_args),
            (so, sd, t_cut), "any"),
    }
    log(f"rows tables [{label}]: u_rows {tuple(scene.u_rows.shape)}, w_rows "
        f"{tuple(scene.w_rows.shape)}, leaf_rows "
        f"{tuple(scene.leaf_rows.shape)}: "
        f"{sum(x.numel() for x in (scene.u_rows, scene.w_rows, scene.leaf_rows)) * 4 / 1e6:.2f} MB; "
        f"BLAS nodes [{binary_args[0]}, {binary_args[1]}) binary, "
        f"[{wide_args[0]}, {wide_args[1]}) wide; K-wide loads "
        f"{traverse.row_loads(*wide)}")

    # the path: each entry point once, as intersect.py calls it
    traverse.reset_launch_counts()
    got = {name: kernel(*inputs) for name, (kernel, _p, inputs, _k) in
           runs.items()}
    sync(dev)
    launches = {w.__name__: w.launches for w in traverse.WRAPPERS}
    launch_rays = {w.__name__: w.rays for w in traverse.WRAPPERS}
    for name, count in launches.items():
        if count != int(name in runs):
            raise AssertionError(f"rows phase launched {name} {count} times")
    log(f"rows path [{label}]: launches={launches}")

    out = {}
    for name, (kernel, plain, inputs, kind) in runs.items():
        with walks.count_work() as work:
            want = plain(*inputs)
        sync(dev)
        bnd = bound(work, inputs[0].shape[0], kind)
        if kind == "any":
            got[name], want = (got[name],), (want,)
        _equal(f"{name} against its plain version", got[name], want)
        err = float((got[name][0].float() - want[0].float()).abs().max())
        ms = time_ms(lambda: kernel(*inputs), dev)
        plain_ms = time_ms(lambda: plain(*inputs), dev, PLAIN_REPS)
        what = (f"occluded={float(want[0].float().mean()):.4f}"
                if kind == "any" else
                f"hit_frac={float((want[0] < INF).float().mean()):.4f}")
        log(f"{name} [{label}] rays={inputs[0].shape[0]} {what} "
            f"max_abs_err={err:.3e} every output equal to its plain version "
            f"on every lane; kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} "
            f"{bound_text(bnd)}")
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bnd)

    a, b = got["closest_hit_binary"], got["closest_hit_wide_rows"]
    close = torch.isclose(a[0], b[0], **CLOSEST_TOL)
    if not bool(close.all()):
        raise AssertionError(f"the binary and the K-wide walk differ in t on "
                             f"{int((~close).sum())} lanes")
    lanes, tie = _ties(scene, org, dirn, a[1], b[1], b[0])
    if not bool(tie.all()):
        raise AssertionError(f"the binary and the K-wide walk differ in slot "
                             f"off ties on {int((~tie).sum())} lanes")
    bit_equal = int(((a[0] == b[0]) & (a[1] == b[1])).sum())
    log(f"binary vs K-wide [{label}]: max_abs_diff_t="
        f"{float((a[0] - b[0]).abs().max()):.3e} slot_mismatches="
        f"{lanes.numel()} (all ties); bit-equal (t, slot) lanes {bit_equal} "
        f"of {org.shape[0]}")
    bounded = traverse.closest_hit_wide_rows(*wide, so, sd, t_cut,
                                             *wide_args)[0] < INF
    _equal("any_hit_wide_rows against the bounded closest-hit's t < INF",
           got["any_hit_wide_rows"], (bounded,))
    log(f"any_hit_wide_rows [{label}]: equal to closest_hit_wide_rows "
        f"bounded by t_cut, t < INF, on all {so.shape[0]} shadow lanes")

    kinds = {"camera": (org[:n_cam].contiguous(), dirn[:n_cam].contiguous(),
                        tmax[:n_cam].contiguous()),
             "bounce": (org[n_cam:].contiguous(), dirn[n_cam:].contiguous(),
                        tmax[n_cam:].contiguous()),
             "shadow": (so, sd, t_cut)}
    # wrapper -> (kernel, plain version, tables, arguments after the rays)
    counted = {"closest_hit_binary": (traverse.closest_hit_binary,
                                      walks.traverse_packed, binary,
                                      binary_args),
               "closest_hit_wide_rows": (traverse.closest_hit_wide_rows,
                                         walks.traverse_wide, wide,
                                         wide_args),
               "any_hit_wide_rows": (traverse.any_hit_wide_rows,
                                     walks.any_hit_wide_rows_plain, wide,
                                     wide_args)}
    for kind, rk in kinds.items():
        names = [n for n, r in runs.items() if (r[3] == "any") ==
                 (kind == "shadow")]
        times = []
        for name in names:
            kernel, plain, tabs, kargs = counted[name]
            ms, use, steps = _kind_stats(kernel, plain, tabs, *rk, kargs,
                                         f"the {kind} rays", dev)
            log(f"{name} [{label}] {kind} rays={rk[0].shape[0]} "
                f"kernel_ms={ms:.4f} lane_use={use:.3f} "
                f"{_steps_text(steps)} (kernel's step count equal)")
            times.append(f"{name} {ms:.3f}")
            times.append(f"{name}_plain "
                         f"{time_ms(lambda: runs[name][1](*rk), dev, PLAIN_REPS):.3f}")
        log(f"  {kind} rays ({rk[0].shape[0]}) ms: " + ", ".join(times))
    return out, {name: (launches[name], launch_rays[name])
                 for name in runs}


def cluster_chunk(scene, rays, chunk=CLUSTER_CHUNK):
    """#14's inputs in one chunk of the "cluster" intersector's
    closest-hit on a "cluster" build (accel/cluster.py intersect_clustered
    at its default chunk and k_cand): the first `chunk` bounce rays of
    `rays` in the instance's object space through the plain cull, and
    t_max the cull's best t where it left the ray unresolved, else -INF,
    as intersect_clustered calls #14. Returns (org, dirn, t_max,
    unresolved)."""
    from ptsharp_tpu_torch.accel import cluster
    from ptsharp_tpu_torch.intersect import _instance_rays

    n_cam = rays["n_cam"]
    o, d = _instance_rays(scene, 0, rays["org"][n_cam:n_cam + chunk],
                          rays["dirn"][n_cam:n_cam + chunk])
    tpc = scene.cluster_rows.shape[1] // 9
    bt, _s, _u, _v, unresolved = cluster._cull_and_intersect(
        scene.cluster_bmin, scene.cluster_bmax, scene.cluster_rows, tpc, o,
        d, torch.full((o.shape[0],), INF, device=scene.device),
        scene.inst_cluster_base[0], scene.inst_cluster_end[0],
        CLUSTER_K_CAND)
    t_walk = torch.where(unresolved, bt, torch.full_like(bt, -INF))
    return o, d, t_walk, unresolved


def cluster_chunk_phase(scene, rays, label):
    """#14 on one "cluster" chunk (cluster_chunk), held against its plain
    version in every output and in its kernel-counted steps, and timed on
    the card (kernel device time)."""
    from ptsharp_tpu_torch.accel import traverse as walks
    from ptsharp_tpu_torch.kernels import traverse

    dev = scene.device
    o, d, t_walk, unresolved = cluster_chunk(scene, rays)
    chunk = o.shape[0]
    tabs = (scene.u_rows, scene.leaf_rows)
    args = (scene.u_inst_base[0], scene.u_inst_end[0], scene.max_leaf)
    got = traverse.closest_hit_binary(*tabs, o, d, t_walk, *args)
    with walks.count_work() as work:
        want = walks.traverse_packed(*tabs, o, d, t_walk, *args)
    sync(dev)
    _equal("closest_hit_binary on a cluster chunk against its plain version",
           got, want)
    call_ms, use, steps = _kind_stats(
        traverse.closest_hit_binary, walks.traverse_packed, tabs, o, d,
        t_walk, args, "a cluster chunk", dev)
    ms = device_ms(lambda: traverse.closest_hit_binary(
        *tabs, o, d, t_walk, *args))
    plain_ms = time_ms(lambda: walks.traverse_packed(*tabs, o, d, t_walk,
                                                     *args), dev, PLAIN_REPS)
    walked = steps[unresolved]
    log(f"closest_hit_binary [{label}] cluster chunk of {chunk} bounce rays: "
        f"unresolved={int(unresolved.sum())} (their steps mean="
        f"{float(walked.float().mean()) if walked.numel() else 0.0:.3f} max="
        f"{int(walked.max()) if walked.numel() else 0}); every output equal "
        f"to its plain version; kernel device_ms={ms:.4f} (CUDA events "
        f"queued behind a spin kernel, median of 20 calls; call_ms="
        f"{call_ms:.4f} by CUDA events around the call) plain_ms="
        f"{plain_ms:.3f} lane_use={use:.3f} {_steps_text(steps)} (kernel's "
        f"step count equal) {bound_text(bound(work, chunk, 'closest'))}")


def leaf6_bunny(device):
    """The bunny mesh of examples.bunny() in a "wide" build at leaf 6
    (K=4): leaf_rows of 54 floats, not a 16-byte stride."""
    from ptsharp_tpu_torch import examples
    from ptsharp_tpu_torch.materials import diffuse_material
    from ptsharp_tpu_torch.scene import SceneBuilder

    b = SceneBuilder()
    m = examples._bunny_mesh(6).fit_inside([-1, 0, -1], [1, 2, 1],
                                           [0.5, 0.0, 0.5])
    b.add_mesh(m, diffuse_material([0.7, 0.65, 0.55]))
    return b.build(leaf_size=6, intersector="wide", wide_k=4, device=device)


def scalar_rows_phase(scene, rays, label):
    """The row kernels' scalar-load instances, which the wrappers take on
    leaf tables that are not 16-byte strides: on a leaf-6 "wide" build
    (leaf_rows of 54 floats), the K-wide closest-hit and the binary walk
    over its u_rows on the closest-hit rays and the K-wide any-hit on the
    shadow rays, each held against its plain version on every lane and in
    its kernel-counted steps, and timed."""
    from ptsharp_tpu_torch.accel import traverse as walks
    from ptsharp_tpu_torch.intersect import _instance_rays
    from ptsharp_tpu_torch.kernels import traverse

    dev = scene.device
    wide = (scene.w_rows, scene.leaf_rows)
    binary = (scene.u_rows, scene.leaf_rows)
    args = (scene.w_inst_base[0], scene.w_inst_end[0], scene.max_leaf,
            scene.wide_k)
    binary_args = (scene.u_inst_base[0], scene.u_inst_end[0],
                   scene.max_leaf)
    if traverse.row_loads(scene.leaf_rows) != "scalar":
        raise AssertionError("a leaf-6 build must take scalar loads")
    org, dirn = _instance_rays(scene, 0, rays["org"], rays["dirn"])
    so, sd = _instance_rays(scene, 0, rays["shadow_org"], rays["shadow_dirn"])
    tmax = torch.full((org.shape[0],), INF, device=dev)
    for kernel, plain, tabs, rk, kargs in (
            (traverse.closest_hit_wide_rows, walks.traverse_wide, wide,
             (org, dirn, tmax), args),
            (traverse.any_hit_wide_rows, walks.any_hit_wide_rows_plain,
             wide, (so, sd, rays["t_cut"]), args),
            (traverse.closest_hit_binary, walks.traverse_packed, binary,
             (org, dirn, tmax), binary_args)):
        got = kernel(*tabs, *rk, *kargs)
        want = plain(*tabs, *rk, *kargs)
        if kernel is traverse.any_hit_wide_rows:
            got, want = (got,), (want,)
        _equal(f"{kernel.__name__} (scalar loads) against its plain "
               f"version", got, want)
        ms, use, steps = _kind_stats(kernel, plain, tabs, *rk, kargs,
                                     "leaf-6 rays", dev)
        log(f"{kernel.__name__} [{label}] leaf 6, scalar leaf loads, node "
            f"rows {tuple(tabs[0].shape)} leaf_rows "
            f"{tuple(scene.leaf_rows.shape)}: rays={rk[0].shape[0]} equal "
            f"to its plain version on every lane; kernel_ms={ms:.4f} "
            f"lane_use={use:.3f} {_steps_text(steps)} (kernel's step count "
            f"equal)")


# ---- the TLAS and instanced scenes ------------------------------------------


def tlas_rays(scene, cam, width, height, n_cam, n_bounce):
    """The TLAS phases' rays: camera rays (Morton order over the full
    frame, as the renderer gives them), scattered bounce rays from their
    hits, and shadow rays from the bounce origins toward the lights with
    their t_cut (phase_rays' kinds, for a scene without a fat table)."""
    from tests.torch_walk_cases import bounce_rays, shadow_cut

    oc, dc = camera_rays(scene, cam, width, height, n_cam)
    ob, db = bounce_rays(scene, oc, dc, n_bounce)
    ds, t_cut = shadow_cut(scene, ob)
    return dict(org=torch.cat([oc, ob]).contiguous(),
                dirn=torch.cat([dc, db]).contiguous(), n_cam=n_cam,
                shadow_org=ob, shadow_dirn=ds, t_cut=t_cut)


def _kinds_text(kind):
    names = {0: "none", 1: "sphere", 2: "plane", 3: "cube", 4: "cylinder",
             5: "triangle"}
    counts = torch.bincount(kind.long(), minlength=6).tolist()
    return ", ".join(f"{names[k]} {c / kind.numel():.4f}"
                     for k, c in enumerate(counts) if c)


def tlas_phase(scene, rays, label):
    """The TLAS walk (csrc/tlas_walk.cu) over `scene`'s node rows (K-wide
    w_rows, or binary u_rows for a "walk" build) on the rays of the main
    path: closest_hit_tlas on the camera and bounce rays, any_hit_tlas on
    the shadow rays, driven once with every launch count set to 0 just
    before and read just after; each against its plain version in every
    output on every lane, and the any-hit against the bounded
    closest-hit's kind != PT_NONE on every shadow lane (the JAX package's
    shadow query); then per ray kind the kernel-counted steps (equal to
    the plain version's), lane use and time. Returns ({wrapper name:
    {max_abs_err, ms, plain_ms, bound_ms, bound_by}}, {wrapper name:
    launches})."""
    from ptsharp_tpu_torch.accel import traverse as walks
    from ptsharp_tpu_torch.intersect import scene_tlas
    from ptsharp_tpu_torch.kernels import traverse

    dev = scene.device
    tabs = scene_tlas(scene)
    org, dirn, n_cam = rays["org"], rays["dirn"], rays["n_cam"]
    so, sd, t_cut = rays["shadow_org"], rays["shadow_dirn"], rays["t_cut"]
    tmax = torch.full((org.shape[0],), INF, device=dev)
    log(f"tlas tables [{label}] ({scene.intersector}): node rows "
        f"{tuple(tabs.rows.shape)} (TLAS head {tabs.tlas_end}, K="
        f"{tabs.k or 'binary'}), leaf_rows {tuple(tabs.leaf.shape)}, "
        f"instances {tabs.inst_inv.shape[0]}, spheres "
        f"{tabs.sphere_center.shape[0]}, cubes {tabs.cube_min.shape[0]}, "
        f"cylinders {tabs.cyl_radius.shape[0]}")
    runs = {"closest_hit_tlas": (traverse.closest_hit_tlas,
                                 walks.closest_hit_tlas_plain,
                                 (org, dirn, tmax), "tlas"),
            "any_hit_tlas": (traverse.any_hit_tlas,
                             walks.any_hit_tlas_plain, (so, sd, t_cut),
                             "any")}
    traverse.reset_launch_counts()
    got = {name: kernel(tabs, *inputs)
           for name, (kernel, _p, inputs, _k) in runs.items()}
    sync(dev)
    launches = {w.__name__: w.launches for w in traverse.WRAPPERS}
    for name, count in launches.items():
        if count != int(name in runs):
            raise AssertionError(f"tlas phase launched {name} {count} times")
    log(f"tlas path [{label}]: launches={launches}; instances: "
        + "; ".join(f"{name} {getattr(traverse, name).instance}"
                    for name in runs))
    out = {}
    for name, (kernel, plain, inputs, kind) in runs.items():
        with walks.count_work() as work:
            want = plain(tabs, *inputs)
        sync(dev)
        bnd = bound(work, inputs[0].shape[0], kind)
        if kind == "any":
            got[name], want = (got[name],), (want,)
        _equal(f"{name} against its plain version", got[name], want)
        err = float((got[name][0].float() - want[0].float()).abs().max())
        ms = time_ms(lambda: kernel(tabs, *inputs), dev)
        kernel_ms = device_ms(lambda: kernel(tabs, *inputs))
        plain_ms = time_ms(lambda: plain(tabs, *inputs), dev, PLAIN_REPS)
        what = (f"occluded={float(want[0].float().mean()):.4f}"
                if kind == "any" else f"kinds: {_kinds_text(want[1])}")
        log(f"{name} [{label}] rays={inputs[0].shape[0]} {what} "
            f"max_abs_err={err:.3e} every output equal to its plain version "
            f"on every lane; kernel_ms={ms:.3f} device_ms={kernel_ms:.4f} "
            f"plain_ms={plain_ms:.3f} {bound_text(bnd)} (analytic tests "
            f"{dict(work.analytic)}, affine transforms {work.affine}, "
            f"instance entries {work.instances})")
        out[name] = dict(max_abs_err=err, ms=ms, device_ms=kernel_ms,
                         plain_ms=plain_ms, **bnd)
    bounded = traverse.closest_hit_tlas(tabs, so, sd, t_cut)[1] != 0
    _equal("any_hit_tlas against the bounded closest-hit's kind != PT_NONE",
           (got["any_hit_tlas"][0],), (bounded,))
    log(f"any_hit_tlas [{label}]: equal to closest_hit_tlas bounded by "
        f"t_cut, kind != PT_NONE, on all {so.shape[0]} shadow lanes")
    kinds = {"camera": (org[:n_cam].contiguous(), dirn[:n_cam].contiguous(),
                        tmax[:n_cam].contiguous()),
             "bounce": (org[n_cam:].contiguous(), dirn[n_cam:].contiguous(),
                        tmax[n_cam:].contiguous()),
             "shadow": (so, sd, t_cut)}
    for kind, rk in kinds.items():
        kernel, plain = ((traverse.any_hit_tlas, walks.any_hit_tlas_plain)
                         if kind == "shadow" else
                         (traverse.closest_hit_tlas,
                          walks.closest_hit_tlas_plain))
        ms, use, steps = _kind_stats(kernel, plain, (tabs,), *rk, (),
                                     f"the {kind} rays", dev)
        kernel_ms = device_ms(lambda: kernel(tabs, *rk))
        log(f"{kernel.__name__} [{label}] {kind} rays={rk[0].shape[0]} "
            f"kernel_ms={ms:.4f} device_ms={kernel_ms:.4f} lane_use={use:.3f}"
            f" {_steps_text(steps)} (kernel's step count equal)")
    return out, launches


# toybrick's builds and views of its tables whose TLAS walks run the
# tlas_walk.cu instances that the tlas phases' scenes do not (label ->
# (examples.toybrick fields, intersector, rows off a 16-byte boundary)):
# with the toybrick and binary-rows phases they run every instance
TLAS_INSTANCE_BUILDS = {
    "K=8, leaf 4": (dict(wide_k=8), "wide", False),
    "K=4, leaf 6": (dict(leaf_size=6), "wide", False),
    "K=8, leaf 6": (dict(wide_k=8, leaf_size=6), "wide", False),
    "binary rows, leaf 6": (dict(leaf_size=6), "walk", False),
    "K=3, leaf 4": (dict(wide_k=3), "wide", False),
    "K=4, leaf 4, rows off a 16-byte boundary": (dict(), "wide", True),
}
# rays of each kind (camera, bounce; and shadow) a build of the sweep
TLAS_INSTANCE_RAYS = 1 << 16


def _offset_rows(rows):
    """A copy of `rows` whose base lies 4 bytes past a 16-byte boundary."""
    buf = torch.empty(rows.numel() + 4, dtype=rows.dtype, device=rows.device)
    off = next(i for i in range(4) if (buf.data_ptr() + 4 * i) % 16 == 4)
    view = buf[off:off + rows.numel()].view(rows.shape)
    view.copy_(rows)
    return view


def tlas_instance_phase(device, label):
    """Every tlas_walk.cu instance that the tlas phases' scenes do not
    run, on toybrick rebuilt at TLAS_INSTANCE_BUILDS (K=8; leaf 6, whose
    leaf_rows of 54 floats are not a 16-byte stride: scalar leaves; K=3
    and rows off a 16-byte boundary: the run-time-K instance), on
    TLAS_INSTANCE_RAYS camera + bounce rays at 1920x1080 and their shadow
    rays: each launch's instance as tlas_instance names it, every output
    equal to the plain version on every lane, the kernel-counted steps
    equal to the plain version's, the any-hit equal to the bounded
    closest-hit's kind != PT_NONE; each kernel's time."""
    from ptsharp_tpu_torch import examples
    from ptsharp_tpu_torch.accel import traverse as walks
    from ptsharp_tpu_torch.intersect import scene_tlas
    from ptsharp_tpu_torch.kernels import traverse

    n = TLAS_INSTANCE_RAYS
    for name, (fields, walk, offset) in TLAS_INSTANCE_BUILDS.items():
        scene, cam, _rc, _ic = examples.toybrick(1920, 1080, device=device,
                                                 **fields)
        rays = tlas_rays(scene, cam, 1920, 1080, n, n)
        tabs = scene_tlas(replace(scene, intersector=walk))
        if offset:
            tabs = tabs._replace(rows=_offset_rows(tabs.rows))
        inst = traverse.tlas_instance(tabs)
        org, dirn = rays["org"], rays["dirn"]
        tmax = torch.full((org.shape[0],), INF, device=device)
        shadow = (rays["shadow_org"], rays["shadow_dirn"], rays["t_cut"])
        line = []
        for kernel, plain, inputs in (
                (traverse.closest_hit_tlas, walks.closest_hit_tlas_plain,
                 (org, dirn, tmax)),
                (traverse.any_hit_tlas, walks.any_hit_tlas_plain,
                 shadow)):
            counts = torch.zeros(2, dtype=torch.int64, device=device)
            got = kernel(tabs, *inputs, counts=counts)
            sync(device)
            if kernel.instance != inst:
                raise AssertionError(f"{kernel.__name__} [{name}] ran "
                                     f"{kernel.instance}, not {inst}")
            *want, steps = plain(tabs, *inputs, return_iters=True)
            if kernel is traverse.any_hit_tlas:
                got = (got,)
                bounded = traverse.closest_hit_tlas(tabs, *shadow)[1] != 0
                _equal(f"any_hit_tlas [{name}] against the bounded "
                       f"closest-hit", got, (bounded,))
            _equal(f"{kernel.__name__} [{name}] against its plain version",
                   got, tuple(want))
            if int(counts[0]) != int(steps.sum()):
                raise AssertionError(f"{kernel.__name__} [{name}]: "
                                     f"{int(counts[0])} steps counted, the "
                                     f"plain version's {int(steps.sum())}")
            ms = device_ms(lambda: kernel(tabs, *inputs))
            line.append(f"{kernel.__name__} rays={inputs[0].shape[0]} "
                        f"device_ms={ms:.4f} steps={int(counts[0])} "
                        f"lane_use={int(counts[0]) / int(counts[1]):.3f}")
        log(f"tlas instance [{label}, toybrick {name}] {inst}: every output "
            f"and the counted steps equal to the plain version's on every "
            f"lane, any_hit_tlas to the bounded closest-hit's; "
            + "; ".join(line))


def four_dragons(mesh, device, **build):
    """Four instances of dragon_hd's mesh (one with a material override)
    on a ground plane under one spherical light, built with the port's
    SceneBuilder: 4 x 1,310,720 instanced triangles, past FLAT_TRI_CAP, so
    a "pallas" build keeps one table of the one mesh and walks it per
    instance; a "wide" build walks the TLAS, which re-enters the mesh's
    BLAS. Returns (scene, camera, render config at 960x540 1 spp,
    integrator config)."""
    from ptsharp_tpu_torch.camera import Camera
    from ptsharp_tpu_torch.core import transform
    from ptsharp_tpu_torch.integrator import IntegratorConfig
    from ptsharp_tpu_torch.materials import (
        diffuse_material, glossy_material, light_material,
    )
    from ptsharp_tpu_torch.renderer import RenderConfig
    from ptsharp_tpu_torch.scene import SceneBuilder

    b = SceneBuilder()
    jade = glossy_material([0.35, 0.72, 0.45], 1.6, 0.28)
    places = ((-1.8, -1.0, 0.0), (1.8, -1.0, 0.6), (-1.8, 1.2, -0.6),
              (1.8, 1.2, 3.14))
    mid = None
    for i, (x, z, yaw) in enumerate(places):
        t = transform.translate([x, 0, z]) @ transform.rotate([0, 1, 0], yaw)
        over = diffuse_material([0.8, 0.35, 0.2]) if i == 3 else None
        if mid is None:
            mid = b.add_mesh(mesh, jade, transform=t)
        else:
            b.add_mesh_instance(mid, transform=t, material=over)
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.42, 0.42, 0.45]))
    b.add_sphere([-2.5, 6, -4], 1.4, light_material([1, 1, 1], 12.0))
    b.set_environment(color=[0.15, 0.17, 0.21])
    scene = b.build(device=device, **build)
    cam = Camera.look_at([0, 2.4, -5.2], [0, 0.5, 0.1], [0, 1, 0], 42.0,
                         device=device)
    return (scene, cam, RenderConfig(width=960, height=540, spp=1),
            IntegratorConfig(max_bounces=4))


def instance_phase(scene, rays, label):
    """The per-instance "pallas" path of a non-flat scene (one table of
    the one mesh, walked once per instance with object-space rays, as
    intersect.py walks it): in each walk order, the closest-hit kernel
    (#1 ordered, #4 preorder) on every instance's camera and bounce rays
    and the any-hit kernel (#2, #7) on its shadow rays, driven once with
    every launch count set to 0 just before and read just after (one
    launch an instance each); each launch against its plain version on
    every lane. Returns ({wrapper name: {max_abs_err}}, {wrapper name:
    launches})."""
    from ptsharp_tpu_torch.accel import traverse as walks
    from ptsharp_tpu_torch.intersect import _instance_rays
    from ptsharp_tpu_torch.kernels import traverse

    dev = scene.device
    n_inst = scene.inst_inv.shape[0]
    tmax = torch.full((rays["org"].shape[0],), INF, device=dev)
    local = [(_instance_rays(scene, i, rays["org"], rays["dirn"]),
              _instance_rays(scene, i, rays["shadow_org"],
                             rays["shadow_dirn"])) for i in range(n_inst)]
    out, counted = {}, {}
    for walk, (closest, anyhit) in WALKS.items():
        s = replace(scene, p_ordered=walk == "ordered")
        kc, ka = getattr(traverse, closest), getattr(traverse, anyhit)
        pc = getattr(walks, f"{closest}_plain")
        pa = getattr(walks, f"{anyhit}_plain")

        def args(i):
            return (s.p_inst_base[i], s.p_inst_end[i], s.max_leaf, s.wide_k)

        traverse.reset_launch_counts()
        t0 = time.perf_counter()
        got = [(kc(s.p_fat, *cr, tmax, *args(i)),
                ka(s.p_fat, *sr, rays["t_cut"], *args(i)))
               for i, (cr, sr) in enumerate(local)]
        sync(dev)
        sec = time.perf_counter() - t0
        launches = {w.__name__: w.launches for w in traverse.WRAPPERS}
        for name, count in launches.items():
            if count != n_inst * (name in (closest, anyhit)):
                raise AssertionError(f"instance phase launched {name} "
                                     f"{count} times")
        counted.update({closest: launches[closest],
                        anyhit: launches[anyhit]})
        for i, (cr, sr) in enumerate(local):
            _equal(f"{closest} on instance {i} against its plain version",
                   got[i][0], pc(s.p_fat, *cr, tmax, *args(i)))
            _equal(f"{anyhit} on instance {i} against its plain version",
                   (got[i][1],), (pa(s.p_fat, *sr, rays["t_cut"],
                                     *args(i)),))
        hits = sum(float((g[0][0] < INF).float().mean()) for g in got)
        log(f"instances [{label}] {walk}: {closest} and {anyhit} once an "
            f"instance ({n_inst} each) over node ranges "
            f"{sorted(set(zip(s.p_inst_base, s.p_inst_end)))}; "
            f"rays={rays['org'].shape[0]} and {rays['t_cut'].shape[0]} "
            f"shadow an instance; hit fraction summed over instances "
            f"{hits:.4f}; every output equal to its plain version on every "
            f"lane; the {2 * n_inst} launches {1e3 * sec:.1f} ms wall")
        for name in (closest, anyhit):
            out[name] = dict(max_abs_err=0.0)
    return out, counted


def stack_phase(device):
    """The ordered kernels, over the fat and the split tables, on trees
    whose max_stack_bound lies in (64, 128]: their t must be the
    stack-free preorder walk's (x = 1.55), and every shadow ray to
    t_cut = 3 occluded."""
    from ptsharp_tpu_torch.accel import tables
    from ptsharp_tpu_torch.accel import traverse as walks
    from ptsharp_tpu_torch.kernels import traverse
    from tests.torch_walk_cases import STACK_CHAINS, stack_chain

    for k, depth in STACK_CHAINS:
        fat_np = stack_chain(k, depth)
        bound = tables.max_stack_bound(fat_np[0::2], k)
        fat = torch.from_numpy(fat_np).to(device)
        tab = split_tables(fat_np, 1, k, device)[2]
        g = torch.Generator(device="cpu").manual_seed(k)
        n = 256
        org = torch.zeros((n, 3))
        org[:, 1:] = torch.rand((n, 2), generator=g) * 0.6 - 0.3
        d = torch.cat([torch.ones((n, 1)),
                       torch.rand((n, 2), generator=g) * 0.02 - 0.01], 1)
        org = org.to(device)
        d = (d / d.norm(dim=1, keepdim=True)).to(device)
        args = (0, fat.shape[0] // 2, 1, k)
        tm = torch.full((n,), INF, device=device)
        tc = torch.full((n,), 3.0, device=device)
        want = walks.closest_hit_preorder_plain(fat, org, d, tm, *args)
        runs = {"closest_hit": traverse.closest_hit(fat, org, d, tm, *args)}
        for mode in walks.ORDER_MODES:
            runs[f"closest_hit_split {mode}"] = traverse.closest_hit_split(
                *tab, org, d, tm, *args, order_mode=mode)
        for name, got in runs.items():
            _equal(f"{name} on a K={k} chain", got[:2], want[:2])
        occ = [traverse.any_hit(fat, org, d, tc, *args)] + [
            traverse.any_hit_split(*tab, org, d, tc, *args, order_mode=m)
            for m in walks.ORDER_MODES]
        if not all(bool(o.all()) for o in occ):
            raise AssertionError(f"an ordered any-hit misses the K={k} "
                                 f"chain's occluder")
        log(f"stack chain K={k}: max_stack_bound={bound}, ordered kernels "
            f"(fat and split, both orders) equal to the preorder walk, "
            f"t={float(want[0].min()):.4f}")


# ---- render ---------------------------------------------------------------


def render(scene, cam, rcfg, icfg, seed=0):
    from ptsharp_tpu_torch.core import rng
    from ptsharp_tpu_torch.renderer import Renderer

    r = Renderer(scene, cam, rcfg, icfg)
    sync(scene.device)
    t0 = time.perf_counter()
    film = r.render(key=rng.PRNGKey(seed))
    sync(scene.device)
    sec = time.perf_counter() - t0
    mean = film.mean
    if tuple(mean.shape) != (rcfg.height, rcfg.width, 3):
        raise AssertionError(f"film shape {tuple(mean.shape)}")
    if not bool(torch.isfinite(mean).all()) or not float(mean.mean()) > 0:
        raise AssertionError("film is not finite and positive")
    if r.rays_traced <= 0:
        raise AssertionError("no rays traced")
    return film, r.rays_traced, sec


def render_main(label, scene, cam, rcfg, icfg, card=""):
    """One render of the main path with every launch count set to 0 just
    before and read just after: exactly the build's kernels
    (RENDER_KERNELS) must have launched, the threefry uniform at least
    once, and the sphere-trace kernel once for each march of a scene whose
    marched shapes are SDFs alone (never for a scene without one).
    Returns {wrapper name: (launches, rays of those launches)}, with
    {"threefry.<wrapper>": (launches, words)} and {"sdf_march": (launches,
    rays)}."""
    from ptsharp_tpu_torch.geometry import march
    from ptsharp_tpu_torch.integrator import uses_anyhit_shadows
    from ptsharp_tpu_torch.kernels import sdf_march, threefry, traverse

    _reset_peak(scene.device)
    traverse.reset_launch_counts()
    threefry.reset_launch_counts()
    sdf_march.reset_launch_counts()
    march.reset_counts()
    film, rays, sec = render(scene, cam, rcfg, icfg)
    launches = {w.__name__: w.launches for w in traverse.WRAPPERS}
    draws = {f"threefry.{w.__name__}": (w.launches, w.words)
             for w in threefry.WRAPPERS}
    traced = (sdf_march.march.launches, sdf_march.march.rays)
    marches = {tag: tuple(c) for tag, c in sorted(march.COUNTS.items())}
    widths = {w.__name__: w.rays // w.launches for w in traverse.WRAPPERS
              if w.launches}
    if scene.use_tlas:
        walk = "tlas"
    elif not scene.has_meshes:
        walk = "none"
    elif scene.intersector == "pallas":
        walk = "ordered" if scene.p_ordered else "preorder"
    else:
        walk = scene.intersector
    expected = RENDER_KERNELS[walk]
    if not uses_anyhit_shadows(scene, icfg):
        # shadow rays take the build's closest-hit, bounded past the light
        expected = {n for n in expected if not n.startswith("any_hit")}
    n_inst = scene.inst_inv.shape[0]
    per_instance = scene.intersector == "pallas" and not scene.p_flat
    if per_instance:
        for name in expected:
            if launches[name] % n_inst:
                raise AssertionError(f"{label}: {name} launched "
                                     f"{launches[name]} times, not once an "
                                     f"instance a query")
        label = (f"{label} per instance ({n_inst} instances: "
                 f"{launches[WALKS[walk][0]] // n_inst} closest-hit queries)")
    log(f"render {label} {rcfg.width}x{rcfg.height} spp={rcfg.spp} "
        f"walk={walk} primary_rays={rcfg.width * rcfg.height * rcfg.spp} "
        f"rays_traced={rays} seconds={sec:.3f} "
        f"mrays_per_s={rays / sec / 1e6:.3f} film_mean="
        f"{float(film.mean.mean()):.6f} peak_mb={_peak_mb(scene.device)} "
        f"launches={launches} rays a launch={widths} threefry (launches, "
        f"words)={draws}"
        + (f" march (marches, steps, lane steps)={marches} sdf march "
           f"(launches, rays)={traced}" if marches else "") + f" [{card}]")
    if not draws["threefry.uniform"][0]:
        raise AssertionError(f"{label}: no draw launched the threefry "
                             f"uniform kernel")
    shapes = (len(scene.sdf_objects) + len(scene.volumes)
              + len(scene.functions))
    if bool(shapes) != bool(marches):
        raise AssertionError(f"{label}: {shapes} marched shapes, marches "
                             f"{marches}")
    n_marches = sum(c[0] for c in marches.values())
    if not scene.sdf_objects:
        sdf_ok = traced[0] == 0
    elif scene.volumes or scene.functions:
        sdf_ok = 0 < traced[0] < n_marches
    else:
        sdf_ok = traced[0] == n_marches
    if not sdf_ok:
        raise AssertionError(f"{label}: {traced[0]} sphere-trace kernel "
                             f"launches for {n_marches} marches of "
                             f"{len(scene.sdf_objects)} SDF and "
                             f"{shapes - len(scene.sdf_objects)} other "
                             f"marched shapes")
    for name, count in launches.items():
        if (name in expected) != (count > 0):
            raise AssertionError(f"{label} ({walk} walk) launched "
                                 f"{name} {count} times")
    return {**{w.__name__: (w.launches, w.rays) for w in traverse.WRAPPERS},
            **draws, "sdf_march": traced}


def reference_phase(device):
    """Small renders on the card against the same renders on the CPU,
    where the wrappers run the plain versions, equal bit for bit (the
    kernels equal their plain versions, and core/vec.py gives the card
    the CPU's float32 arithmetic): the bunny in both walk
    orders, "walk" and "wide", toybrick (the TLAS walk), the ordered
    and the "wide" bunny under each of MODES, the lit bunny's two
    builds under each of LIT_MODES, the scenes of GEOMETRY_SCENES and of
    CATALOG_SCENES and the OBJ bunny (its mesh at subdivisions 3)."""
    from ptsharp_tpu_torch import examples
    from ptsharp_tpu_torch.renderer import RenderConfig

    ordered = dict(intersector="pallas", wide_k=8)
    builds = {"bunny pallas_ordered=True": (examples.bunny, ordered, {}),
              "bunny pallas_ordered=False": (examples.bunny, dict(
                  ordered, pallas_ordered=False), {}),
              "bunny intersector=walk": (examples.bunny,
                                         dict(intersector="walk"), {}),
              "bunny intersector=wide": (examples.bunny,
                                         dict(intersector="wide"), {}),
              "toybrick (TLAS)": (examples.toybrick, None, {})}
    for label, fields in MODES:
        builds[f"bunny pallas_ordered=True, {label}"] = (examples.bunny,
                                                         ordered, fields)
        builds[f"bunny intersector=wide, {label}"] = (
            examples.bunny, dict(intersector="wide"), fields)
    for build in ("pallas", "wide"):
        for label, fields in LIT_MODES:
            builds[f"lit bunny {build}, {label}"] = (lit_bunny, dict(
                intersector=build), fields)
    for name in GEOMETRY_SCENES + tuple(CATALOG_SCENES):
        builds[name] = (functools.partial(examples.build, name), "catalog",
                        {})
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        obj_path, _mesh = obj_bunny_files(tmp, subdivisions=3)
        builds["OBJ bunny"] = (functools.partial(obj_bunny, obj_path),
                               "catalog", {})
        for name, (make, kw, fields) in builds.items():
            means = []
            for dev in (device, torch.device("cpu")):
                if kw == "catalog":
                    scene, cam, _rc, icfg = make(width=32, height=24,
                                                 device=dev)
                elif kw is None:
                    scene, cam, _rc, icfg = make(32, 24, device=dev)
                else:
                    scene, cam, _rc, icfg = make(32, 24, subdivisions=3,
                                                 device=dev, **kw)
                film, _rays, _sec = render(scene, cam,
                                           RenderConfig(32, 24, spp=1),
                                           replace(icfg, **fields), seed=5)
                means.append(film.mean.cpu().numpy().reshape(-1, 3))
            close = np.all(np.isclose(means[0], means[1], rtol=1e-4,
                                      atol=1e-4), axis=-1)
            rel = abs(means[0].mean() - means[1].mean()) / means[1].mean()
            diff = np.abs(means[0] - means[1])
            log(f"reference {name} 32x24: pixels_within_1e-4="
                f"{close.mean():.4f} mean_rel_diff={rel:.3e} "
                f"mean_abs_diff={diff.mean():.3e} "
                f"max_abs_diff={diff.max():.3e}")
            if diff.max() > 0:
                raise AssertionError("card render differs from the CPU "
                                     "render")


def surface_maps(size=MAP_SIZE, seed=14):
    """(normal map, bump map) of size x size texels, made with numpy from
    a fixed seed: a height field of sines and noise; the normal map its
    tangent-space normals mapped to [0, 1], the bump map its heights."""
    g = np.random.default_rng(seed)
    y, x = np.meshgrid(np.linspace(0, 1, size), np.linspace(0, 1, size),
                       indexing="ij")
    h = (0.5 + 0.2 * np.sin(40 * x) * np.cos(33 * y)
         + 0.1 * np.sin(90 * (x + y)) + 0.05 * g.random((size, size)))
    gy, gx = np.gradient(h * 8.0)
    n = np.stack([-gx, -gy, np.ones_like(h)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return ((n * 0.5 + 0.5).astype(np.float32),
            np.repeat(h[..., None], 3, axis=-1).astype(np.float32))


def lit_bunny(width=1920, height=1080, subdivisions=6,
              intersector="pallas", device=None):
    """The bunny's mesh under a normal map and a bump map, a ground plane,
    an emissive quad (quad_mesh), a cube whose per-triangle materials make
    four of its twelve triangles emissive (the OBJ Ke case) and the
    bunny's sphere light: three lights, two of them mesh lights, three
    mesh instances. "pallas" builds one flat tree (K=8, leaf 14), "wide"
    the TLAS over the three instances (K=4, leaf 8). Returns
    examples.bunny's four."""
    from ptsharp_tpu_torch import examples
    from ptsharp_tpu_torch.camera import Camera
    from ptsharp_tpu_torch.geometry.mesh import TriMesh, cube_mesh, quad_mesh
    from ptsharp_tpu_torch.integrator import IntegratorConfig
    from ptsharp_tpu_torch.materials import (
        Material, diffuse_material, light_material,
    )
    from ptsharp_tpu_torch.renderer import RenderConfig
    from ptsharp_tpu_torch.scene import SceneBuilder

    b = SceneBuilder()
    nmap, bmap = surface_maps()
    mat = Material(color=(0.7, 0.65, 0.55), normal_texture=b.add_texture(nmap),
                   bump_texture=b.add_texture(bmap), bump_multiplier=1.5)
    m = examples._bunny_mesh(subdivisions)
    b.add_mesh(m.fit_inside([-1, 0, -1], [1, 2, 1], [0.5, 0.0, 0.5]), mat)
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.75, 0.72, 0.68]))
    b.add_mesh(quad_mesh([-2.2, 3.0, -1.6], [-1.0, 3.0, -1.6],
                         [-1.0, 3.0, -0.4], [-2.2, 3.0, -0.4]),
               light_material([1.0, 0.85, 0.7], 6.0))
    lit = b.material_id(light_material([0.7, 0.9, 1.0], 5.0))
    dark = b.material_id(diffuse_material([0.3, 0.3, 0.35]))
    cube = cube_mesh([1.3, 0.0, -0.9], [1.9, 0.6, -0.3])
    b.add_mesh(TriMesh(v=cube.v, mat=np.array([lit] * 4 + [dark] * 8,
                                              np.int32)))
    b.add_sphere([3.5, 6, -3], 1.6, light_material([1, 1, 1], 9.0))
    b.set_environment(color=[0.10, 0.11, 0.14])
    pallas = intersector == "pallas"
    scene = b.build(leaf_size=14 if pallas else 8, intersector=intersector,
                    wide_k=8 if pallas else 4, device=device)
    cam = Camera.look_at([0, 1.8, -4.2], [0, 0.9, 0], [0, 1, 0], 38.0,
                         device=device)
    return scene, cam, RenderConfig(width=width, height=height, spp=1), \
        IntegratorConfig(max_bounces=4)


def modes_phase(bunnies, rcfg, device, card):
    """The integrator modes at the bunny's 1920x1080, 1 spp: each of
    `bunnies` (examples.bunny's four: the ordered pallas build of 3 and
    the default "wide" build) under MODES, the lit bunny's two builds
    under LIT_MODES, veach; each through render_main. Returns their
    runs."""
    from ptsharp_tpu_torch import examples

    runs = [render_main(f"bunny [{label}]", scene, cam, rcfg,
                        replace(icfg, **fields), card)
            for scene, cam, _rc, icfg in bunnies
            for label, fields in MODES]
    for build in ("pallas", "wide"):
        t0 = time.perf_counter()
        lit = lit_bunny(rcfg.width, rcfg.height, intersector=build,
                        device=device)
        n_tri = scene_line(f"lit bunny ({build})", lit[0],
                           time.perf_counter() - t0)
        if n_tri != 81920 + 2 + 12 or lit[0].num_lights != 3:
            raise AssertionError("the lit bunny: 81,934 triangles, three "
                                 "lights")
        if (lit[0].em_v0.shape[0] != 2 + 4 or not lit[0].has_surface_maps
                or lit[0].use_tlas != (build == "wide")):
            raise AssertionError(f"the lit bunny ({build}): six emissive "
                                 f"triangles, its maps, the TLAS for wide")
        for label, fields in LIT_MODES:
            runs.append(render_main(f"lit bunny [{label}]", lit[0], lit[1],
                                    lit[2], replace(lit[3], **fields), card))
        del lit
    vs, vc, _vrc, vic = examples.build("veach", width=rcfg.width,
                                       height=rcfg.height, device=device)
    runs.append(render_main("veach", vs, vc, rcfg, vic, card))
    return runs


# ---- geometry ---------------------------------------------------------------

# the catalog scenes of the marched shapes and meshing
GEOMETRY_SCENES = ("teapot", "ellipsoid", "sdf", "volume", "mol", "sh",
                   "heightfield", "love")
# the OBJ bunny's MTL: the bunny under a Kd material, a quad under a Ke one
OBJ_MTL = "newmtl body\nKd 0.7 0.65 0.55\nnewmtl lamp\nKe 6.0 5.1 4.2\n"
OBJ_LAMP = ("v -2.2 3.0 -1.6\nv -1.0 3.0 -1.6\nv -1.0 3.0 -0.4\n"
            "v -2.2 3.0 -0.4\nusemtl lamp\nf -4 -3 -2 -1\n")


def obj_bunny_files(directory, subdivisions=6):
    """Write the bunny's mesh (examples._bunny_mesh: 81,920 triangles at
    subdivisions 6, fitted as examples.bunny fits it) to bunny.obj with
    bunny.mtl: its triangles under the Kd material, then an emissive quad
    (a four-corner face by negative indices) under the Ke one; no texture.
    Returns (the OBJ's path, the mesh)."""
    from ptsharp_tpu_torch import examples
    from ptsharp_tpu_torch.io import obj

    m = examples._bunny_mesh(subdivisions).fit_inside([-1, 0, -1], [1, 2, 1],
                                                      [0.5, 0.0, 0.5])
    body = os.path.join(directory, "body.obj")
    obj.save_obj(m, body)
    with open(os.path.join(directory, "bunny.mtl"), "w") as f:
        f.write(OBJ_MTL)
    path = os.path.join(directory, "bunny.obj")
    with open(path, "w") as f, open(body) as src:
        f.write("mtllib bunny.mtl\nusemtl body\n")
        f.write(src.read())
        f.write(OBJ_LAMP)
    return path, m


def obj_bunny(path, width=1920, height=1080, device=None):
    """The OBJ bunny read back with load_obj(builder=...): its per-triangle
    materials make the Ke quad a mesh light; a ground plane and the
    bunny's sphere light; built "pallas" ordered (K=8, leaf 14). Returns
    examples.bunny's four."""
    from ptsharp_tpu_torch.camera import Camera
    from ptsharp_tpu_torch.integrator import IntegratorConfig
    from ptsharp_tpu_torch.io import obj
    from ptsharp_tpu_torch.materials import diffuse_material, light_material
    from ptsharp_tpu_torch.renderer import RenderConfig
    from ptsharp_tpu_torch.scene import SceneBuilder

    b = SceneBuilder()
    b.add_mesh(obj.load_obj(path, builder=b))
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.75, 0.72, 0.68]))
    b.add_sphere([3.5, 6, -3], 1.6, light_material([1, 1, 1], 9.0))
    b.set_environment(color=[0.10, 0.11, 0.14])
    scene = b.build(leaf_size=14, intersector="pallas", wide_k=8,
                    pallas_ordered=True, device=device)
    cam = Camera.look_at([0, 1.8, -4.2], [0, 0.9, 0], [0, 1, 0], 38.0,
                         device=device)
    return scene, cam, RenderConfig(width=width, height=height, spp=1), \
        IntegratorConfig(max_bounces=4)


def stl_round_trip(mesh, directory):
    """save_stl then load_stl: the same vertices, each facet's normal its
    face normal."""
    from ptsharp_tpu_torch.io import stl

    path = os.path.join(directory, "bunny.stl")
    stl.save_stl(mesh, path)
    back = stl.load_stl(path)
    if not (np.array_equal(back.v, mesh.v) and np.array_equal(
            back.n, np.repeat(mesh.face_normals()[:, None], 3, axis=1))):
        raise AssertionError("the STL round trip changed the mesh")
    log(f"stl round trip: {back.num_triangles} triangles, "
        f"{os.path.getsize(path)} bytes, equal arrays")


NUMERICS_N = 200_000  # inputs of each card-against-CPU numerics check


def rays_at_box(lo, hi, n, seed):
    """n rays from a sphere around the box [lo, hi] toward points in and
    around it, made with numpy from `seed`: (org, dirn) CPU tensors."""
    g = np.random.default_rng(seed)
    lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    c, ext = (lo + hi) / 2, (hi - lo) / 2
    u = g.normal(size=(n, 3))
    org = c + (2.5 * float(np.linalg.norm(ext)) + 0.5) * u / np.linalg.norm(
        u, axis=1, keepdims=True)
    d = c + ext * g.uniform(-1.2, 1.2, (n, 3)) - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.from_numpy(org.astype(np.float32)),
            torch.from_numpy(d.astype(np.float32)))


def numerics_check(device):
    """The card against the CPU, bit for bit, on inputs made with numpy
    from a seed: core/vec.py's device-independent scalar functions and
    products (NUMERICS_N inputs each); the four expressions that divided
    a tensor by a Python number, which the card took as a product with
    its reciprocal (vec.div by 3 and pi, the bump map's luminance, the
    cone's angle, env_uv and sphere_uv); and the marched shapes: sdf's and
    love's trees evaluated, sphere traced and their normals, volume's
    trilinear sample and march, heightfield's march (NUMERICS_N / 4 rays
    at each box). Raises on any differing bit (the SDF normals: any
    difference above 1e-9)."""
    from ptsharp_tpu_torch import examples, integrator
    from ptsharp_tpu_torch.core import sampling, vec
    from ptsharp_tpu_torch.geometry import function, primitives, sdf, volume
    from ptsharp_tpu_torch.textures import TextureAtlas

    cpu = torch.device("cpu")

    def same(what, fn, *args, atol=0.0):
        a = fn(*args)
        b = fn(*(x.to(device) for x in args)).cpu()
        share = float((a == b).float().mean())
        worst = float((a - b).abs().max()) if a.numel() else 0.0
        log(f"numerics {what}: card == CPU on {share:.6f} of {a.numel()} "
            f"values, at most {worst:.3e} apart")
        if worst > atol:
            raise AssertionError(f"{what}: the card's bits differ")

    g = np.random.default_rng(15)
    pos = torch.from_numpy(g.uniform(0.01, 9.0, NUMERICS_N).astype(
        np.float32))
    unit = torch.from_numpy(g.uniform(-1, 1, NUMERICS_N).astype(np.float32))
    a, b = (torch.from_numpy(g.normal(size=(NUMERICS_N, 3)).astype(
        np.float32)) for _ in range(2))
    m = torch.from_numpy(g.normal(size=(NUMERICS_N, 3, 4)).astype(
        np.float32))
    for name in ("sqrt", "rsqrt", "sin", "cos"):
        same(f"vec.{name}", getattr(vec, name), pos)
    same("vec.acos", vec.acos, unit)
    same("vec.atan2", vec.atan2, a[:, 0], a[:, 1])
    for name in ("dot", "cross"):
        same(f"vec.{name}", getattr(vec, name), a, b)
    same("vec.normalize", vec.normalize, a)
    same("vec.affine", vec.affine, m, a)
    # the divisions by Python numbers, each by a float32 tensor on the
    # operand's device (vec.div): the bump map's luminance, the cone's
    # angle, the environment's and the sphere's lat-long coordinates
    for d in (3.0, math.pi):
        same(f"vec.div by {d:.6g}", functools.partial(vec.div, d=d), a)
    unit_a = vec.normalize(a)
    tex = torch.from_numpy(g.uniform(0, 1, (2, 64, 48, 3)).astype(
        np.float32))
    sizes = torch.tensor([[64, 48], [40, 33]], dtype=torch.int32)
    tid = torch.from_numpy(g.integers(0, 2, NUMERICS_N).astype(np.int32))
    u1 = torch.from_numpy(g.uniform(0, 1, NUMERICS_N).astype(np.float32))
    same("bump map luminance (textures.py)",
         lambda x, sz, *r: TextureAtlas(x, sz).bump_sample(*r), tex, sizes,
         tid, u1, unit.abs())
    same("cone (core/sampling.py)", sampling.cone, unit_a, u1 * 0.6, u1,
         unit.abs())
    same("env_uv (integrator.py)", lambda d: torch.stack(integrator.env_uv(
        types.SimpleNamespace(texture_angle=0.3), d)), unit_a)
    same("sphere_uv (geometry/primitives.py)",
         lambda p, c: torch.stack(primitives.sphere_uv(p, c, 1.0)), a, b)
    n = NUMERICS_N // 4
    for name in ("sdf", "love"):
        tree = examples.build(name, width=8, height=8,
                              device=cpu)[0].sdf_objects[0][0]
        lo, hi = (torch.tensor(x) for x in tree.bounds())
        org, dirn = rays_at_box(lo, hi, n, seed=16)
        te, tx = primitives.box_entry_exit(org, dirn, lo, hi)
        same(f"{name} tree distances", tree.evaluate,
             lo + (hi - lo) * torch.rand(n, 3, generator=torch.Generator(
             ).manual_seed(17)))
        same(f"{name} sphere trace t", functools.partial(
            sdf.sphere_trace, tree), org, dirn, te, tx)
        t = sdf.sphere_trace(tree, org, dirn, te, tx)
        hit = t < INF
        # in float64: torch's CPU float64 sqrt misses by an ulp on ~0.9%
        # of inputs, which moves a float32 normal component of magnitude
        # below ~1e-5 by less than 1e-12
        same(f"{name} normals", functools.partial(sdf.sdf_normal, tree),
             org[hit] + dirn[hit] * t[hit, None], atol=1e-9)
    vs = examples.build("volume", width=8, height=8, device=cpu)[0]
    vol, data = vs.volumes[0], vs.volume_data[0]
    org, dirn = rays_at_box(vol.bmin, vol.bmax, n, seed=18)
    te, tx = primitives.box_entry_exit(org, dirn, *vol.box(cpu))
    same("volume samples", lambda d, p: volume.sample(d, vol, p), data,
         org + dirn * 3.0)
    same("volume march t", lambda d, *r: volume.intersect(d, vol, *r), data,
         org, dirn, te, tx)
    hf = examples.build("heightfield", width=8, height=8,
                        device=cpu)[0].functions[0][0]
    org, dirn = rays_at_box(hf.bmin, hf.bmax, n, seed=19)
    te, tx = primitives.box_entry_exit(org, dirn, torch.tensor(hf.bmin),
                                       torch.tensor(hf.bmax))
    same("heightfield march t", functools.partial(function.intersect, hf),
         org, dirn, te, tx)


def geometry_phase(device, card):
    """The marched shapes and the mesh I/O at 1920x1080, 1 spp, after
    numerics_check: the OBJ bunny (written with an MTL, read back by
    load_obj, "pallas" ordered: #1/#2) and the STL round trip of its mesh,
    then each scene of GEOMETRY_SCENES at its own max_bounces, each
    through render_main. Returns their runs."""
    from ptsharp_tpu_torch import examples
    from ptsharp_tpu_torch.scene import PT_TRIANGLE

    numerics_check(device)
    runs = []
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        t0 = time.perf_counter()
        path, mesh = obj_bunny_files(tmp)
        stl_round_trip(mesh, tmp)
        ob = obj_bunny(path, device=device)
        n_tri = scene_line("OBJ bunny", ob[0], time.perf_counter() - t0)
        if (n_tri != 81920 + 2 or PT_TRIANGLE not in ob[0].light_types
                or ob[0].em_v0.shape[0] != 2):
            raise AssertionError("the OBJ bunny: 81,922 triangles, two of "
                                 "them a Ke mesh light")
        runs.append(render_main("OBJ bunny", *ob, card))
        del ob
    for name in GEOMETRY_SCENES:
        t0 = time.perf_counter()
        scene, cam, rcfg, icfg = examples.build(name, width=1920,
                                                height=1080, device=device)
        n_analytic = (scene.sphere_center.shape[0] + scene.cube_min.shape[0]
                      + scene.cyl_radius.shape[0])
        log(f"{name} scene: build {time.perf_counter() - t0:.1f} s, "
            f"{len(scene.sdf_objects)} SDF, {len(scene.volumes)} volume, "
            f"{len(scene.functions)} heightfield, "
            f"{scene.inst_inv.shape[0]} mesh instances, "
            f"{n_analytic} analytic, use_tlas={scene.use_tlas}, "
            f"max_bounces={icfg.max_bounces}")
        runs.append(render_main(name, scene, cam, replace(rcfg, spp=1), icfg,
                                card))
    return runs


# ---- catalog --------------------------------------------------------------

# the fourteen scenes of the rest of the catalog and the walk each build
# takes: one mesh of the default "wide" build (4w/7w), the TLAS (64 or more
# analytic primitives: tw/ta), or analytic primitives alone (no kernel)
CATALOG_SCENES = {
    "simple_sphere": "none", "material_spheres": "none",
    "refraction": "none", "mesh": "wide", "dragon": "wide",
    "suzanne": "wide", "gopher": "none", "cylinder_field": "none",
    "hits": "none", "craft": "tlas", "runway": "tlas", "go": "none",
    "qbert": "tlas", "maze": "tlas",
}
CLI_SCENE = "maze"
CLI_ITERS = 2       # examples.main's iterations
RESUME_ITERS = 4    # the checkpointed render's iterations
BEADS_FRAMES = 2


def decode_png(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of an 8-bit RGB PNG whose scanlines are all filter
    0 (what film.encode_png writes), read with zlib alone."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError("not a PNG")
    pos, idat, size = 8, b"", None
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            w, h = int.from_bytes(body[:4], "big"), int.from_bytes(
                body[4:8], "big")
            if tuple(body[8:13]) != (8, 2, 0, 0, 0):
                raise AssertionError(f"PNG header {tuple(body[8:13])}")
            size = (h, w)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    h, w = size
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if raw[:, 0].any():
        raise AssertionError("a scanline filter other than 0")
    return raw[:, 1:].reshape(h, w, 3)


def _png_equal(path, image01, what):
    from ptsharp_tpu_torch.film import quantize

    with open(path, "rb") as f:
        got = decode_png(f.read())
    if not np.array_equal(got, quantize(image01)):
        raise AssertionError(f"{what}: {os.path.basename(path)} is not the "
                             f"quantised film")
    return got.shape


def compacted_phase(device, card):
    """integrator.trace_compacted (one host sync) on cornell's RR
    configuration at 1920x1080, 1 spp, the renderer's camera rays, beside
    trace and trace_compacted_static on the same rays and key: seconds,
    rays and the compacted width (the survivors' power of two); its mean
    within 1% of trace's, and every lane that died before the compaction
    point equal to trace's bit for bit."""
    from ptsharp_tpu_torch import examples, integrator
    from ptsharp_tpu_torch.core import rng

    scene, cam, _rc, icfg = examples.build("cornell", width=1920,
                                           height=1080, device=device)
    org, dirn = camera_rays(scene, cam, 1920, 1080, 1920 * 1080)
    key = rng.PRNGKey(3)
    caps = []
    finish = integrator._compact_and_finish

    def record_cap(scene_, cfg, state, krest, cap, d0, d1):
        caps.append(cap)
        return finish(scene_, cfg, state, krest, cap, d0, d1)

    out = {}
    with torch.no_grad():
        for name in ("trace", "trace_compacted_static", "trace_compacted"):
            fn = getattr(integrator, name)
            integrator._compact_and_finish = record_cap
            try:
                fn(scene, icfg, org, dirn, key)  # warm-up
                sync(device)
                t0 = time.perf_counter()
                res = fn(scene, icfg, org, dirn, key)
                sync(device)
                sec = time.perf_counter() - t0
            finally:
                integrator._compact_and_finish = finish
            rad = res.radiance
            if not bool(torch.isfinite(rad).all()):
                raise AssertionError(f"cornell {name}: radiance not finite")
            out[name] = (rad, int(res.rays_traced), sec)
        d_stop = icfg.rr_start_depth + 1
        state, *_rest = integrator._trace_prefix(scene, icfg, org, dirn, key,
                                                 None, 1, d_stop)
    dead = ~state.alive
    n = org.shape[0]
    ref = out["trace"][0]
    for name, (rad, rays, sec) in out.items():
        rel = abs(float(rad.mean()) - float(ref.mean())) / float(ref.mean())
        extra = ""
        if name == "trace_compacted":
            if len(caps) != 2 or caps[0] >= n:
                raise AssertionError(f"trace_compacted did not compact: "
                                     f"caps {caps}")
            same = bool(torch.equal(rad[dead], ref[dead]))
            extra = (f" compacted_width={caps[-1]} of {n} (alive at depth "
                     f"{d_stop}: {int((~dead).sum())}) dead lanes equal "
                     f"to trace={same}")
            if not same:
                raise AssertionError("trace_compacted changed a lane dead "
                                     "before its compaction")
        if rel > 0.01:
            raise AssertionError(f"cornell {name}: mean {rel:.3e} from "
                                 f"trace's")
        log(f"compacted cornell 1920x1080 RR (max_bounces="
            f"{icfg.max_bounces}, rr_start_depth={icfg.rr_start_depth}) "
            f"{name}: seconds={sec:.3f} rays_traced={rays} "
            f"mrays_per_s={rays / sec / 1e6:.3f} mean_rel_to_trace="
            f"{rel:.3e}{extra} [{card}]")


def cli_phase(device, card):
    """The command line and iterative_render's options on the card:
    examples.main on CLI_SCENE with CLI_ITERS iterations into a temporary
    directory (its PNGs decoded with zlib); then iterative_render of the
    same scene for CLI_ITERS iterations with a checkpoint every
    iteration, denoise=True and a ViewerServer on a free loopback port
    (frame.png fetched with urllib and equal to the last frame's
    encoding), each PNG equal to the quantised film; a resume from that
    checkpoint to RESUME_ITERS iterations, equal bit for bit to an
    uninterrupted run; denoise_film's milliseconds at 1920x1080; and
    render_animation's BEADS_FRAMES beads frames."""
    import socket
    import urllib.request

    from ptsharp_tpu_torch import examples
    from ptsharp_tpu_torch.core import color as colorlib
    from ptsharp_tpu_torch.core import rng
    from ptsharp_tpu_torch.denoise import denoise_film
    from ptsharp_tpu_torch.film import encode_png
    from ptsharp_tpu_torch.renderer import RenderConfig, Renderer
    from ptsharp_tpu_torch.viewer import ViewerServer

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        t0 = time.perf_counter()
        out = os.path.join(tmp, f"{CLI_SCENE}_%d.png")
        if examples.main([CLI_SCENE, str(CLI_ITERS), out]) != 0:
            raise AssertionError("examples.main failed")
        shapes = []
        for it in range(1, CLI_ITERS + 1):
            with open(out % it, "rb") as f:
                shapes.append(decode_png(f.read()).shape)
        log(f"cli examples.main([{CLI_SCENE!r}, '{CLI_ITERS}', ...]): "
            f"{time.perf_counter() - t0:.2f} s, PNGs {shapes}")

        scene, cam, rcfg, icfg = examples.build(CLI_SCENE, device=device)
        key = rng.PRNGKey(0)
        ckpt = os.path.join(tmp, "state.npz")
        frames = os.path.join(tmp, "it_%d.png")
        with socket.socket() as probe:
            probe.bind(("127.0.0.1", 0))
            port = probe.getsockname()[1]
        viewer = ViewerServer(port=port).start()
        try:
            t0 = time.perf_counter()
            first = Renderer(scene, cam, rcfg, icfg).iterative_render(
                CLI_ITERS, key=key, path_template=frames, denoise=True,
                checkpoint_path=ckpt, checkpoint_every=1, viewer=viewer)
            sync(device)
            sec = time.perf_counter() - t0
            url = f"http://127.0.0.1:{port}"
            page = urllib.request.urlopen(url + "/", timeout=10).read()
            served = urllib.request.urlopen(url + "/frame.png",
                                            timeout=10).read()
        finally:
            viewer.stop()
        if b"frame.png" not in page or served != encode_png(
                first.color_srgb()):
            raise AssertionError("the viewer did not serve the last frame")
        shape = _png_equal(frames % CLI_ITERS, first.color_srgb(),
                           "iterative_render")
        _png_equal((frames % CLI_ITERS).replace(".png", "_denoised.png"),
                   colorlib.to_srgb(denoise_film(first)), "denoise")
        log(f"cli iterative_render {CLI_SCENE} {rcfg.width}x{rcfg.height} "
            f"spp={rcfg.spp} x {CLI_ITERS} with a checkpoint every "
            f"iteration, denoise and the viewer on 127.0.0.1:{port}: "
            f"{sec:.2f} s; PNG {shape} equal to the quantised film, "
            f"*_denoised.png to the denoised one, frame.png "
            f"{len(served)} bytes served")

        t0 = time.perf_counter()
        resumed = Renderer(scene, cam, rcfg, icfg).iterative_render(
            RESUME_ITERS, key=key, checkpoint_path=ckpt, checkpoint_every=1)
        sync(device)
        t_resume = time.perf_counter() - t0
        whole = Renderer(scene, cam, rcfg, icfg).iterative_render(
            RESUME_ITERS, key=key)
        same = all(torch.equal(a, b) for a, b in zip(resumed, whole))
        log(f"cli resume from iteration {CLI_ITERS} to {RESUME_ITERS}: "
            f"{t_resume:.2f} s, film equal bit for bit to an uninterrupted "
            f"{RESUME_ITERS}-iteration run={same}")
        if not same:
            raise AssertionError("the resumed render differs")

        big = render(*examples.build(CLI_SCENE, width=1920, height=1080,
                                     device=device)[:2],
                     RenderConfig(1920, 1080, spp=1), icfg)[0]
        ms = time_ms(lambda: denoise_film(big), device)
        log(f"cli denoise_film 1920x1080 (4 a-trous passes, albedo and "
            f"normal guides): {ms:.3f} ms [{card}]")

        t0 = time.perf_counter()
        beads = os.path.join(tmp, "beads_%03d.png")
        examples.render_animation(BEADS_FRAMES, beads, device=device)
        shapes = []
        for f in range(BEADS_FRAMES):
            with open(beads % f, "rb") as fh:
                shapes.append(decode_png(fh.read()).shape)
        log(f"cli render_animation({BEADS_FRAMES}): "
            f"{time.perf_counter() - t0:.2f} s, PNGs {shapes}")


def catalog_phase(device, card):
    """The rest of the catalog at 1920x1080, 1 spp: each scene of
    CATALOG_SCENES built on the card and rendered through render_main
    (its seconds, Mrays/s, peak MB and launches: exactly its walk's
    kernels), the walk checked against CATALOG_SCENES; then
    compacted_phase and cli_phase. Returns the renders' runs."""
    from ptsharp_tpu_torch import examples

    runs = []
    for name, walk in CATALOG_SCENES.items():
        t0 = time.perf_counter()
        scene, cam, rcfg, icfg = examples.build(name, width=1920,
                                                height=1080, device=device)
        n_analytic = (scene.sphere_center.shape[0] + scene.cube_min.shape[0]
                      + scene.cyl_radius.shape[0])
        built = ("tlas" if scene.use_tlas else scene.intersector
                 if scene.has_meshes else "none")
        log(f"{name} scene: build {time.perf_counter() - t0:.1f} s, "
            f"{scene.inst_inv.shape[0]} mesh instances, {n_analytic} "
            f"analytic, {scene.num_lights} lights, use_tlas="
            f"{scene.use_tlas}, walk={built}, max_bounces="
            f"{icfg.max_bounces}, light_mode={icfg.light_mode}")
        if built != walk:
            raise AssertionError(f"{name}: walk {built}, expected {walk}")
        runs.append(render_main(name, scene, cam, replace(rcfg, spp=1), icfg,
                                card))
        del scene
    compacted_phase(device, card)
    cli_phase(device, card)
    return runs


# ---- grad -----------------------------------------------------------------

# per DiffParams leaf: gradients agree within rtol 1e-3 and an atol of 1e-3
# of the leaf's largest magnitude (the CPU tests' tolerance against the
# JAX package; card sums run in no fixed order, so never bit equality)
GRAD_RTOL = 1e-3
GRAD_ATOL_REL = 1e-3
GRAD_REPS = 3  # runs of each gradient mode; the first pays first-use costs
# (label, use_tape, IntegratorConfig fields)
GRAD_MODES = (
    ("tape", True, {}),
    ("AD remat full", False, {"remat": True, "remat_policy": "full"}),
    ("AD remat hits", False, {"remat": True, "remat_policy": "hits"}),
    ("AD remat off", False, {"remat": False}),
)
SGD_STEPS = 3
SGD_LR = 0.5       # shard.make_train_step's
SGD_SCALE = 0.7    # the target's plain material colors, against the scene's


def _counts():
    """{wrapper name: (launches, rays)} since the last reset."""
    from ptsharp_tpu_torch.kernels import traverse

    return {w.__name__: (w.launches, w.rays) for w in traverse.WRAPPERS}


def _launched(counts):
    return {name: n for name, (n, _rays) in counts.items() if n}


def _add_counts(total, counts):
    for name, (n, rays) in counts.items():
        a, b = total.get(name, (0, 0))
        total[name] = (a + n, b + rays)


def _peak_mb(device):
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2**20


def _reset_peak(device):
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def grads_close(what, got, want):
    """Raise unless each DiffParams leaf of `got` is finite and agrees
    with `want`'s (GRAD_RTOL, GRAD_ATOL_REL); returns the largest error
    over each leaf's largest magnitude."""
    from ptsharp_tpu_torch.tape import DiffParams

    worst = 0.0
    for name, a, b in zip(DiffParams._fields, got, want):
        a, b = a.float().cpu(), b.float().cpu()
        scale = float(b.abs().max())
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{what}: {name} gradient is not finite")
        if not torch.allclose(a, b, rtol=GRAD_RTOL,
                              atol=GRAD_ATOL_REL * scale):
            raise AssertionError(
                f"{what}: {name} gradients differ by "
                f"{float((a - b).abs().max()):.3e} (max |g| {scale:.3e})")
        if scale > 0:
            worst = max(worst, float((a - b).abs().max()) / scale)
    return worst


def grad_run(scene, cam, icfg, width, height, weights, use_tape, seed=0):
    """One forward and backward of sum(render_image * weights) with
    respect to the scene's DiffParams leaves, each half with every launch
    count set to 0 just before and read just after. Returns the
    gradients, the two halves' launches (the traversal wrappers', and the
    table sum's launches and lanes as "table_sum"), their wall ms and the
    peak device memory."""
    from ptsharp_tpu_torch import diff
    from ptsharp_tpu_torch.core import rng
    from ptsharp_tpu_torch.kernels import table_sum, traverse
    from ptsharp_tpu_torch.tape import DiffParams, plug

    def reset():
        traverse.reset_launch_counts()
        table_sum.reset_launch_counts()

    def counts():
        return {**_counts(), "table_sum": (table_sum.table_sum.launches,
                                           table_sum.table_sum.lanes)}

    dev = scene.device
    leaves = [x.detach().clone().requires_grad_()
              for x in DiffParams.of(scene)]
    s = plug(scene, DiffParams(*leaves))
    _reset_peak(dev)
    sync(dev)
    reset()
    t0 = time.perf_counter()
    img = diff.render_image(s, cam, icfg, rng.PRNGKey(seed), width, height,
                            1, use_tape=use_tape)
    loss = (img * weights).sum()
    sync(dev)
    t1 = time.perf_counter()
    fwd = counts()
    reset()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    sync(dev)
    t2 = time.perf_counter()
    bwd = counts()
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, leaves)]
    if not bool(torch.isfinite(img).all()):
        raise AssertionError("the gradient run's image is not finite")
    return dict(grads=grads, fwd=fwd, bwd=bwd,
                fwd_ms=(t1 - t0) * 1e3, ms=(t2 - t0) * 1e3,
                peak_mb=_peak_mb(dev))


def grad_profile(scene, cam, icfg, width, height, weights, card):
    """One tape and one remat "full" gradient step under torch.profiler:
    device ms (the kernels' self time), the share of the wall time the
    card sat idle, index_add_'s device ms and calls, and the kernels that
    took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if scene.device.type != "cuda":
        log("grad profile: not measured (no card)")
        return
    for label, use_tape, fields in GRAD_MODES[:2]:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run = grad_run(scene, cam, replace(icfg, **fields), width,
                           height, weights, use_tape)
        events = prof.key_averages()
        # the program's spans (profiling.span) are mirrored on the card's
        # timeline around their kernels: ranges, not kernels
        kernels = sorted((e for e in events
                          if e.device_type == DeviceType.CUDA
                          and not e.key.startswith("pt.")),
                         key=lambda e: -e.self_device_time_total)
        device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        adds = [e for e in events if e.key == "aten::index_add_"]
        add_ms = sum(e.self_device_time_total for e in adds) / 1e3
        log(f"grad profile {label}: fwd+bwd {run['ms']:.1f} ms wall, "
            f"device {device_ms:.1f} ms, idle {1 - device_ms / run['ms']:.1%}"
            f", index_add_ {add_ms:.1f} ms in {sum(e.count for e in adds)} "
            f"calls ({add_ms / max(device_ms, 1e-9):.1%})"
            f"; top kernels: " + "; ".join(
                f"{e.key[:48]} {e.self_device_time_total / 1e3:.1f} ms x "
                f"{e.count}" for e in kernels[:5]) + f" [{card}]")


def _expect(what, counts, want):
    if _launched(counts) != want:
        raise AssertionError(f"{what}: launched {_launched(counts)}, "
                             f"expected {want}")


def sgd_phase(scene, cam, icfg, width, height, card):
    """SGD on the material color table, as shard.make_train_step does on
    one device (lr 0.5, colors clipped to [0, 1], the tape backward),
    toward a target rendered with the same key from the scene with its
    untextured materials' colors scaled by SGD_SCALE. Raises unless the
    last step's loss is below the first's. Returns the steps' launches
    and rays by wrapper."""
    from ptsharp_tpu_torch import diff
    from ptsharp_tpu_torch.core import rng
    from ptsharp_tpu_torch.kernels import traverse

    mats = scene.materials
    scaled = torch.where((mats.texture >= 0)[:, None], mats.color,
                         mats.color * SGD_SCALE)
    with torch.no_grad():
        target = diff.render_image(
            replace(scene, materials=mats._replace(color=scaled)), cam,
            icfg, rng.PRNGKey(1), width, height, 1)
    colors = mats.color.clone()
    losses, launches = [], {}
    for step in range(SGD_STEPS):
        c = colors.clone().requires_grad_()
        s = replace(scene, materials=mats._replace(color=c))
        traverse.reset_launch_counts()
        img = diff.render_image(s, cam, icfg, rng.PRNGKey(1), width, height,
                                1, use_tape=True)
        loss = torch.mean((img - target) ** 2)
        (g,) = torch.autograd.grad(loss, c)
        colors = torch.clamp(colors - SGD_LR * g, 0.0, 1.0)
        losses.append(float(loss.detach()))
        _add_counts(launches, _counts())
        log(f"grad sgd step {step + 1}/{SGD_STEPS}: loss={losses[-1]:.9e} "
            f"[{card}]")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"SGD did not lower the loss: {losses}")
    dist = [float((c - scaled).abs().max()) for c in (mats.color, colors)]
    log(f"grad sgd: losses {losses}; max |color - target color| "
        f"{dist[0]:.4f} -> {dist[1]:.4f}")
    return launches


def grad_reference(device):
    """A 32x24 bunny's tape gradients on the card against the same run on
    the CPU, where the wrappers run the plain versions."""
    from ptsharp_tpu_torch import examples
    from ptsharp_tpu_torch.kernels import traverse

    w, h = 32, 24
    grads = []
    for dev in (device, torch.device("cpu")):
        scene, cam, _rc, icfg = examples.bunny(
            w, h, subdivisions=3, intersector="pallas", wide_k=8, device=dev)
        weights = torch.from_numpy(np.random.default_rng(3).random(
            (h, w, 3)).astype(np.float32)).to(dev)
        grads.append(grad_run(scene, cam, icfg, w, h, weights, True,
                              seed=5)["grads"])
    traverse.reset_launch_counts()
    err = grads_close("bunny 32x24 tape gradients, card against CPU",
                      *grads)
    log(f"grad reference bunny {w}x{h}: tape gradients card = CPU, largest "
        f"error over max |g| {err:.3e}")


def grad_bench_shape(device, card, width=1920, height=1080, chunk=1 << 20,
                     chunks=8):
    """bench.py run_grad's shape through the port: cornell at 1920x1080,
    gradient of the mean radiance of a chunk of 1,048,576 pixels (in
    scanline order, wrapping) with respect to the material colors, by the
    tape and by autograd through trace_compacted_static; one warm-up
    chunk, then `chunks` timed ones; fwd+bwd Mrays/s counts the forward's
    rays. Cornell has no mesh: no kernel may launch."""
    from ptsharp_tpu_torch import examples
    from ptsharp_tpu_torch.core import rng
    from ptsharp_tpu_torch.integrator import trace_compacted_static
    from ptsharp_tpu_torch.kernels import traverse
    from ptsharp_tpu_torch.tape import trace_tape_radiance

    scene, cam, _rc, icfg = examples.build("cornell", device=device)
    n_pix = width * height
    for mode, tracer in (("tape", trace_tape_radiance),
                         ("AD compacted", trace_compacted_static)):
        def step(ci, key):
            start = (ci * chunk) % n_pix
            xs = (start + torch.arange(chunk, device=device)) % n_pix
            colors = scene.materials.color.clone().requires_grad_()
            s = replace(scene,
                        materials=scene.materials._replace(color=colors))
            kj, kt = rng.split(key)
            ju, jv = rng.uniform(kj, (2, chunk), device=device)
            org, dirn = cam.cast_rays(xs % width, xs // width, width, height,
                                      ju, jv)
            res = tracer(s, icfg, org, dirn, kt)
            (g,) = torch.autograd.grad(torch.mean(res.radiance), colors)
            return res.rays_traced, g

        step(0, rng.PRNGKey(99))
        _reset_peak(device)
        sync(device)
        traverse.reset_launch_counts()
        t0 = time.perf_counter()
        outs = [step(i, rng.PRNGKey(i)) for i in range(chunks)]
        total = sum(int(r) for r, _g in outs)
        sync(device)
        sec = time.perf_counter() - t0
        _expect(f"cornell fwd+bwd ({mode})", _counts(), {})
        if not all(bool(torch.isfinite(g).all()) for _r, g in outs):
            raise AssertionError(f"cornell fwd+bwd ({mode}): gradient is "
                                 f"not finite")
        log(f"grad bench shape cornell {width}x{height} {mode}: {chunks} x "
            f"{chunk} rays, rays_traced={total} seconds={sec:.3f} "
            f"fwd+bwd mrays_per_s={total / sec / 1e6:.3f} peak_mb="
            f"{_peak_mb(device)} [{card}]")


def grad_phase(scene, cam, icfg, width, height, card):
    """The gradient path on the main-path scene (the bunny, pallas ordered
    K=8) at width x height, 1 spp, through diff.render_image: forward
    only, then forward and backward by the tape and by autograd under
    remat "full", "hits" and off, GRAD_REPS runs each with its launches
    (each half's counts set to 0 just before and read just after), wall
    ms and peak memory. Every forward launches #1 and #2 once a depth
    and no table sum; the tape's backward launches no traversal, "full"
    re-launches both once a checkpointed depth (max_bounces), "hits" #2
    only, off nothing; the tape's backward launches the table sum 6 times
    a depth (its two material sums and four texel fetches), autograd's 4
    times a textured sample (the colour at every depth, the gloss at
    every depth but the last: 2 x depths - 1). The
    tape's and every autograd mode's gradients agree per leaf. Then the
    SGD steps, a small bunny's card gradients against the CPU's, and
    bench.py's fwd+bwd shape on cornell. Returns the phase's launches and
    rays by wrapper (the main-path runs and the SGD steps), with the
    table sum's launches and lanes in the main-path runs as
    "table_sum"."""
    from ptsharp_tpu_torch import diff
    from ptsharp_tpu_torch.core import rng
    from ptsharp_tpu_torch.kernels import traverse
    from ptsharp_tpu_torch.tape import DiffParams

    if scene.intersector != "pallas" or not scene.p_ordered:
        raise AssertionError("the grad phase runs the pallas ordered walk")
    dev = scene.device
    depths = icfg.max_bounces + 1
    fwd_want = {"closest_hit": depths, "any_hit": depths}
    tsum_ad = 4 * (2 * depths - 1)
    bwd_want = {"tape": {"table_sum": 6 * depths},
                "AD remat full": {"closest_hit": depths - 1,
                                  "any_hit": depths - 1,
                                  "table_sum": tsum_ad},
                "AD remat hits": {"any_hit": depths - 1,
                                  "table_sum": tsum_ad},
                "AD remat off": {"table_sum": tsum_ad}}
    n = width * height
    weights = torch.from_numpy(np.random.default_rng(7).random(
        (height, width, 3)).astype(np.float32) / n).to(dev)
    total = {}
    for rep in range(GRAD_REPS):
        _reset_peak(dev)
        sync(dev)
        traverse.reset_launch_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            img = diff.render_image(scene, cam, icfg, rng.PRNGKey(0), width,
                                    height, 1)
        sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        counts = _counts()
        _expect("forward only", counts, fwd_want)
        _add_counts(total, counts)
        if not bool(torch.isfinite(img).all()):
            raise AssertionError("forward image is not finite")
        log(f"grad bunny {width}x{height} forward only run {rep + 1}: "
            f"{ms:.1f} ms, peak_mb={_peak_mb(dev)}, launches "
            f"{_launched(counts)} [{card}]")
    ref = None
    for label, use_tape, fields in GRAD_MODES:
        cfg = replace(icfg, **fields)
        for rep in range(GRAD_REPS):
            run = grad_run(scene, cam, cfg, width, height, weights, use_tape)
            _expect(f"{label} forward", run["fwd"], fwd_want)
            _expect(f"{label} backward", run["bwd"], bwd_want[label])
            _add_counts(total, run["fwd"])
            _add_counts(total, run["bwd"])
            if ref is None:
                ref = run["grads"]
                err = 0.0
            else:
                err = grads_close(f"{label} against the tape", run["grads"],
                                  ref)
            log(f"grad bunny {width}x{height} {label} run {rep + 1}: fwd "
                f"{run['fwd_ms']:.1f} ms, fwd+bwd {run['ms']:.1f} ms, "
                f"peak_mb={run['peak_mb']}, launches fwd "
                f"{_launched(run['fwd'])} bwd {_launched(run['bwd'])}, "
                f"largest error against the tape over max |g| {err:.3e} "
                f"[{card}]")
    grad_profile(scene, cam, icfg, width, height, weights, card)
    log("grad bunny gradient magnitudes: " + ", ".join(
        f"{name} {float(g.abs().max()):.4e}"
        for name, g in zip(DiffParams._fields, ref)))
    tex = scene.materials.texture >= 0
    if not (float(ref[4].abs().max()) > 0
            and bool((ref[0][tex] == 0).all())):
        raise AssertionError("the textured material must pass its gradient "
                             "to the texels, not to its color row")
    _add_counts(total, sgd_phase(scene, cam, icfg, width, height, card))
    grad_reference(dev)
    grad_bench_shape(dev, card)
    return total


# ---- shard: parallel/ on torch.distributed ----------------------------------

SHARD_STEPS = 3
# runs of several ranks, each rank a process (chip_smoke.py --shard-rank):
# four gloo ranks that share cuda:0 over test_distributed's cube (the
# shard phase), and four NCCL ranks, one a card, over the bunny at its
# 1080p width (chip_smoke.py --shard-cards, on a four-card machine)
RANK_RUNS = {
    "gloo": dict(mesh=(2, 2), scene="cube", size=(256, 144, 2)),
    "nccl": dict(mesh=(2, 2), scene="bunny", size=(1920, 1080, 2)),
}
RANK_LR = 0.5
RANK_TIMEOUT = 300  # seconds the ranks may take, start-up included


def gloo_cube(device):
    """test_distributed.py's scene (a plane, a cube mesh and a sphere
    light), built "pallas" K=8, leaf 4, as __graft_entry__'s dry run
    builds it."""
    from ptsharp_tpu_torch.camera import Camera
    from ptsharp_tpu_torch.geometry.mesh import cube_mesh
    from ptsharp_tpu_torch.integrator import IntegratorConfig
    from ptsharp_tpu_torch.materials import diffuse_material, light_material
    from ptsharp_tpu_torch.scene import SceneBuilder

    b = SceneBuilder()
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.7, 0.7, 0.7]))
    b.add_mesh(cube_mesh([-0.5, 0, -0.5], [0.5, 1, 0.5]),
               diffuse_material([0.6, 0.3, 0.2]))
    b.add_sphere([2, 4, -2], 1.0, light_material([1, 1, 1], 8.0))
    scene = b.build(leaf_size=4, intersector="pallas", wide_k=8,
                    device=device)
    cam = Camera.look_at([0, 1.5, -4], [0, 0.5, 0], [0, 1, 0], 40.0,
                         device=device)
    return scene, cam, IntegratorConfig(max_bounces=2)


def rank_scene(name, device):
    """(scene, camera, config) of a RANK_RUNS scene."""
    from ptsharp_tpu_torch import examples

    if name == "cube":
        return gloo_cube(device)
    scene, cam, _rcfg, icfg = examples.build(name, intersector="pallas",
                                             wide_k=8, device=device)
    return scene, cam, icfg


def shard_rank(backend: str, port: int, rank: int, out: str) -> int:
    """One rank of a RANK_RUNS run (`chip_smoke.py --shard-rank <backend>
    <port> <rank> <out>`): gloo ranks share cuda:0, NCCL rank r takes
    cuda:r. The sharded render, the gradient and one make_train_step step
    toward black, with the render's and the step's launches, saved to
    <out>."""
    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    from ptsharp_tpu_torch.core import rng
    from ptsharp_tpu_torch.kernels import traverse
    from ptsharp_tpu_torch.parallel import distributed, shard

    run = RANK_RUNS[backend]
    dp, sp = run["mesh"]
    width, height, spp = run["size"]
    dev = torch.device("cuda", 0 if backend == "gloo" else rank)
    distributed.initialize(f"localhost:{port}", dp * sp, rank, device=dev,
                           backend=backend)
    try:
        mesh = distributed.global_mesh(dp, sp, device=dev)
        scene, cam, icfg = rank_scene(run["scene"], dev)
        sync(dev)
        traverse.reset_launch_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            img = shard.render_image_sharded(scene, cam, icfg,
                                             rng.PRNGKey(0), width, height,
                                             spp, mesh)
        sync(dev)
        render_ms = (time.perf_counter() - t0) * 1e3
        render_counts = _counts()
        target = torch.zeros_like(img)
        loss, g = shard.loss_and_grad(scene, cam, icfg, rng.PRNGKey(1),
                                      target, width, height, spp, mesh)
        step = shard.make_train_step(cam, icfg, width, height, spp, mesh,
                                     lr=RANK_LR)
        sync(dev)
        traverse.reset_launch_counts()
        t0 = time.perf_counter()
        new_scene, step_loss = step(scene, rng.PRNGKey(1), target)
        sync(dev)
        step_ms = (time.perf_counter() - t0) * 1e3
        torch.save({"summary": distributed.process_summary(dev),
                    "index": (mesh.dp_index, mesh.sp_index),
                    "img": img.cpu(), "loss": loss.cpu(), "grad": g.cpu(),
                    "step_loss": step_loss.cpu(),
                    "colors": new_scene.materials.color.cpu(),
                    "render_ms": render_ms, "step_ms": step_ms,
                    "render_launches": _launched(render_counts),
                    "step_launches": _launched(_counts())}, out)
    finally:
        distributed.shutdown()
    return 0


def ranks_phase(backend, device, card):
    """A RANK_RUNS run: each rank's image equal bit for bit to this
    process's emulation of the mesh on `device` (its render_shard calls,
    each row block's shares summed and divided by sp), the loss, gradient
    and new colors the same bits on every rank, the gradient equal to
    autograd over the emulated mesh's one graph, each rank's render and
    step launching #1 and #2 once a depth."""
    from ptsharp_tpu_torch.core import rng, vec
    from ptsharp_tpu_torch.parallel import distributed, shard

    run = RANK_RUNS[backend]
    dp, sp = run["mesh"]
    width, height, spp = run["size"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        port = distributed.free_port()
        distributed.run_ranks(
            [[sys.executable, os.path.abspath(__file__), "--shard-rank",
              backend, str(port), str(r), f"{out}/rank{r}.pt"]
             for r in range(dp * sp)], RANK_TIMEOUT, cwd=REPO)
        ranks = [torch.load(f"{out}/rank{r}.pt") for r in range(dp * sp)]
    sec = time.perf_counter() - t0
    scene, cam, icfg = rank_scene(run["scene"], device)
    depths = icfg.max_bounces + 1
    want_launches = {"closest_hit": depths, "any_hit": depths}
    colors = scene.materials.color.clone().requires_grad_()
    s = replace(scene, materials=scene.materials._replace(color=colors))

    def emulate(key, use_tape):
        blocks = []
        for i in range(dp):
            parts = [shard.render_shard(s, cam, icfg, key, width, height,
                                        spp, dp, sp, i, j, use_tape=use_tape)
                     for j in range(sp)]
            blocks.append(vec.div(sum(parts[1:], parts[0]), sp))
        return torch.cat(blocks)

    with torch.no_grad():
        want = emulate(rng.PRNGKey(0), False).cpu()
    img = emulate(rng.PRNGKey(1), True)
    (g,) = torch.autograd.grad(
        vec.div(torch.sum(img ** 2), img.numel()), colors)
    del img
    label = (f"shard {backend} {dp * sp} ranks, mesh dp={dp} sp={sp}, "
             f"{run['scene']} {width}x{height} spp={spp}")
    for rank, res in enumerate(ranks):
        if res["index"] != divmod(rank, sp):
            raise AssertionError(f"{label}: rank {rank} sits at "
                                 f"{res['index']}")
        if res["summary"]["process_count"] != dp * sp or \
                res["summary"]["platform"] != "gpu":
            raise AssertionError(f"{label}: rank {rank}: {res['summary']}")
        for what in ("render_launches", "step_launches"):
            if res[what] != want_launches:
                raise AssertionError(f"{label}: rank {rank}'s {what} "
                                     f"{res[what]}, expected "
                                     f"{want_launches}")
        _equal(f"{label}: rank {rank}'s image against the emulated mesh",
               (res["img"],), (want,))
        for key in ("loss", "grad", "step_loss", "colors"):
            if not torch.equal(res[key], ranks[0][key]):
                raise AssertionError(f"{label}: rank {rank}'s {key} "
                                     f"differs from rank 0's")
    err = grads_close(f"{label}: gradient against autograd over the "
                      f"emulated mesh", [ranks[0]["grad"]], [g])
    log(f"{label}: images = emulation bit for bit, loss "
        f"{float(ranks[0]['loss']):.9e}, gradient and colors equal on "
        f"every rank, gradient against the emulated autograd: largest "
        f"error over max |g| {err:.3e}; render ms by rank "
        f"{[round(r['render_ms'], 1) for r in ranks]}, step ms "
        f"{[round(r['step_ms'], 1) for r in ranks]}, launches a rank "
        f"render {ranks[0]['render_launches']} step "
        f"{ranks[0]['step_launches']}; {sec:.1f} s with start-up; "
        f"{ranks[0]['summary']} [{card}]")


def shard_cards() -> int:
    """`chip_smoke.py --shard-cards`, on a machine with four cards: the
    NCCL run of RANK_RUNS, one rank a card, against the emulated mesh on
    cuda:0; then entry.dryrun_multichip(4)."""
    if torch.cuda.device_count() < 4:
        print("chip_smoke --shard-cards: needs four cards", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from ptsharp_tpu_torch.kernels import build
    from ptsharp_tpu_torch.parallel import entry

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = "; ".join(smi.stdout.strip().splitlines())
    log(card)
    t0 = time.perf_counter()
    build.load()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    ranks_phase("nccl", torch.device("cuda", 0), card)
    t0 = time.perf_counter()
    entry.dryrun_multichip(4)
    log(f"shard dryrun_multichip(4) over NCCL, one rank a card: "
        f"{time.perf_counter() - t0:.1f} s with start-up")
    return 0


def shard_phase(scene, cam, icfg, width, height, card):
    """parallel/ on the card: a world-1 NCCL group on cuda:0 over the
    bunny of 3 at width x height, 1 spp: render_image_sharded bit-equal to
    render_shard(0, 0), finite and positive, launching #1 and #2 once a
    depth; SHARD_STEPS make_train_step steps (tape, SGD_LR) toward a
    target rendered from scaled colors, each with wall ms, peak MB and the
    launches of each half (the tape's backward launches nothing), the last
    loss below the first, step 1's gradient equal to autograd through
    trace of the same shard's loss; the group destroyed; then four gloo
    ranks on the card (ranks_phase) and dryrun_multichip(1) over NCCL in
    a process of its own. Returns the phase's launches and rays by wrapper
    (the render and the steps)."""
    import torch.distributed as dist

    from ptsharp_tpu_torch.core import rng, vec
    from ptsharp_tpu_torch.kernels import traverse
    from ptsharp_tpu_torch.parallel import distributed, entry, shard

    dev = scene.device
    depths = icfg.max_bounces + 1
    fwd_want = {"closest_hit": depths, "any_hit": depths}
    total = {}
    distributed.initialize(f"localhost:{distributed.free_port()}", 1, 0,
                           device="cuda:0")
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"backend {dist.get_backend()}, not nccl")
        mesh = distributed.global_mesh(1, 1)
        log(f"shard process_summary {distributed.process_summary()} mesh "
            f"{mesh.shape} on {mesh.device}")
        _reset_peak(dev)
        sync(dev)
        traverse.reset_launch_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            img = shard.render_image_sharded(scene, cam, icfg, rng.PRNGKey(0),
                                             width, height, 1, mesh)
        sync(dev)
        sec = time.perf_counter() - t0
        counts = _counts()
        _expect("shard render", counts, fwd_want)
        _add_counts(total, counts)
        with torch.no_grad():
            ref = shard.render_shard(scene, cam, icfg, rng.PRNGKey(0), width,
                                     height, 1, 1, 1, 0, 0)
        _equal("render_image_sharded against render_shard(0, 0)", (img,),
               (ref,))
        if not (bool(torch.isfinite(img).all()) and float(img.min()) >= 0
                and float(img.mean()) > 0):
            raise AssertionError("the sharded image is not finite and "
                                 "positive")
        rays = counts["closest_hit"][1]
        log(f"shard render bunny {width}x{height} spp=1 NCCL world 1: "
            f"seconds={sec:.3f} closest-hit rays={rays} mrays_per_s="
            f"{rays / sec / 1e6:.3f} mean={float(img.mean()):.6f} peak_mb="
            f"{_peak_mb(dev)} launches {_launched(counts)} [{card}]")

        mats = scene.materials
        scaled = torch.where((mats.texture >= 0)[:, None], mats.color,
                             mats.color * SGD_SCALE)
        with torch.no_grad():
            target = shard.render_image_sharded(
                replace(scene, materials=mats._replace(color=scaled)), cam,
                icfg, rng.PRNGKey(1), width, height, 1, mesh)
        step = shard.make_train_step(cam, icfg, width, height, 1, mesh,
                                     lr=SGD_LR)
        # the step's backward starts at its torch.autograd.grad: split the
        # launch counts and the clock there, and keep the gradient (the
        # tape's backward calls torch.autograd.grad again inside it)
        grad = torch.autograd.grad
        halves = {}

        def split_grad(*args, **kwargs):
            if "fwd" in halves:
                return grad(*args, **kwargs)
            sync(dev)
            halves["fwd"] = _counts()
            halves["t_fwd"] = time.perf_counter()
            traverse.reset_launch_counts()
            halves["grad"] = grad(*args, **kwargs)
            return halves["grad"]

        losses = []
        s = scene
        for i in range(SHARD_STEPS):
            halves.clear()
            _reset_peak(dev)
            sync(dev)
            traverse.reset_launch_counts()
            t0 = time.perf_counter()
            torch.autograd.grad = split_grad
            try:
                s, loss = step(s, rng.PRNGKey(1), target)
            finally:
                torch.autograd.grad = grad
            sync(dev)
            ms = (time.perf_counter() - t0) * 1e3
            bwd = _counts()
            _expect(f"shard step {i + 1} forward", halves["fwd"], fwd_want)
            _expect(f"shard step {i + 1} backward (tape)", bwd, {})
            _add_counts(total, halves["fwd"])
            losses.append(float(loss))
            if i == 0:
                g1 = halves["grad"][0]
            log(f"shard step {i + 1}/{SHARD_STEPS} bunny {width}x{height}: "
                f"loss={losses[-1]:.9e} wall {ms:.1f} ms (forward "
                f"{(halves['t_fwd'] - t0) * 1e3:.1f} ms), peak_mb="
                f"{_peak_mb(dev)}, launches forward "
                f"{_launched(halves['fwd'])} backward {_launched(bwd)} "
                f"[{card}]")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"the sharded steps did not lower the loss: "
                                 f"{losses}")
        # step 1's gradient against autograd through trace of the same
        # shard's loss, without the mesh
        colors = mats.color.clone().requires_grad_()
        part = shard.render_shard(
            replace(scene, materials=mats._replace(color=colors)), cam, icfg,
            rng.PRNGKey(1), width, height, 1, 1, 1, 0, 0)
        (g_ad,) = torch.autograd.grad(
            vec.div(torch.sum((part - target) ** 2), part.numel()), colors)
        traverse.reset_launch_counts()
        err = grads_close("shard step 1's gradient against autograd of the "
                          "unsharded shard", [g1], [g_ad])
        log(f"shard steps: losses {losses}; step 1's gradient = unsharded "
            f"autograd, largest error over max |g| {err:.3e}")
    finally:
        distributed.shutdown()
    if dist.is_initialized():
        raise AssertionError("the shard phase's process group is still up")
    ranks_phase("gloo", dev, card)
    t0 = time.perf_counter()
    entry.dryrun_multichip(1)
    log(f"shard dryrun_multichip(1) over NCCL in its own process: "
        f"{time.perf_counter() - t0:.1f} s with start-up")
    return total


def _draw(kind, key, shape, device):
    from ptsharp_tpu_torch.core import rng

    if kind == "uniform":
        return rng.uniform(key, shape, device=device)
    return rng.randint(key, shape, 0, 1, device=device)


def _plain_draw(kind, key, shape, device):
    """The same draw through the torch block on the card (the kernel's
    plain version)."""
    from ptsharp_tpu_torch.core import rng

    on_card = rng._on_card
    rng._on_card = lambda dev: False
    try:
        return _draw(kind, key, shape, device)
    finally:
        rng._on_card = on_card


def _syncs(fn) -> int:
    """Host-device syncs fn makes, by torch's sync debug mode."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum(str(w.message).startswith("called a synchronizing")
               for w in caught)


def rng_phase(device) -> dict:
    """Phase 2b: the threefry kernels at the main path's shapes against
    their plain path, timed beside it and their bound; syncs a draw."""
    from ptsharp_tpu_torch.core import rng
    from ptsharp_tpu_torch.kernels import threefry

    key = rng.fold_in(rng.PRNGKey(2024), 22)
    rows = []
    for kind, shape in RNG_DRAWS:
        got = _draw(kind, key, shape, device)
        want = _plain_draw(kind, key, shape, device)
        sync(device)
        bits = (lambda x: x.view(torch.int32)) if kind == "uniform" \
            else (lambda x: x)
        _equal(f"rng {kind} {shape}", (bits(got),), (bits(want),))
        threefry.reset_launch_counts()
        ms = time_ms(lambda: _draw(kind, key, shape, device), device)
        launches = sum(w.launches for w in threefry.WRAPPERS)
        if launches != 6:  # a warm-up and 5 timed calls, one launch each
            raise AssertionError(f"rng {kind}: {launches} launches for 6 "
                                 f"draws")
        dms = device_ms(lambda: _draw(kind, key, shape, device))
        plain_ms = time_ms(lambda: _plain_draw(kind, key, shape, device),
                           device)
        n = math.prod(shape)
        ops, nbytes = n * OPS_WORD[kind], n * WORD_BYTES[kind]
        t_ops, t_bytes = ops / PEAK_INT32, nbytes / PEAK_BYTES
        row = dict(kind=kind, shape=list(shape), ms=ms, device_ms=dms,
                   plain_ms=plain_ms, bound_ms=1e3 * max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   ops=ops, bytes=nbytes)
        row["share"] = row["bound_ms"] / dms
        rows.append(row)
        log(f"rng {kind} {shape}: card {ms:.4f} ms, device {dms:.4f} ms, "
            f"plain {plain_ms:.3f} ms, {bound_text(row)}, share of bound "
            f"{100 * row['share']:.1f}%")
    cpu_key = rng.PRNGKey(5)
    syncs = dict(kernel=_syncs(lambda: rng.uniform(cpu_key, (4099,),
                                                   device=device)),
                 key_copy=_syncs(lambda: cpu_key.to(device)))
    log(f"rng syncs: a kernel draw {syncs['kernel']}, a CPU key copied to "
        f"the card {syncs['key_copy']}")
    if syncs["kernel"] or not syncs["key_copy"]:
        raise AssertionError(f"rng syncs {syncs}: a draw must make none, "
                             f"the key copy one")
    return {"rng": rows, "syncs": syncs}


def march_phase(device) -> dict:
    """Phase 2c: the sphere-trace kernel at sdf_csg's main path against
    the lockstep march on the card, timed beside it and its bound."""
    from torch.profiler import ProfilerActivity, profile

    from perfbench import march_ops
    from ptsharp_tpu_torch import examples, intersect, profiling
    from ptsharp_tpu_torch.geometry import primitives
    from ptsharp_tpu_torch.geometry import sdf as sdf_mod
    from ptsharp_tpu_torch.kernels import build, sdf_march

    with open(os.path.join(REPO, "perfbench", "configs",
                           "sdf_csg.json")) as f:
        step_ops = march_ops.lane_step_ops(json.load(f)["scene"]["sdf"]["tree"])
    width, height = 1920, 1080
    scene, cam, _rc, _ic = examples.build("sdf", width=width, height=height,
                                          device=device)
    tree, _mid, lo, hi = scene.sdf_objects[0]
    org, dirn = camera_rays(scene, cam, width, height, width * height)
    te, tx = primitives.box_entry_exit(org, dirn,
                                       *intersect._box(lo, hi, device))
    route = sdf_mod._kernel_program

    def fused(tag=None):
        return sdf_mod.sphere_trace(tree, org, dirn, te, tx, tag=tag)

    def plain(tag=None):
        sdf_mod._kernel_program = lambda *a: None
        try:
            return fused(tag)
        finally:
            sdf_mod._kernel_program = route

    counted = []
    for run in (fused, plain):
        profiling.reset_counters()
        with profile(activities=[ProfilerActivity.CPU]):
            counted.append((run("closest"),
                            profiling.march_counters()["closest"]))
        profiling.reset_counters()
    (got, c), (want, cp) = counted
    sync(device)
    _equal("sdf march hit t", (got,), (want,))
    if c["active"] != cp["active"]:
        raise AssertionError(f"sdf march: {c['active']} active lane steps, "
                             f"the lockstep march {cp['active']}")
    sdf_march.reset_launch_counts()
    ms = time_ms(fused, device)
    if sdf_march.march.launches != 6:  # a warm-up and 5 timed, one each
        raise AssertionError(f"sdf march: {sdf_march.march.launches} "
                             f"launches for 6 marches")
    plain_ms = time_ms(plain, device, reps=PLAIN_REPS)
    rays = width * height
    entering = int((tx >= torch.clamp(te, min=0.0)).sum())
    ops = c["active"] * step_ops
    nbytes = rays * MARCH_RAY_BYTES + entering * MARCH_ENTER_BYTES
    t_ops, t_bytes = ops / PEAK_F32, nbytes / PEAK_BYTES
    row = dict(rays=rays, entering=entering, hits=int((got < 1e8).sum()),
               ms=ms,
               plain_ms=plain_ms, bound_ms=1e3 * max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               ops=ops, bytes=nbytes, ops_lane_step=step_ops,
               active=c["active"], carried=c["carried"],
               most_steps=c["steps"], plain_steps=cp["steps"],
               plain_checks=cp["checks"])
    row["share"] = row["bound_ms"] / ms
    regs = {k: v for k, v in ptxas_report(
        build.build_info.get("ptxas", "")).items()
        if k.startswith("sdf_march")}
    row["ptxas"] = regs
    log(f"sdf march {width}x{height} camera rays: card {ms:.3f} ms, plain "
        f"{plain_ms:.1f} ms, {bound_text(row)}, share of bound "
        f"{100 * row['share']:.2f}%; {entering} rays enter the box, hits "
        f"{row['hits']}; active lane steps "
        f"{c['active']} of {c['carried']} lane slots "
        f"({100 * c['active'] / max(c['carried'], 1):.1f}%), most steps "
        f"{c['steps']} (lockstep: {cp['steps']} steps, {cp['checks']} "
        f"checks); ptxas {regs}")
    return row


# each table-sum entry against its float64 sum, over the sum of its rows'
# absolute values: float32 round-off in an order that changes from run to
# run (tests/test_torch_table_sum.py's tolerance)
TSUM_RTOL = 1e-4


def tsum_phase(device) -> dict:
    """Phase 2d: the table-sum kernel on the sums of one tape gradient at
    the bunny.train cell's shapes, against their float64 sums (raises
    past TSUM_RTOL of the rows' absolute sum), timed by kind beside
    index_add_ on the same inputs and beside the byte bound."""
    from torch.profiler import ProfilerActivity, profile

    from ptsharp_tpu_torch import diff, examples, profiling, tape, textures
    from ptsharp_tpu_torch.core import rng
    from ptsharp_tpu_torch.kernels import build, table_sum

    scene, cam, rcfg, icfg = examples.build("bunny", intersector="pallas",
                                            wide_k=8, device=device)
    width, height = rcfg.width, rcfg.height
    calls = []
    kernel = table_sum.table_sum

    def captured(ids, rows, m):
        calls.append((ids.clone(), rows.clone(), m))
        return kernel(ids, rows, m)

    colors = scene.materials.color.clone().requires_grad_()
    s = replace(scene, materials=scene.materials._replace(color=colors))
    # the two call sites reach the kernel through their module's name
    sites = (tape, textures)
    for site in sites:
        site.table_sum = types.SimpleNamespace(table_sum=captured)
    try:
        img = diff.render_image(s, cam, icfg, rng.PRNGKey(3), width, height,
                                1, use_tape=True)
        torch.autograd.grad(torch.mean((img - 0.5) ** 2), colors)
    finally:
        for site in sites:
            site.table_sum = table_sum
    sync(device)
    if len(calls) != 6 * (icfg.max_bounces + 1):
        raise AssertionError(f"table sum: {len(calls)} sums in a tape "
                             f"gradient, expected 6 a depth")
    kinds = {(5, 3): "mid", (4, 3): "lm"}
    rows_out = {}
    for ids, rows, m in calls:
        kind = kinds.get((rows.shape[1], m), "texels")
        got = kernel(ids, rows, m)
        i = ids.clamp(0, m - 1).long()
        want = torch.zeros((m, rows.shape[1]), dtype=torch.float64,
                           device=device).index_add_(0, i, rows.double())
        mass = torch.zeros_like(want).index_add_(0, i, rows.double().abs())
        err = float(((got.double() - want).abs()
                     / mass.clamp_min(1e-30)).max())
        profiling.reset_counters()
        with profile(activities=[ProfilerActivity.CPU]):
            kernel(ids, rows, m)
        c = profiling.table_sum_counters()
        profiling.reset_counters()
        ms = device_ms(lambda: kernel(ids, rows, m))
        add_ms = device_ms(lambda: torch.zeros(
            (m, rows.shape[1]), device=device).index_add_(0, ids, rows))
        nbytes = ids.shape[0] * (ids.element_size() + 4 * rows.shape[1]) \
            + m * rows.shape[1] * 4
        row = rows_out.setdefault(kind, dict(
            calls=0, lanes=0, active=0, adds=0, ms=0.0, index_add_ms=0.0,
            bytes=0, max_rel_err=0.0, m=m, width=rows.shape[1]))
        for k, v in (("calls", 1), ("lanes", c["lanes"]),
                     ("active", c["active"]), ("adds", c["adds"]),
                     ("ms", ms), ("index_add_ms", add_ms),
                     ("bytes", nbytes)):
            row[k] += v
        row["max_rel_err"] = max(row["max_rel_err"], err)
        if not err <= TSUM_RTOL:
            raise AssertionError(f"table sum {kind} ({m} x {rows.shape[1]}, "
                                 f"{ids.shape[0]} lanes): error {err:.3e} "
                                 f"of the rows' absolute sum, past "
                                 f"{TSUM_RTOL}")
    total = dict(calls=0, ms=0.0, index_add_ms=0.0, bytes=0, lanes=0,
                 active=0, adds=0)
    for kind, row in sorted(rows_out.items()):
        row["bound_ms"] = 1e3 * row["bytes"] / PEAK_BYTES
        row["share"] = row["bound_ms"] / row["ms"]
        for k in total:
            total[k] += row[k]
        log(f"table sum {kind} ({row['m']} x {row['width']}): "
            f"{row['calls']} sums of {row['lanes'] // row['calls']} lanes, "
            f"{100 * row['active'] / max(row['lanes'], 1):.1f}% active, "
            f"{row['adds']} adds; card {row['ms']:.3f} ms, index_add_ "
            f"{row['index_add_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
            f"(bytes), share {100 * row['share']:.1f}%; largest error "
            f"{row['max_rel_err']:.2e} of the rows' absolute sum")
    total["bound_ms"] = 1e3 * total["bytes"] / PEAK_BYTES
    total["share"] = total["bound_ms"] / total["ms"]
    total["max_rel_err"] = max(row["max_rel_err"]
                               for row in rows_out.values())
    regs = {k: v for k, v in ptxas_report(
        build.build_info.get("ptxas", "")).items()
        if k.startswith("table_sum")}
    log(f"table sum, a tape gradient: card {total['ms']:.3f} ms, index_add_ "
        f"{total['index_add_ms']:.3f} ms, bound {total['bound_ms']:.4f} ms, "
        f"share {100 * total['share']:.1f}%, adds a lane "
        f"{total['adds'] / max(total['lanes'], 1):.4f}; ptxas {regs}")
    return dict(kinds=rows_out, total=total, ptxas=regs)


def scene_line(name, scene, seconds):
    if scene.intersector != "pallas":
        # leaf slots holding a triangle (padding slots are all zero)
        n_tri = int((scene.leaf_rows.reshape(-1, 9).abs().sum(1) > 0).sum())
        log(f"{name} scene ({scene.intersector}): {n_tri} triangles, "
            f"bvh_builder={scene.bvh_builder}, u_rows "
            f"{tuple(scene.u_rows.shape)}, w_rows "
            f"{tuple(scene.w_rows.shape)}, leaf_rows "
            f"{tuple(scene.leaf_rows.shape)}, clusters "
            f"{scene.cluster_bmin.shape[0]}, TLAS head {scene.tlas_end} "
            f"rows (wide {scene.w_tlas_end}), use_tlas={scene.use_tlas}, "
            f"instances {scene.inst_inv.shape[0]}, build {seconds:.1f} s")
        return n_tri
    if not scene.p_flat:
        # one table of each mesh: count its leaf slots holding a triangle
        fat = scene.p_fat
        leaf = fat[1::2][(fat[0::2].view(torch.int32)[:, 7] & 0xFF) > 0]
        n_tri = int((leaf[:, :scene.max_leaf * 9].reshape(-1, 9).abs()
                     .sum(1) > 0).sum())
        log(f"{name} scene (pallas, per instance): {n_tri} triangles in "
            f"its mesh table for {scene.inst_inv.shape[0]} instances, "
            f"bvh_builder={scene.bvh_builder}, fat="
            f"{fat.numel() * 4 / 2**20:.2f} MB ({fat.shape[0] // 2} nodes), "
            f"node ranges {sorted(set(zip(scene.p_inst_base, scene.p_inst_end)))}, "
            f"max_stack_bound={scene.p_stack_bound}, build {seconds:.1f} s")
        return n_tri
    n_tri = int((scene.p_slot_tri >= 0).sum())
    log(f"{name} scene: {n_tri} triangles, bvh_builder={scene.bvh_builder}, "
        f"fat={scene.p_fat.numel() * 4 / 2**20:.2f} MB "
        f"({scene.p_fat.shape[0] // 2} nodes), "
        f"max_stack_bound={scene.p_stack_bound}, build {seconds:.1f} s")
    return n_tri


# ---- main -----------------------------------------------------------------


def main(only: str | None = None) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from ptsharp_tpu_torch import examples
    from ptsharp_tpu_torch.accel.tables import check_child_boxes
    from ptsharp_tpu_torch.integrator import compaction_schedule
    from ptsharp_tpu_torch.kernels import build
    from ptsharp_tpu_torch.scene import check_stack_bound

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    build.load()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"({build.build_info['library']})")
    for kname, row in sorted(ptxas_report(build.build_info.get(
            "ptxas", "")).items()):
        log(f"  ptxas {kname}: {row.get('registers')} registers, stack "
            f"frame {row.get('stack')} B, spill stores "
            f"{row.get('spill_stores')} B, spill loads "
            f"{row.get('spill_loads')} B, static smem {row['smem']} B")
    log("  dynamic smem a launch: " + ", ".join(
        f"{name} {dynamic_smem(name)} B" for name in STAGED))
    if only == "march":
        print(json.dumps({"march": march_phase(device)}))
        return 0
    if only == "tsum":
        print(json.dumps({"tsum": tsum_phase(device)}))
        return 0
    rng_res = rng_phase(device)
    if only == "rng":
        print(json.dumps(rng_res))
        return 0
    march_res = march_phase(device)
    tsum_res = tsum_phase(device)

    # bunny: the four kernels at two widths
    t0 = time.perf_counter()
    scene, cam, rcfg, icfg = examples.build("bunny", intersector="pallas",
                                            wide_k=8, device=device)
    if scene_line("bunny", scene, time.perf_counter() - t0) != 81920:
        raise AssertionError("the bunny must have 81,920 triangles")
    phases = [kernel_phase(
        scene, phase_rays(scene, cam, rcfg.width, rcfg.height, 1 << 16,
                          1 << 16), "bunny 2^16 camera + 2^16 bounce")]
    n_main = rcfg.width * rcfg.height
    main_rays = phase_rays(scene, cam, rcfg.width, rcfg.height, n_main,
                           n_main)
    main_label = f"bunny 1080p main path: {n_main} camera + {n_main} bounce"
    main_width = kernel_phase(scene, main_rays, main_label)
    phases.append(main_width)
    for walk in WALKS:
        walk_stats(scene, main_rays, main_label, walk)
    split, split_launches = split_phase(scene, main_rays, main_label)
    main_width.update(split)
    staged, staged_launches = staged_phase(scene, main_rays, main_label)
    main_width.update(staged)
    # the XLA walks' tables of the same bunny: leaf 8, K=4
    t0 = time.perf_counter()
    wscene, wcam, _wrc, wicfg = examples.build("bunny", intersector="walk",
                                               device=device)
    if scene_line("bunny", wscene, time.perf_counter() - t0) != 81920:
        raise AssertionError("the walk bunny must have 81,920 triangles")
    rows, _rows_launches = rows_phase(wscene, main_rays, main_label)
    main_width.update(rows)
    t0 = time.perf_counter()
    cluster_bunny = examples.build("bunny", intersector="cluster",
                                   device=device)
    scene_line("bunny", cluster_bunny[0], time.perf_counter() - t0)
    for name in ("u_rows", "w_rows", "leaf_rows"):
        if not torch.equal(getattr(wscene, name),
                           getattr(cluster_bunny[0], name)):
            raise AssertionError(f"the walk and cluster builds' {name} "
                                 f"differ")
    cluster_chunk_phase(cluster_bunny[0], main_rays, main_label)
    scalar_rows_phase(leaf6_bunny(device), main_rays, main_label)
    del main_rays
    stack_phase(device)

    # the TLAS walk at the main width: toybrick (36 brick instances), its
    # binary rows (a "walk" build's tables are the same, intersector aside),
    # and cube_field (145 analytic primitives)
    t0 = time.perf_counter()
    tb = examples.build("toybrick", width=1920, height=1080, device=device)
    scene_line("toybrick", tb[0], time.perf_counter() - t0)
    n_tb = 1920 * 1080
    tb_rays = tlas_rays(tb[0], tb[1], 1920, 1080, n_tb, n_tb)
    tb_label = f"toybrick 1080p: {n_tb} camera + {n_tb} bounce"
    tlas_main, _tlas_launches = tlas_phase(tb[0], tb_rays, tb_label)
    main_width.update(tlas_main)
    phases.append(tlas_main)
    phases.append(tlas_phase(replace(tb[0], intersector="walk"), tb_rays,
                             f"{tb_label}, binary rows")[0])
    del tb_rays
    t0 = time.perf_counter()
    cf = examples.build("cube_field", width=1920, height=1080, device=device)
    scene_line("cube_field", cf[0], time.perf_counter() - t0)
    if not (tb[0].use_tlas and cf[0].use_tlas):
        raise AssertionError("toybrick and cube_field must build the TLAS")
    cf_rays = tlas_rays(cf[0], cf[1], 1920, 1080, n_tb, n_tb)
    phases.append(tlas_phase(cf[0], cf_rays, f"cube_field 1080p: {n_tb} "
                             f"camera + {n_tb} bounce")[0])
    del cf_rays
    tlas_instance_phase(device, f"{TLAS_INSTANCE_RAYS} camera + "
                        f"{TLAS_INSTANCE_RAYS} bounce")

    # dragon_hd: built once, in the preorder walk this slice brings; the
    # ordered walk runs the same tables (its stack bound is checked)
    t0 = time.perf_counter()
    dscene, dcam, drcfg, dicfg = examples.build(
        "dragon_hd", intersector="pallas", wide_k=8, pallas_ordered=False,
        device=device)
    if scene_line("dragon_hd", dscene, time.perf_counter() - t0) \
            != DRAGON_TRIANGLES:
        raise AssertionError("dragon_hd must have 1,310,720 triangles")
    check_stack_bound(dscene.p_stack_bound)
    check_child_boxes(dscene.p_fat[0::2].cpu().numpy(), dscene.wide_k)
    n_dragon = drcfg.width * drcfg.height
    drays = phase_rays(dscene, dcam, drcfg.width, drcfg.height, n_dragon,
                       n_dragon)
    dlabel = f"dragon_hd 960x540: {n_dragon} camera + {n_dragon} bounce"
    phases.append(kernel_phase(dscene, drays, dlabel))
    for walk in WALKS:
        walk_stats(dscene, drays, dlabel, walk)
    bench_shape_phase(dscene, dcam, "dragon_hd")
    dstaged, dstaged_launches = staged_phase(dscene, drays, dlabel)
    phases.append(dstaged)
    dsplit, dsplit_launches = split_phase(dscene, drays, dlabel)
    phases.append(dsplit)
    # one "cluster" build serves the rows phase (its row tables are a
    # "walk" build's) and the cluster chunk
    t0 = time.perf_counter()
    dwscene = examples.build("dragon_hd", intersector="cluster",
                             device=device)[0]
    if scene_line("dragon_hd", dwscene, time.perf_counter() - t0) \
            != DRAGON_TRIANGLES:
        raise AssertionError("dragon_hd must have 1,310,720 triangles")
    drows, _drows_launches = rows_phase(dwscene, drays, dlabel)
    phases.append(drows)
    cluster_chunk_phase(dwscene, drays, dlabel)
    del drays, dwscene

    # four instances of dragon_hd's mesh: past FLAT_TRI_CAP, a "pallas"
    # build keeps one table of the one mesh and walks it per instance; a
    # "wide" build walks the TLAS, which re-enters the mesh's BLAS
    t0 = time.perf_counter()
    dmesh = examples.dragon_mesh()
    log(f"dragon_hd mesh: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    d4 = four_dragons(dmesh, device, intersector="pallas", leaf_size=14,
                      wide_k=8)
    if scene_line("four dragons", d4[0], time.perf_counter() - t0) \
            != DRAGON_TRIANGLES:
        raise AssertionError("the four dragons' table must hold one mesh")
    spans = set(zip(d4[0].p_inst_base, d4[0].p_inst_end))
    if d4[0].p_flat or len(spans) != 1 or d4[0].p_fat.shape[0] != 2 * (
            d4[0].p_inst_end[0] - d4[0].p_inst_base[0]):
        raise AssertionError("four dragons: not one per-instance table of "
                             "the one mesh")
    n4 = 960 * 540
    d4rays = tlas_rays(d4[0], d4[1], 960, 540, n4, n4)
    d4label = f"four dragons 960x540: {n4} camera + {n4} bounce"
    inst, _inst_launches = instance_phase(d4[0], d4rays, d4label)
    phases.append(inst)
    t0 = time.perf_counter()
    d4w = four_dragons(dmesh, device)
    scene_line("four dragons", d4w[0], time.perf_counter() - t0)
    if not d4w[0].use_tlas:
        raise AssertionError("four dragons (wide) must build the TLAS")
    phases.append(tlas_phase(d4w[0], d4rays, d4label)[0])
    del d4rays, dmesh

    # the main path, each render with its own launch counts
    rcfg1 = replace(rcfg, spp=1)
    if not compaction_schedule(icfg, min(n_main, rcfg1.max_rays_per_chunk)):
        raise AssertionError("the bunny render would not compact")
    pscene, pcam, _prc, picfg = examples.build(
        "bunny", intersector="pallas", wide_k=8, pallas_ordered=False,
        device=device)
    drcfg1 = replace(drcfg, spp=1)
    runs = [
        render_main("bunny", scene, cam, rcfg1, icfg, card),
        render_main("bunny", pscene, pcam, rcfg1, picfg, card),
        render_main("dragon_hd", dscene, dcam, drcfg1, dicfg, card),
        render_main("dragon_hd", replace(dscene, p_ordered=True), dcam,
                    drcfg1, dicfg, card),
    ]
    del pscene, dscene
    # the TLAS and the per-instance path
    for name, (xs, xc, xrc, xic) in (("toybrick", tb), ("cube_field", cf)):
        runs.append(render_main(name, xs, xc, replace(xrc, spp=1), xic,
                                card))
    for xs in (d4[0], replace(d4[0], p_ordered=False), d4w[0]):
        runs.append(render_main("four dragons", xs, d4[1], d4[2], d4[3],
                                card))
    del tb, cf, d4, d4w
    # the XLA intersectors: "wide" is examples.bunny()'s default build
    xla = {"wide": examples.bunny(device=device),
           "walk": (wscene, wcam, _wrc, wicfg),
           "cluster": cluster_bunny}
    if xla["wide"][0].intersector != "wide":
        raise AssertionError("examples.bunny() must build the wide walk")
    wide_bunny = xla["wide"]
    for name in XLA_INTERSECTORS:
        xs, xc, xrc, xic = xla.pop(name)
        runs.append(render_main("bunny", xs, xc, replace(xrc, spp=1), xic,
                                card))
    del wscene, cluster_bunny
    runs += modes_phase(((scene, cam, rcfg, icfg), wide_bunny), rcfg1,
                        device, card)
    del wide_bunny
    runs += geometry_phase(device, card)
    runs += catalog_phase(device, card)
    cs, cc, crc, cic = examples.build("cornell", device=device)
    film, rays, sec = render(cs, cc, crc, cic)
    log(f"render cornell {crc.width}x{crc.height} spp={crc.spp} "
        f"rays_traced={rays} seconds={sec:.3f} "
        f"mrays_per_s={rays / sec / 1e6:.3f} "
        f"film_mean={float(film.mean.mean()):.6f}")
    reference_phase(device)
    runs.append(grad_phase(scene, cam, icfg, rcfg.width, rcfg.height, card))
    runs.append(shard_phase(scene, cam, icfg, rcfg.width, rcfg.height, card))

    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from the start "
        f"of main")
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        counted = ([split_launches[name], dsplit_launches[name]]
                   if name in SPLIT
                   else [staged_launches[name], dstaged_launches[name]]
                   if name in STAGED else [run[name] for run in runs])
        launches = sum(n for n, _rays in counted)
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches,
            rays_a_launch=sum(r for _n, r in counted) / max(launches, 1),
            max_abs_err=max(p[name]["max_abs_err"] for p in phases
                            if name in p),
            ms=main_width[name]["ms"], plain_ms=main_width[name]["plain_ms"],
            **({"device_ms": main_width[name]["device_ms"]}
               if "device_ms" in main_width[name] else {}),
            bound_ms=main_width[name]["bound_ms"],
            bound_by=main_width[name]["bound_by"],
            # no single PyTorch call walks a BVH
            library_ms=None))
        if name in NOTES:
            kernels[-1]["note"] = NOTES[name]
    # the table sum: its launches and lanes in the gradient phase's
    # main-path runs; its error and times from phase 2d, where index_add_
    # is both its plain version and the library's one call
    summed = [run.get("table_sum", (0, 0)) for run in runs]
    tsum_launches = sum(n for n, _lanes in summed)
    if not tsum_launches:
        raise AssertionError("no main-path gradient launched the table sum")
    tsum = tsum_res["total"]
    kernels.append(dict(
        name="table_sum", route="cuda",
        source="ptsharp_tpu_torch/csrc/table_sum.cu", replaces=[],
        launches=tsum_launches,
        lanes_a_launch=sum(n for _n, n in summed) / tsum_launches,
        max_rel_err=tsum["max_rel_err"], ms=tsum["ms"],
        plain_ms=tsum["index_add_ms"], bound_ms=tsum["bound_ms"],
        bound_by="bytes", library_ms=tsum["index_add_ms"],
        note="no Pallas kernel: the JAX package's one-hot matmul "
             "(ptsharp_tpu/tape.py:167 _onehot_accum) and XLA's transpose "
             "of the atlas gather; ms, plain_ms (index_add_) and bound_ms "
             "over one tape gradient's sums at bunny.train's shapes"))
    # each threefry wrapper's launches and words over the main-path renders
    main_draws = {}
    for kind in {kind for kind, _shape in RNG_DRAWS}:
        counted = [run.get(f"threefry.{kind}", (0, 0)) for run in runs]
        main_draws[kind] = (sum(n for n, _words in counted),
                            sum(w for _n, w in counted))
    log(f"rng over the main-path renders (launches, words): {main_draws}")
    for row in rng_res["rng"]:
        row["main_launches"], row["main_words"] = main_draws[row["kind"]]
    # the sphere-trace kernel's launches and rays over the same renders
    traced = [run.get("sdf_march", (0, 0)) for run in runs]
    march_res["main_launches"] = sum(n for n, _rays in traced)
    march_res["main_rays"] = sum(r for _n, r in traced)
    log(f"sdf march over the main-path renders (launches, rays): "
        f"({march_res['main_launches']}, {march_res['main_rays']})")
    if not march_res["main_launches"]:
        raise AssertionError("no main-path render launched the sphere-trace "
                             "kernel")
    print(json.dumps({"kernels": kernels, "rng": rng_res["rng"],
                      "march": march_res}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--shard-rank"]:
        sys.exit(shard_rank(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
                            sys.argv[5]))
    if sys.argv[1:] == ["--shard-cards"]:
        sys.exit(shard_cards())
    sys.exit(main(only={"--rng": "rng", "--march": "march",
                        "--tsum": "tsum"}.get(
        " ".join(sys.argv[1:]))))
