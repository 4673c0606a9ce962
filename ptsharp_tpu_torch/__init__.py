"""ptsharp_tpu_torch: the path tracer of ptsharp_tpu, ported to PyTorch and
CUDA for NVIDIA Hopper (H100).

The JAX package `ptsharp_tpu` stays the reference; this package keeps its
module paths and public names and imports neither JAX nor ptsharp_tpu.
Plain tensor code is PyTorch; the BVH traversals that the JAX package
ran as Pallas TPU kernels are hand-written CUDA kernels (csrc/), built with
nvcc for sm_90a at first use. On CPU tensors their plain PyTorch versions
run instead, which is how the tests exercise the port without a card.
Entry points that take a `device` run on the card unless "cpu" is asked
for.

Layer map:
  core/          vec math (the card's bits equal to the CPU's), sampling,
                 color, filters, threefry rng, device, Poisson discs
  geometry/      mesh container (cube, quad, icosphere), analytic primitives,
                 SDF trees, voxel volumes and heightfields with their
                 marches (march.py), marching tetrahedra, SH lobe meshes
  io/            OBJ/MTL, STL and molfile readers and writers
  accel/         host BVH build, K-wide collapse, fat-table packing; the
                 XLA walks (traverse.py) and the cluster cull (cluster.py)
  kernels/       CUDA kernel build, wrappers and plain versions
  scene.py       host scene builder -> SceneData of tensors on one device
                 (mesh lights' area tables included)
  intersect.py   closest-hit, occlusion, shading data (normal, bump maps)
  integrator.py  wavefront path integrator (plain and compacted; the
                 specular branch split, every light mode, mesh lights),
                 differentiable in materials, textures and environment
  tape.py        analytic tape backward (trace_tape_radiance)
  diff.py        differentiable render_image, material_color_grad
  film.py        Welford film, AOV images, PNG encoder (zlib)
  renderer.py    chunked progressive renderer, iterative_render
  checkpoint.py  film/iteration/key .npz, shared with the JAX package
  denoise.py     a-trous wavelet denoiser
  viewer.py      HTTP live preview
  profiling.py   spans and lane counters (on while a torch profiler
                 records), Chrome traces, card memory
  examples.py    the 28-scene catalog, the beads animation and the
                 command line (python -m ptsharp_tpu_torch.examples)
  convert.py     JAX-package scene/camera/DiffParams -> port
  parallel/      torch.distributed ranks (NCCL between cards, gloo between
                 CPU processes) on a (dp, sp) mesh: image rows x samples,
                 the scene replicated, film and gradients all_reduced;
                 entry and dryrun_multichip, as __graft_entry__.py
"""

from ptsharp_tpu_torch.camera import Camera
from ptsharp_tpu_torch.film import Film
from ptsharp_tpu_torch.integrator import IntegratorConfig
from ptsharp_tpu_torch.materials import (
    Material,
    clear_material,
    diffuse_material,
    glossy_material,
    light_material,
    metallic_material,
    specular_material,
    transparent_material,
)
from ptsharp_tpu_torch.renderer import RenderConfig, Renderer
from ptsharp_tpu_torch.scene import SceneBuilder, SceneData
from ptsharp_tpu_torch.tape import trace_tape_radiance

__all__ = [
    "Camera",
    "Film",
    "IntegratorConfig",
    "Material",
    "clear_material",
    "diffuse_material",
    "glossy_material",
    "light_material",
    "metallic_material",
    "specular_material",
    "transparent_material",
    "RenderConfig",
    "Renderer",
    "SceneBuilder",
    "SceneData",
    "trace_tape_radiance",
]
