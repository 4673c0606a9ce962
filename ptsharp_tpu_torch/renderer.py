"""Renderer: progressive, adaptive and firefly passes over the film.

Counterpart of ptsharp_tpu/renderer.py. Each pass renders `spp` samples
for every pixel in row chunks of at most `max_rays_per_chunk` rays; mesh
scenes trace each chunk's pixels in 2D-Morton order so traversal sees
compact pixel blocks. Variance-driven passes (adaptive, firefly) run the
same wavefront with per-pixel sample masks.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ptsharp_tpu_torch import checkpoint, profiling
from ptsharp_tpu_torch.camera import Camera
from ptsharp_tpu_torch.core import color as colorlib
from ptsharp_tpu_torch.core import filters, rng, vec
from ptsharp_tpu_torch.denoise import denoise_film
from ptsharp_tpu_torch.film import Film, save_png
from ptsharp_tpu_torch.integrator import (
    IntegratorConfig, trace, trace_compacted_static,
)
from ptsharp_tpu_torch.scene import SceneData


@dataclass(frozen=True)
class RenderConfig:
    width: int = 256
    height: int = 256
    spp: int = 4  # samples per pixel per progressive pass
    stratified: bool = False  # stratified first-hit grid
    adaptive_samples: int = 0  # max extra samples/pixel
    adaptive_threshold: float = 1.0
    adaptive_exponent: float = 1.0
    firefly_samples: int = 0  # extra samples for firefly pixels
    firefly_threshold: float = 1.0
    filter: str = "box"  # pixel reconstruction filter
    max_rays_per_chunk: int = 1 << 21  # wavefront width bound
    # sync-free wavefront compaction (trace_compacted_static); it falls
    # back to the plain trace where its schedule is empty
    compaction: bool = True


def _expand_bits16(v):
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


def _merge_rows(film: Film, row0: int, chunk: Film) -> Film:
    """Welford-merge a row-chunk film into the full film at a row offset.
    Updates the rows [row0, row0 + h) of `film`'s tensors IN PLACE and
    returns `film`."""
    h = chunk.mean.shape[0]
    rows = slice(row0, row0 + h)
    merged = Film(*(f[rows] for f in film)).merge(chunk)
    for dst, src in zip(film, merged):
        dst[rows] = src
    return film


class Renderer:
    """Holds the scene, camera and configs; all image state lives in the
    Film the caller threads through."""

    def __init__(self, scene: SceneData, camera: Camera, config: RenderConfig,
                 integrator: IntegratorConfig | None = None):
        self.scene = scene
        self.camera = camera.to(scene.device)
        self.config = config
        self.integrator = integrator or IntegratorConfig()
        self.rays_traced = 0

    def _rows_per_chunk(self, spp: int) -> int:
        cfg = self.config
        rows = max(1, cfg.max_rays_per_chunk // max(1, cfg.width * spp))
        return int(min(rows, cfg.height))

    def _pixel_perm(self, row0: int, rows: int):
        """2D-Morton order of the chunk's pixels and its inverse."""
        dev = self.scene.device
        w = self.config.width
        ys = (row0 + torch.arange(rows, device=dev))[:, None]
        xs = torch.arange(w, device=dev)[None, :]
        mkey = _expand_bits16(xs) | (_expand_bits16(ys) << 1)
        perm = torch.argsort(mkey.reshape(-1), stable=True)
        return perm, torch.argsort(perm, stable=True)

    def _raygen(self, key, row0: int, rows: int, spp: int):
        cfg = self.config
        dev = self.scene.device
        w = cfg.width
        yy, xx = torch.meshgrid(row0 + torch.arange(rows, device=dev),
                                torch.arange(w, device=dev), indexing="ij")
        pix_x = torch.broadcast_to(xx[None], (spp, rows, w)).reshape(-1)
        pix_y = torch.broadcast_to(yy[None], (spp, rows, w)).reshape(-1)
        r = pix_x.shape[0]
        kj, kl, kt = rng.split(key, 3)
        ju, jv = rng.uniform(kj, (2, r), device=dev)
        n_strat = max(1, int(np.sqrt(spp))) if cfg.stratified else 1
        sidx = None
        if cfg.stratified:
            n = n_strat
            s = torch.broadcast_to(
                torch.arange(spp, device=dev)[:, None, None] % (n * n),
                (spp, rows, w)).reshape(-1)
            ju = vec.div((s % n).to(torch.float32) + ju, n)
            jv = vec.div(torch.div(s, n, rounding_mode="floor").to(
                torch.float32) + jv, n)
            if n_strat > 1:
                sidx = s
        lens_u, lens_v = rng.uniform(kl, (2, r), device=dev)
        org, dirn = self.camera.cast_rays(pix_x, pix_y, cfg.width, cfg.height,
                                          ju, jv, lens_u, lens_v)
        inv = None
        if self.scene.has_meshes:
            perm, inv = self._pixel_perm(row0, rows)

            def shuf(a):
                return a.reshape((spp, rows * w) + a.shape[1:])[:, perm] \
                    .reshape(a.shape)

            org, dirn = shuf(org), shuf(dirn)
            if sidx is not None:
                sidx = shuf(sidx)
        return org.contiguous(), dirn.contiguous(), kt, sidx, n_strat, \
            ju, jv, inv

    def _render_chunk(self, key, row0: int, rows: int, spp: int,
                      weight_rows):
        """Render `spp` samples for image rows [row0, row0+rows). Returns
        the chunk's film and its ray count (a device scalar)."""
        cfg = self.config
        w = cfg.width
        with profiling.span("pt.raygen"):
            org, dirn, kt, sidx, n_strat, ju, jv, inv = self._raygen(
                key, row0, rows, spp)
        tracer = trace_compacted_static if cfg.compaction else trace
        result = tracer(self.scene, self.integrator, org, dirn, kt, sidx,
                        n_strat)

        def unshuf(a):
            if inv is None:
                return a
            return a.reshape((spp, rows * w) + a.shape[1:])[:, inv] \
                .reshape(a.shape)

        with profiling.span("pt.merge"):
            radiance = unshuf(result.radiance).reshape(spp, rows, w, 3)
            albedo = unshuf(result.albedo).reshape(spp, rows, w, 3)
            normal = unshuf(result.normal).reshape(spp, rows, w, 3)
            if weight_rows is None:
                weight = torch.ones((spp, rows, w), dtype=torch.float32,
                                    device=radiance.device)
            else:
                weight = weight_rows
            if cfg.filter != filters.BOX:
                fw = filters.evaluate(cfg.filter, ju - 0.5, jv - 0.5)
                weight = weight * fw.reshape(spp, rows, w)
            chunk = Film.zeros(rows, w, radiance.device).add_batch(
                radiance, weight, albedo, normal)
        return chunk, result.rays_traced

    def _render_pass(self, film: Film, key, spp: int, weight=None) -> Film:
        """One spp-sample pass over the whole image, chunked by rows.
        weight: optional (spp, H, W) mask."""
        cfg = self.config
        rows_per = self._rows_per_chunk(spp)
        n_chunks = -(-cfg.height // rows_per)
        with profiling.span("pt.pass"), profiling.counted_pass() as tally:
            keys = rng.split(key, n_chunks)
            counts = []
            with torch.no_grad():
                for ci in range(n_chunks):
                    row0 = ci * rows_per
                    rows = min(rows_per, cfg.height - row0)
                    wr = (None if weight is None
                          else weight[:, row0:row0 + rows])
                    chunk, rays = self._render_chunk(keys[ci], row0, rows,
                                                     spp, wr)
                    with profiling.span("pt.merge"):
                        film = _merge_rows(film, row0, chunk)
                    counts.append(rays)
            # one device-to-host read per pass (the lane counts ride on it)
            with profiling.span("pt.sync"):
                self.rays_traced += tally.read(torch.stack(counts).sum())
        return film

    def render(self, film: Film | None = None, key=None) -> Film:
        """One full progressive pass: spp samples/pixel, then adaptive and
        firefly refinement (Renderer.cs:199-472)."""
        cfg = self.config
        if film is None:
            film = Film.zeros(cfg.height, cfg.width, self.scene.device)
        if key is None:
            key = rng.PRNGKey(0)
        k1, k2, k3 = rng.split(key, 3)
        film = self._render_pass(film, k1, cfg.spp)
        if cfg.adaptive_samples > 0:
            stddev = colorlib.luminance(film.stddev())
            frac = torch.clamp(vec.div(stddev, cfg.adaptive_threshold), 0.0,
                               1.0)
            extra = cfg.adaptive_samples * frac**cfg.adaptive_exponent
            lane = torch.arange(cfg.adaptive_samples, dtype=torch.float32,
                                device=extra.device)[:, None, None]
            weight = (lane < extra[None]).to(torch.float32)
            film = self._render_pass(film, k2, cfg.adaptive_samples, weight)
        if cfg.firefly_samples > 0:
            stddev = colorlib.luminance(film.stddev())
            mask = (stddev > cfg.firefly_threshold).to(torch.float32)
            weight = torch.broadcast_to(
                mask[None], (cfg.firefly_samples,) + mask.shape)
            film = self._render_pass(film, k3, cfg.firefly_samples, weight)
        return film

    def iterative_render(self, iterations: int, key=None,
                         path_template: str | None = None,
                         film: Film | None = None, denoise: bool = False,
                         verbose: bool = False,
                         checkpoint_path: str | None = None,
                         checkpoint_every: int = 0, viewer=None) -> Film:
        """Progressive refinement loop (IterativeRender,
        Renderer.cs:702-765): the film accumulates across iterations, and
        iteration it renders with fold_in(key, it). Each iteration may
        write `path_template % iteration` as PNG and hand its frame to
        `viewer.update`. With `checkpoint_path` the film, iteration and key
        are saved every `checkpoint_every` iterations, and a render whose
        file exists resumes from it (its key included). `denoise` writes
        the a-trous filtered film beside the last PNG as *_denoised.png."""
        if key is None:
            key = rng.PRNGKey(0)
        cfg = self.config
        start_it = 0
        if checkpoint_path and os.path.exists(checkpoint_path):
            film, start_it, key = checkpoint.load_checkpoint(
                checkpoint_path, self.scene.device)
            if verbose:
                print(f"resumed from {checkpoint_path} @ iter {start_it}")
        if film is None:
            film = Film.zeros(cfg.height, cfg.width, self.scene.device)
        for it in range(start_it, iterations):
            t0 = time.perf_counter()
            film = self.render(film, rng.fold_in(key, it))
            if verbose:
                if film.mean.is_cuda:
                    torch.cuda.synchronize(film.mean.device)
                print(f"[{it + 1}/{iterations}] {cfg.width}x{cfg.height} "
                      f"spp+={cfg.spp} rays={self.rays_traced} "
                      f"{time.perf_counter() - t0:.2f}s")
            if path_template:
                save_png(film.color_srgb(), path_template % (it + 1)
                         if "%" in path_template else path_template)
            if (checkpoint_path and checkpoint_every
                    and (it + 1) % checkpoint_every == 0):
                checkpoint.save_checkpoint(checkpoint_path, film, it + 1,
                                           key)
            if viewer is not None:
                viewer.update(film.color_srgb())
        if denoise:
            img = denoise_film(film)
            if path_template:
                base = (path_template % iterations if "%" in path_template
                        else path_template)
                save_png(colorlib.to_srgb(img),
                         base.replace(".png", "_denoised.png"))
        return film
