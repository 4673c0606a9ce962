"""The train loop: parallel.shard.make_train_step on a (dp, sp) mesh of
ranks (one process a card), SGD on the material colours toward a target
rendered at set-up from the published colours, each step on its own key.
Set-up runs the first `check_steps` steps through the same step object
(its warm-up), whose losses and colours the reference follows; the
window runs the steps after them. A mesh of more than one rank is started
here, one process a rank; rank 0 prints the result."""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import sys
import time

import numpy as np
import torch

from perfbench import checks, devtrace
from perfbench.loops import common
from perfbench.reference import rng as rrng


def _launch(ctx, world: int) -> dict:
    """Start the ranks and return rank 0's result line."""
    from ptsharp_tpu_torch.parallel import distributed

    a = ctx["args"]
    port = distributed.free_port()
    run_py = os.path.join(ctx["root"], "perfbench", "run.py")
    cmds = [[sys.executable, run_py, "--workload", a.workload, "--seed",
             str(a.seed), "--seconds", str(a.seconds), "--trace",
             str(a.trace), "--rank", str(r), "--port", str(port),
             "--t-start", repr(ctx["t_start"])]
            + (["--cpu-toy"] if a.cpu_toy else []) for r in range(world)]
    outs = distributed.run_ranks(cmds, timeout=330, cwd=ctx["root"])
    lines = [ln for ln in outs[0].splitlines() if ln.startswith("{")]
    sys.stderr.write(outs[0][-6000:])
    return {"line": json.loads(lines[-1])}


def run(ctx):
    args, spec = ctx["args"], ctx["spec"]
    traffic, conf = spec["traffic"], spec["config"]
    dp, sp = traffic["mesh"]
    world = dp * sp
    if world > 1 and args.rank is None:
        return _launch(ctx, world)
    rank = args.rank or 0
    import torch.distributed as dist
    from ptsharp_tpu_torch.parallel import distributed, shard
    from ptsharp_tpu_torch.parallel.mesh import single_device_mesh

    dev = common.device_of(ctx, rank)
    ctrl = None
    if world > 1:
        distributed.initialize(f"localhost:{args.port}", world, rank,
                               device=dev)
        mesh = distributed.global_mesh(dp, sp)
        ctrl = dist.new_group(backend="gloo")
    else:
        mesh = single_device_mesh(dev)
    key = checks.run_key(args.seed)
    (scene, cam, _rc, icfg), build_s = common.build_scene(ctx, dev)
    kw = common.scene_kwargs(ctx)
    width, height = kw["width"], kw["height"]
    published = scene.materials.color
    lo, hi = traffic["perturb"]
    factor = np.random.default_rng([args.seed, 2]).uniform(
        lo, hi, size=tuple(published.shape)).astype(np.float32)
    c0 = published.cpu() * torch.from_numpy(factor)
    with torch.no_grad():
        target = shard.render_image_sharded(
            scene, cam, icfg, checks.port_key(rrng.fold_in(key, 0x7A7)),
            width, height, traffic["target_spp"], mesh)
    scene = dataclasses.replace(scene, materials=scene.materials._replace(
        color=c0.to(dev)))
    step = shard.make_train_step(cam, icfg, width, height, traffic["spp"],
                                 mesh, lr=traffic["lr"])
    if "step" in ctx["hooks"]:
        step = ctx["hooks"]["step"](step)
    losses, colors = [], []
    for i in range(traffic["check_steps"]):
        scene, loss = step(scene, checks.port_key(rrng.fold_in(key, i)),
                           target)
        losses.append(float(loss))
        colors.append(scene.materials.color.detach().cpu().clone())
    common.sync(dev)

    first = traffic["check_steps"]
    tracer = common.Tracer(args.trace == 1, first + 1,
                           traffic["trace_units"], dev)
    flag = torch.zeros(1, dtype=torch.int32)
    steps = 0
    t0 = time.perf_counter()
    setup_s = time.time() - ctx["t_start"]
    while True:
        i = first + steps
        tracer.before(i)
        scene, loss = step(scene, checks.port_key(rrng.fold_in(key, i)),
                           target)
        float(loss)
        steps += 1
        tracer.after(i)
        flag[0] = int(time.perf_counter() - t0 >= args.seconds
                      and tracer.done)
        if ctrl is not None:  # rank 0's clock ends the window for all
            dist.broadcast(flag, src=0, group=ctrl)
        if flag[0]:
            break
    window_s = time.perf_counter() - t0
    info = common.device_info(dev, world)
    red = tracer.reduce()
    record = {"setup_s": setup_s, "window_s": window_s, "steps": steps,
              "scene_build_s": build_s, "trace": red}
    if red is not None:
        record["busy_s"] = devtrace.busy_s(red)
        record["traced_s"] = (red["window"][1] - red["window"][0]) * 1e-9
    del scene, step
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    sub = kw.get("subdivisions") if args.cpu_toy else None
    t_check = time.perf_counter()
    numbers = checks.train_check(conf, traffic, args.seed, c0, target,
                                 losses, colors, width, height, dev, dp, sp,
                                 rank, world, subdivisions=sub)
    print(f"run.py: rank {rank}'s reference check took "
          f"{time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    if ctrl is not None:
        mine = {"numbers": numbers, "mem": info["memory_peak_bytes"],
                "busy": record.get("busy_s"),
                "traced": record.get("traced_s")}
        every = [None] * world
        dist.all_gather_object(every, mine, group=ctrl)
        # every rank's checks: the worst reading of each number
        numbers = {k: max(e["numbers"][k] for e in every) for k in numbers}
        info["memory_peak_bytes"] = max(e["mem"] for e in every)
        if red is not None:
            record["busy_s"] = sum(e["busy"] for e in every) / world
            record["traced_s"] = sum(e["traced"] for e in every) / world
        distributed.shutdown()
        if rank != 0:
            return None
    limits = traffic["check"]["limits"]
    out = {"attempted": steps, "failed": 0, "record": record,
           "device": info,
           "checks": {k: {"value": v, "limit": limits[k]}
                      for k, v in numbers.items()}}
    if red is not None:
        out["device"].update(busy_s=record["busy_s"],
                             window_s=record["traced_s"])
        out["breakdown"] = devtrace.breakdown(red)
    return out
