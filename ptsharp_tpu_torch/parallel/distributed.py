"""Multi-process entry points on torch.distributed.

Counterpart of ptsharp_tpu/parallel/distributed.py. The JAX package joins
JAX's multi-controller runtime; the port runs one process per device, a
rank, in one torch.distributed process group: NCCL between cards, gloo
between CPU processes. Every rank calls `initialize` once, then builds
the same (dp, sp) mesh with `global_mesh`; the renderers of
parallel/shard.py then shard image rows and samples over the ranks, with
the scene replicated on each.

Nothing falls back: NCCL without a card, a card that is not there, or a
rendezvous that fails raises.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import tempfile
import time

import torch
import torch.distributed as dist

from ptsharp_tpu_torch.core import device as devices
from ptsharp_tpu_torch.parallel.mesh import Mesh, make_mesh, rank_device

# how long the rendezvous and each collective may wait
TIMEOUT = datetime.timedelta(minutes=5)
_TORCHRUN = ("MASTER_ADDR", "WORLD_SIZE", "RANK")


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device=None,
               backend: str | None = None) -> None:
    """Join the process group (torch.distributed.init_process_group at
    tcp://<coordinator_address>, rank `process_id` of `num_processes`).

    With no arguments it takes torchrun's rendezvous from the environment
    (MASTER_ADDR, WORLD_SIZE, RANK); without that it is the single-process
    case and returns, as it does when a group already exists. `device` is
    the rank's: cuda:<LOCAL_RANK, else the rank> unless given ("cpu" for a
    CPU rank). The backend follows it, "nccl" for a card and "gloo" for the
    CPU, unless `backend` names one: gloo ranks may share a card."""
    if dist.is_initialized():
        return
    torchrun = all(k in os.environ for k in _TORCHRUN)
    if coordinator_address is None:
        if not torchrun and num_processes in (None, 1) and process_id in (
                None, 0):
            return
        if not torchrun:
            raise ValueError("a multi-process run needs coordinator_address "
                             "(or torchrun's environment)")
        init_method = "env://"
        world = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    else:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and "
                             "process_id")
        init_method = f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', rank))}"
    dev = devices.resolve(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"NCCL runs between cards, not on {dev}")
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("this torch has no NCCL")
    if dev.type == "cuda":
        if (dev.index or 0) >= torch.cuda.device_count():
            raise RuntimeError(f"{dev}: this machine has "
                               f"{torch.cuda.device_count()} cards")
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, timeout=TIMEOUT)


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def global_mesh(dp: int | None = None, sp: int = 1, device=None) -> Mesh:
    """The (dp, sp) render mesh over every rank (every rank builds the
    same one)."""
    return make_mesh(dp, sp, device)


def process_summary(device=None) -> dict:
    """Process-group topology snapshot (observability hook): one device a
    rank."""
    if dist.is_initialized():
        rank, n = dist.get_rank(), dist.get_world_size()
        gpu = rank_device(device).type == "cuda"
    else:
        rank, n = 0, 1
        gpu = (devices.resolve(device).type == "cuda" if device is not None
               else torch.cuda.is_available())
    return {
        "process_index": rank,
        "process_count": n,
        "local_devices": 1,
        "global_devices": n,
        "platform": "gpu" if gpu else "cpu",
    }


def free_port() -> int:
    """A free TCP port on localhost for a rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(commands: list[list[str]], timeout: float, cwd=None,
              env=None) -> list[str]:
    """Run one process a rank, `commands[rank]`, and return each one's
    output (stdout and stderr). Raises, after killing the others, as soon
    as one exits non-zero or when `timeout` seconds have passed, so a rank
    that fails never leaves the rest waiting at a rendezvous."""
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(os.path.join(tmp, f"rank{i}.log"), "w+")
                for i in range(len(commands))]
        procs = [subprocess.Popen(cmd, cwd=cwd, env=env, stdout=log,
                                  stderr=subprocess.STDOUT)
                 for cmd, log in zip(commands, logs)]
        deadline = time.monotonic() + timeout
        try:
            while True:
                codes = [p.poll() for p in procs]
                failed = next((i for i, c in enumerate(codes)
                               if c not in (None, 0)), None)
                if failed is not None or all(c == 0 for c in codes) \
                        or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            outs = []
            for log in logs:
                log.seek(0)
                outs.append(log.read())
                log.close()
    if failed is not None:
        raise RuntimeError(f"rank {failed} of {len(commands)} exited "
                           f"{codes[failed]}:\n{outs[failed][-3000:]}")
    if not all(c == 0 for c in codes):
        raise TimeoutError(f"{len(commands)} ranks not done in {timeout} s:"
                           f"\n{outs[0][-3000:]}")
    return outs
