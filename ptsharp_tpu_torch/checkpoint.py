"""Film and render-state checkpoints (counterpart of
ptsharp_tpu/checkpoint.py, the same file).

The whole render state, the Welford film, the iteration count and the
base key, goes into one .npz; a resumed render continues exactly,
because sampling is keyed and not stateful. The fields and
FORMAT_VERSION are the JAX package's, and the key is stored as its
(2,) uint32 words, so each package reads the other's checkpoints. The
write goes to a temporary file that then replaces the target, so a
crash leaves the last complete checkpoint.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ptsharp_tpu_torch.core import device as devices
from ptsharp_tpu_torch.film import Film

FORMAT_VERSION = 1


def save_checkpoint(path: str, film: Film, iteration: int, key) -> None:
    """Write (film, iteration, key) to `path` (.npz) atomically."""
    tmp = path + ".tmp"
    if not tmp.endswith(".npz"):  # np.savez appends it otherwise
        tmp += ".npz"
    arrays = {name: getattr(film, name).detach().cpu().numpy()
              for name in Film._fields}
    np.savez_compressed(
        tmp, version=FORMAT_VERSION, iteration=iteration,
        key=torch.as_tensor(key).cpu().numpy().astype(np.uint32), **arrays)
    os.replace(tmp, path)


def load_checkpoint(path: str, device=devices.DEFAULT):
    """(film on `device`, iteration, key): the key as the port's (2,)
    int64 tensor on the CPU."""
    dev = devices.resolve(device)
    with np.load(path) as z:
        if int(z["version"]) != FORMAT_VERSION:
            raise ValueError(f"{path}: checkpoint version {int(z['version'])}"
                             f", expected {FORMAT_VERSION}")
        film = Film(*(torch.from_numpy(np.asarray(z[name], np.float32))
                      .to(dev) for name in Film._fields))
        key = torch.from_numpy(np.asarray(z["key"]).astype(np.int64))
        return film, int(z["iteration"]), key
