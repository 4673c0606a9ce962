"""core/rng.py's two halves of a draw: keys derived on the host in Python
integers, and the draw itself as one csrc/threefry.cu launch on a card.

CPU: `split` / `fold_in` (the block on Python ints) equal the block in
torch ops on int64 tensors, the kernel's plain version; draws count by
path while a profiler records; the kernel wrappers raise off the card,
and the draws with no kernel (random_bits, uniform_per_key) on it.
Card (`-m cuda`, skipped without one; this file imports no JAX, so on a
machine with a card and no JAX: `python -m pytest --noconftest -m cuda
tests/test_torch_rng_kernel.py`): both kernel entries (uniform, randint)
against the plain path on the same device, as raw bits; draws and a
compacted trace (every depth step) make no host-device sync; a bunny pass
through Renderer equals the same pass with its draws forced through the
plain path.

Tolerance: bit-equal everywhere.
"""

import numpy as np
import pytest
import torch

from ptsharp_tpu_torch import examples, integrator, profiling
from ptsharp_tpu_torch.core import rng
from ptsharp_tpu_torch.kernels import threefry
from ptsharp_tpu_torch.renderer import RenderConfig, Renderer

MASK = 0xFFFFFFFF
# 200 seeded keys of uint32 words, in four groups
KEY_GROUPS = 4
N_KEYS = 200
NUMS = (0, 1, 2, 3, 7, 16, 33, 63, 64)
DATA = (0, 7, *(70000 + 131 * d for d in range(9)), 2**32 - 1)

SEEDS = (0, 1, 7, 4242, 2**31 - 1)
SHAPES = ((0,), (1,), (255,), (256,), (257,), (4099,), (2, 2_073_600),
          (4_147_200,))
RANDINT_N = (1, 2, 3, 7, 1000)


def _keys(group: int) -> torch.Tensor:
    words = np.random.default_rng(2024).integers(0, 2**32, (N_KEYS, 2),
                                                 dtype=np.uint64)
    per = N_KEYS // KEY_GROUPS
    return torch.from_numpy(words[group * per:(group + 1) * per]
                            .astype(np.int64))


def _block(keys, x0, x1):
    """The torch block over (K,) keys and (N,) counters: (K, N, 2)."""
    b0, b1 = rng._threefry2x32(keys[:, 0:1], keys[:, 1:2], x0[None, :],
                               x1[None, :])
    return torch.stack([b0, b1], dim=-1)


@pytest.mark.parametrize("group", range(KEY_GROUPS))
def test_integer_split_equals_torch_block(group):
    keys = _keys(group)
    cnt = torch.arange(max(NUMS), dtype=torch.int64)
    want = _block(keys, torch.zeros_like(cnt), cnt)
    for k, w in zip(keys, want):
        for num in NUMS:
            got = rng.split(k, num)
            assert got.dtype == torch.int64 and got.device == k.device
            assert tuple(got.shape) == (num, 2)
            assert torch.equal(got, w[:num])
    assert torch.equal(rng.split(keys[0]), want[0, :2])


@pytest.mark.parametrize("group", range(KEY_GROUPS))
def test_integer_fold_in_equals_torch_block(group):
    keys = _keys(group)
    data = torch.tensor(DATA, dtype=torch.int64)
    want = _block(keys, torch.zeros_like(data), data)
    for k, w in zip(keys, want):
        for j, d in enumerate(DATA):
            got = rng.fold_in(k, d)
            assert got.dtype == torch.int64 and tuple(got.shape) == (2,)
            assert torch.equal(got, w[j])
    # data is taken as a 32-bit word
    assert torch.equal(rng.fold_in(keys[0], -1), rng.fold_in(keys[0], MASK))


def test_draws_counted_by_path_on_cpu():
    key = rng.PRNGKey(3)
    profiling.reset_counters()
    rng.uniform(key, (4,))
    assert profiling.draws() == {"kernel": 0, "plain": 0}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        rng.uniform(key, (4,))
        rng.random_bits(key, (4,))
        rng.randint(key, (4,), 0, 5)
        rng.uniform_per_key(rng.split(key, 3), 2)
        rng.split(key, 4)  # keys are not draws
    assert profiling.draws() == {"kernel": 0, "plain": 4}
    profiling.reset_counters()
    assert profiling.draws() == {"kernel": 0, "plain": 0}


def test_kernel_wrappers_raise_off_the_card():
    before = [w.launches for w in threefry.WRAPPERS]
    with pytest.raises(ValueError, match="no threefry kernel"):
        threefry.uniform(0, 1, (4,), "cpu")
    with pytest.raises(ValueError, match="no threefry kernel"):
        threefry.randint(0, 1, 2, 3, 5, 1, 0, (4,), "cpu")
    with pytest.raises(ValueError, match="uint32"):
        threefry.uniform(2**32, 1, (4,), "cuda")
    with pytest.raises(ValueError, match="span"):
        threefry.randint(0, 1, 2, 3, 0, 1, 0, (4,), "cuda")
    assert [w.launches for w in threefry.WRAPPERS] == before


def test_draws_without_a_kernel_raise_on_the_card():
    """random_bits has only the torch block: asked for a CUDA device it
    raises before it allocates or counts anything."""
    key = rng.PRNGKey(3)
    profiling.reset_counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(ValueError, match="random_bits has no kernel"):
            rng.random_bits(key, (4,), device="cuda")
        rng.random_bits(key, (4,), device="cpu")
    assert profiling.draws() == {"kernel": 0, "plain": 1}
    profiling.reset_counters()


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _plain(monkeypatch):
    """Force every draw of core/rng.py through the torch block, on the
    device it names."""
    monkeypatch.setattr(rng, "_on_card", lambda dev: False)


def _bits_of(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


DRAWS = {
    "uniform": lambda k, shape, dev: rng.uniform(k, shape, device=dev),
    **{f"randint_{n}": (lambda n: lambda k, shape, dev: rng.randint(
        k, shape, 0, n, device=dev))(n) for n in RANDINT_N},
}
WRAPPER_OF = {"uniform": threefry.uniform,
              **{f"randint_{n}": threefry.randint for n in RANDINT_N}}


@pytest.mark.cuda
@pytest.mark.parametrize("draw", DRAWS)
def test_kernel_equals_plain_path_bit_for_bit(draw, monkeypatch):
    """Both entries against the plain path on the same card, as raw bits,
    over five seeds and shapes about a block's edge and at the main
    path's widths; each launch counted on its wrapper and as a kernel
    draw."""
    dev = _card()
    fn, wrapper = DRAWS[draw], WRAPPER_OF[draw]
    for seed in SEEDS:
        key = rng.fold_in(rng.PRNGKey(seed), 11)
        for shape in SHAPES:
            threefry.reset_launch_counts()
            profiling.reset_counters()
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]):
                got = fn(key, shape, dev)
            torch.cuda.synchronize()
            n = got.numel()
            assert got.device.type == "cuda"
            assert (wrapper.launches, wrapper.words) == ((1, n) if n
                                                         else (0, 0))
            assert profiling.draws() == {"kernel": 1, "plain": 0}
            with monkeypatch.context() as m:
                _plain(m)
                want = fn(key, shape, dev)
            assert got.dtype == want.dtype and got.shape == want.shape
            assert torch.equal(_bits_of(got), _bits_of(want)), (seed, shape)
    profiling.reset_counters()


def _compacted_scene(dev):
    scene, cam, _rc, icfg = examples.bunny(64, 36, subdivisions=3,
                                           intersector="pallas", wide_k=8,
                                           device=dev)
    return scene, cam, RenderConfig(64, 36, spp=2), icfg


@pytest.mark.cuda
def test_card_draws_make_no_host_sync():
    """The old draw copied a CPU key to the card, which waits for the
    card's stream (a sync the debug mode turns into an error); the draws
    and a whole compacted trace of a 64x36 bunny wavefront (every depth
    step, its compactions and walks) now run under that mode."""
    dev = _card()
    key = rng.fold_in(rng.PRNGKey(5), 3)
    scene, cam, rc, icfg = _compacted_scene(dev)
    r = Renderer(scene, cam, rc, icfg)
    org, dirn, kt, *_ = r._raygen(key, 0, rc.height, rc.spp)
    if not integrator.compaction_schedule(icfg, org.shape[0]):
        raise AssertionError("the wavefront must compact")
    # warm up: the first call makes its cached device constants
    integrator.trace_compacted_static(scene, icfg, org, dirn, kt)
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        with pytest.raises(RuntimeError, match="synchroniz"):
            key.to(dev)  # the draw's key copy before the kernel
        rng.uniform(key, (4099,), device=dev)
        rng.randint(key, (1000,), 0, 7, device=dev)
        # the draws with no kernel raise before they touch the card
        with pytest.raises(ValueError, match="random_bits has no kernel"):
            rng.random_bits(key, (2, 257), device=dev)
        keys = torch.zeros((3, 2), dtype=torch.int64, device=dev)
        with pytest.raises(ValueError, match="uniform_per_key has no kernel"):
            rng.uniform_per_key(keys, 2)
        out = integrator.trace_compacted_static(scene, icfg, org, dirn, kt)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(out.radiance).all()


@pytest.mark.cuda
def test_bunny_pass_equals_plain_draws(monkeypatch):
    """A 64x36, 2-spp compacted bunny pass on the card through Renderer,
    its draws by the kernel, equals the same pass with its draws forced
    through the torch block, in every film field and the ray count."""
    dev = _card()
    scene, cam, rc, icfg = _compacted_scene(dev)
    films = []
    for plain in (False, True):
        with monkeypatch.context() as m:
            if plain:
                _plain(m)
            threefry.reset_launch_counts()
            r = Renderer(scene, cam, rc, icfg)
            film = r.render(key=rng.PRNGKey(9))
            launches = sum(w.launches for w in threefry.WRAPPERS)
            assert (launches > 0) != plain
            films.append((film, r.rays_traced))
    (a, ra), (b, rb) = films
    assert ra == rb > 0
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name
