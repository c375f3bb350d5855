"""The port's threefry generator (core/threefry) and kernel T1's plain
version (ops/threefry_kernel) against ``jax.random`` on the CPU, in JAX's
partitionable threefry layout.  All exact: every word and every float32
bit."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_soccer_tpu.config import EnvConfig as JaxConfig
from gym_soccer_tpu.core import batch as jbatch
from gym_soccer_tpu_torch.core import batch, threefry
from gym_soccer_tpu_torch.ops import _build
from gym_soccer_tpu_torch.ops import threefry_kernel as tk

# One torch intra-op thread in each xdist worker: the workers share the
# machine's cores, and a default-sized pool in each oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

SEEDS = [0, 1, 42, 2 ** 31 - 1, 2 ** 32 - 1, 2 ** 32 + 5, -1, -7]


def _words(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def test_the_layout_is_partitionable():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key(seed):
    got = threefry.key(seed)
    assert got.dtype == torch.int64 and tuple(got.shape) == (2,)
    assert np.array_equal(got.numpy(), _words(jax.random.key(seed)))


def test_key_of_seed_array_is_vmapped_key():
    seeds = np.random.default_rng(0).integers(0, 2 ** 32, 50,
                                              dtype=np.uint64)
    seeds = seeds.astype(np.uint32)
    want = _words(jax.vmap(jax.random.key)(jnp.asarray(seeds)))
    assert np.array_equal(threefry.key(seeds).numpy(), want)


def test_key_data_round_trip():
    k = threefry.key(9)
    assert threefry.key_data(k) is k
    words = _words(jax.random.fold_in(jax.random.key(9), 4)).astype(
        np.uint32)
    assert np.array_equal(threefry.wrap_key_data(words).numpy(), words)


@pytest.mark.parametrize("data", [0, 1, 9, 37, 2 ** 31 - 1, 2 ** 32 - 1])
def test_fold_in(data):
    for seed in (0, 3, 2 ** 32 - 1):
        want = _words(jax.random.fold_in(jax.random.key(seed), data))
        assert np.array_equal(threefry.fold_in(threefry.key(seed),
                                               data).numpy(), want)


def test_fold_in_batched_over_keys_and_data():
    rng = np.random.default_rng(1)
    seeds = rng.integers(0, 2 ** 32, 64, dtype=np.uint64).astype(np.uint32)
    data = rng.integers(0, 2 ** 32, 64, dtype=np.uint64).astype(np.uint32)
    jk = jax.vmap(jax.random.key)(jnp.asarray(seeds))
    want = _words(jax.vmap(jax.random.fold_in)(jk, jnp.asarray(data)))
    got = threefry.fold_in(threefry.key(seeds),
                           torch.as_tensor(data.astype(np.int64)))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(2,), (3, 4), 5])
def test_split(shape):
    k = jax.random.key(11)
    want = _words(jax.random.split(k, shape))
    assert np.array_equal(threefry.split(threefry.key(11), shape).numpy(),
                          want)


def test_random_bits():
    k = jax.random.fold_in(jax.random.key(2), 77)
    want = np.asarray(jax.random.bits(k, (7, 9))).astype(np.int64)
    got = threefry.random_bits(threefry.wrap_key_data(_words(k)), (7, 9))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(1,), (4,), (2, 300)])
def test_uniform(shape):
    for seed in (0, 5):
        want = np.asarray(jax.random.uniform(jax.random.key(seed), shape))
        got = threefry.uniform(threefry.key(seed), shape)
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("lo,hi", [(0, 5), (0, 1), (-3, 100_000), (4, 4)])
def test_randint(lo, hi):
    k = jax.random.key(13)
    want = np.asarray(jax.random.randint(k, (2, 256), lo, hi))
    got = threefry.randint(threefry.key(13), (2, 256), lo, hi)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("salt", [0, 1, 9])
@pytest.mark.parametrize("count", [1, 2, 4])
def test_per_env_uniforms_plain_version(salt, count):
    """T1's plain version equals JAX's per_env_uniforms(rng="threefry") at
    counters up to 2**31 - 1, through core/batch too."""
    B = 256
    jst = jax.jit(lambda k: jbatch.init(JaxConfig(5, 4, 0.2), k, B))(
        jax.random.key(3))
    n = np.random.default_rng(salt + 10 * count).integers(
        0, 2 ** 31 - 1, B, dtype=np.int64).astype(np.int32)
    n[:3] = [0, 37, 2 ** 31 - 1]
    jst = jst._replace(n=jnp.asarray(n))
    want = np.asarray(jbatch.per_env_uniforms(jst, count, salt=salt))
    key = torch.as_tensor(_words(jst.key))
    got = tk.threefry_uniforms_plain(key, torch.as_tensor(n), count, salt)
    assert np.array_equal(got.numpy(), want)
    st = batch.EnvState(*(torch.tensor(np.asarray(f)) for f in jst[:7]),
                        key=key)
    assert np.array_equal(batch.per_env_uniforms(st, count, salt).numpy(),
                          want)


def test_wrapper_runs_the_plain_version_on_the_cpu_and_checks_shapes():
    key = threefry.fold_in(threefry.key(1), torch.arange(8))
    n = torch.arange(8, dtype=torch.int32)
    tk.reset_launch_counts()
    assert torch.equal(tk.threefry_uniforms(key, n, 3, 9),
                       tk.threefry_uniforms_plain(key, n, 3, 9))
    assert tk.launch_counts["threefry_uniforms"] == 0
    with pytest.raises(ValueError):
        tk.threefry_uniforms(key, n[:4], 3)
    with pytest.raises(ValueError):
        tk.threefry_uniforms(key, n, 0)
    with pytest.raises(ValueError):
        tk._launch(key, n, 2, 0)   # no kernel for a CPU tensor


def test_kernel_source_constants_match():
    """The rotation and parity constants of the device threefry that T1
    and S1 share (csrc/threefry.cuh) are the module's, and T1's entry
    points include it."""
    cuh = (_build.CSRC / "threefry.cuh").read_text()
    for r in (*threefry.ROTATIONS[0], *threefry.ROTATIONS[1]):
        assert f"GST_ROUND({r})" in cuh
    assert f"0x{threefry.PARITY:08X}u" in cuh
    src = (_build.CSRC / "threefry_kernel.cu").read_text()
    assert '#include "threefry.cuh"' in src
    assert "gst_threefry_uniforms" in src and "gst_threefry_keyed" in src
