"""The port's tensor MT19937 (core/mt19937.py) against the JAX package's and
against numpy's RandomState, bit for bit (tolerance 0)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_soccer_tpu.core import mt19937 as jmt
from gym_soccer_tpu.core import parity as jparity
from gym_soccer_tpu_torch.core import mt19937, parity

# One torch intra-op thread in each xdist worker: the workers share the
# machine's cores, and a default-sized pool in each oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

SEEDS = np.asarray([0, 1, 7, 42, 2**31 - 1, 2**32 - 1], np.uint32)


def _t(a):
    return torch.as_tensor(np.asarray(a).astype(np.int64))


def test_seed_states_equal_jax():
    got = mt19937.seed_states(torch.as_tensor(SEEDS))
    want = np.asarray(jax.jit(jmt.seed_states)(jnp.asarray(SEEDS)))
    assert got.shape == (len(SEEDS), 624)
    assert np.array_equal(got.numpy(), want.astype(np.int64))


def test_twist_and_temper_equal_jax():
    mt = jax.jit(jmt.seed_states)(jnp.asarray(SEEDS))
    got = mt19937.seed_states(torch.as_tensor(SEEDS))
    for _ in range(3):
        mt = jax.jit(jmt.twist)(mt)
        got = mt19937.twist(got)
        assert np.array_equal(got.numpy(), np.asarray(mt).astype(np.int64))
        assert np.array_equal(
            mt19937.temper(got).numpy(),
            np.asarray(jax.jit(jmt.temper)(mt)).astype(np.int64))


def test_double_bits_equal_jax_and_float64():
    """Integer-only IEEE-754 assembly against JAX's and against the real
    float64 bit split, edge cases (0, 1, 2**53 - 1) included."""
    rng = np.random.RandomState(0)
    a = rng.randint(0, 2**27, size=500).astype(np.uint32)
    b = rng.randint(0, 2**26, size=500).astype(np.uint32)
    a[:4] = [0, 0, 2**27 - 1, 1]
    b[:4] = [0, 1, 2**26 - 1, 0]
    hi, lo = mt19937.double_bits(_t(a), _t(b))
    jhi, jlo = jax.jit(jmt.double_bits)(jnp.asarray(a), jnp.asarray(b))
    assert np.array_equal(hi.numpy(), np.asarray(jhi).astype(np.int64))
    assert np.array_equal(lo.numpy(), np.asarray(jlo).astype(np.int64))
    vals = (a.astype(np.float64) * 67108864.0 + b) / 9007199254740992.0
    assert np.array_equal(parity.f64_from_bits(hi, lo).numpy(), vals)


def test_bit_length():
    x = np.asarray([0, 1, 2, 3, 255, 256, 2**31 - 1, 2**31, 2**32 - 1])
    got = mt19937._bit_length32(_t(x)).numpy()
    assert got.tolist() == [int(v).bit_length() for v in x]


def test_device_streams_equal_host_streams():
    """700 draws cross two twists; equal to the JAX package's host streams
    (numpy RandomState or its native generator) and to the port's."""
    hi, lo = mt19937.device_streams(SEEDS, 700, "cpu")
    jhi, jlo = jparity.gen_streams(SEEDS, 700)
    assert np.array_equal(hi.numpy(), jhi.astype(np.int64))
    assert np.array_equal(lo.numpy(), jlo.astype(np.int64))
    phi, plo = parity.gen_streams(SEEDS, 700, "cpu")
    assert torch.equal(hi, phi) and torch.equal(lo, plo)


@pytest.mark.parametrize("n", [0, 1, 312, 313])
def test_device_streams_lengths(n):
    hi, lo = mt19937.device_streams([5, 9], n, "cpu")
    assert hi.shape == lo.shape == (2, n)
    want = np.stack([np.random.RandomState(s).random_sample(n)
                     for s in (5, 9)])
    assert np.array_equal(parity.f64_from_bits(hi, lo).numpy(), want)


def test_golden_stream_heads():
    with open(os.path.join(os.path.dirname(__file__), "golden",
                           "reference_golden.json")) as f:
        heads = json.load(f)["mt19937_streams"]
    seeds = sorted(int(s) for s in heads)
    n = max(len(v) for v in heads.values())
    u = parity.f64_from_bits(*mt19937.device_streams(seeds, n, "cpu"))
    for i, s in enumerate(seeds):
        want = heads[str(s)]
        got = [np.float64(x).tobytes().hex() for x in u[i, :len(want)].numpy()]
        assert got == want, s
