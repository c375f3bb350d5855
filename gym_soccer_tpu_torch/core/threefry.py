"""The threefry2x32 generator of ``jax.random``, on PyTorch tensors.

The JAX package draws its default randomness from ``jax.random`` with the
threefry2x32 implementation (JAX 0.9.0, ``jax_threefry_partitionable``
on, the default there).  This module computes the same numbers bit for
bit:

* A key is two uint32 words, held in int64 as the rest of the port holds
  uint32: a tensor ``[..., 2]``, the words ``jax.random.key_data`` gives.
  ``key_data`` and ``wrap_key_data`` are identities on it.
* ``key(seed)`` keeps the seed's low 32 bits as the second word and 0 as
  the first, as ``jax.random.key`` does without x64.
* ``threefry2x32`` is the 20-round hash of a counter pair under a key.
* ``fold_in(k, d)`` hashes the pair (0, d); ``split(k, shape)`` and
  ``random_bits(k, shape)`` hash the pairs (hi, lo) of the flat index of
  each element (``iota_2x32_shape``): a split key is the two output
  words, 32 random bits are their xor.
* ``uniform`` puts 23 random bits under the exponent of 1.0 and subtracts
  1.0; ``randint`` draws two sets of bits from a split key and reduces
  them with ``jax.random.randint``'s span and multiplier.

Every function takes keys with leading batch dimensions (JAX's under
``vmap``) and runs where its key tensor lies.  On CUDA tensors the port
draws through kernels instead: ``per_env_uniforms`` of core/batch and the
single-key draws of ``threefry_kernel.keyed_uniform`` / ``keyed_randint``
through T1 (ops/threefry_kernel), the engine's step through S1
(ops/engine_kernel).
"""
from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
# Rotation constants of the two alternating groups of four rounds, and the
# key schedule's parity constant (Salmon et al. 2011; jax/_src/prng.py).
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA


def key(seed, device=None) -> torch.Tensor:
    """The key of an integer seed (or an array of seeds, giving a key per
    seed): int64 ``[..., 2]`` = (0, seed mod 2**32)."""
    lo = torch.as_tensor(np.asarray(seed).astype(np.int64) & M32,
                         device=device)
    return torch.stack([torch.zeros_like(lo), lo], dim=-1)


def key_data(k: torch.Tensor) -> torch.Tensor:
    """A key's two uint32 words: the key itself in this port."""
    return k


def wrap_key_data(words, device=None) -> torch.Tensor:
    """A key from its two uint32 words ``[..., 2]`` (e.g. a JAX key's
    ``key_data`` as numpy): int64 on ``device``."""
    if isinstance(words, torch.Tensor):
        return words.to(device=device or words.device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(words).astype(np.int64), device=device)


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds of the counter pair (x0, x1) under the
    key (k0, k1); int64 tensors holding uint32 values, broadcast together.
    Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the key hashed with the pair (0, data), for
    keys ``[..., 2]`` and data (an int, taken as a host constant, or an
    integer tensor) broadcast against the keys' batch dimensions."""
    if isinstance(data, (int, np.integer)):
        zero, d = 0, int(data) & M32
    else:
        d = torch.as_tensor(data, device=k.device).to(torch.int64) & M32
        zero = torch.zeros_like(d)
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], zero, d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def _shape(shape) -> tuple:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _hash_iota(k: torch.Tensor, shape):
    """The output pair of each element's flat index (hi, lo) under keys
    ``[..., 2]``: two int64 tensors of shape ``k.shape[:-1] + shape``."""
    shape = _shape(shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=k.device)
    lead = k.shape[:-1]
    k0 = k[..., 0].reshape(*lead, 1)
    k1 = k[..., 1].reshape(*lead, 1)
    y0, y1 = threefry2x32(k0, k1, idx >> 32, idx & M32)
    return y0.reshape(*lead, *shape), y1.reshape(*lead, *shape)


def split(k: torch.Tensor, num=2) -> torch.Tensor:
    """``jax.random.split``: keys ``[..., *shape, 2]`` (``num`` an int or a
    shape tuple)."""
    y0, y1 = _hash_iota(k, num)
    return torch.stack([y0, y1], dim=-1)


def random_bits(k: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits`` of 32 bits: uint32 values in int64, shape
    ``k.shape[:-1] + shape``."""
    y0, y1 = _hash_iota(k, shape)
    return y0 ^ y1


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1) from 32 random bits: the top 23 as the mantissa
    of a number in [1, 2), minus 1 (exact)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(k: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.uniform(k, shape)`` in float32 on [0, 1)."""
    return bits_to_uniform(random_bits(k, shape))


def _mul32(x, c: int):
    """(x * c) mod 2**32 for uint32 ``x`` (int64) and an int ``c`` < 2**32,
    with every partial product below 2**48."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def randint_span(minval: int, maxval: int) -> tuple[int, int]:
    """``randint``'s span and multiplier (2**32 mod span) of the int32
    bounds [minval, maxval)."""
    if not (-2 ** 31 <= minval < 2 ** 31 and -2 ** 31 <= maxval < 2 ** 31):
        raise ValueError(f"randint bounds [{minval}, {maxval}) must be int32")
    span = (maxval - minval) & M32 if maxval > minval else 1
    multiplier = (2 ** 16) % span
    return span, ((multiplier * multiplier) & M32) % span


def randint(k: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(k, shape, minval, maxval)`` with int32 output:
    two sets of 32 random bits from ``split(k)``, each reduced modulo the
    span, joined by the multiplier 2**32 mod span."""
    span, multiplier = randint_span(minval, maxval)
    keys = split(k)
    higher = random_bits(keys[..., 0, :], shape)
    lower = random_bits(keys[..., 1, :], shape)
    offset = (_mul32(higher % span, multiplier) + lower % span) & M32
    offset = offset % span
    return ((minval + offset) & M32).to(torch.int32)
