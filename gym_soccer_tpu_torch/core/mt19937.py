"""MT19937, the reference's RNG, on tensors: many independent per-instance
generators as one [B, 624] state tensor.

The port of gym_soccer_tpu/core/mt19937.py, bit for bit:

* seeding is Knuth's init_genrand recurrence (what numpy's legacy
  RandomState uses for integer seeds), 623 steps vectorized over instances;
* the twist is the 3-phase vectorized form of the in-place loop (the last
  M entries of the loop read already-updated words, so the phases split at
  the dependency boundaries);
* ``random_sample`` doubles are (a>>5)*2**26 + (b>>6) over 2**53, returned
  as the IEEE-754 bit pattern's (hi, lo) words, built with integer ops.

uint32 values are held in int64 tensors masked to 32 bits, because PyTorch
has no uint32 shift or multiply on the CPU.  The CUDA parity kernel
(ops/csrc/parity_kernel.cu) seeds and twists its generators itself.
"""
from __future__ import annotations

import torch

N = 624
M = 397
MATRIX_A = 0x9908B0DF
UPPER = 0x80000000
LOWER = 0x7FFFFFFF
M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """(x * c) mod 2**32 for a uint32 ``x`` and constant ``c``; ``c`` is
    split into 16-bit halves so every partial product stays below 2**48."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def seed_states(seeds: torch.Tensor) -> torch.Tensor:
    """[B] seeds (taken mod 2**32) -> [B, 624] MT states (init_genrand),
    int64 holding uint32, on the seeds' device."""
    prev = seeds.to(torch.int64) & M32
    mt = torch.empty((N, prev.shape[0]), dtype=torch.int64,
                     device=prev.device)
    mt[0] = prev
    for i in range(1, N):
        prev = (_mul32(prev ^ (prev >> 30), 1812433253) + i) & M32
        mt[i] = prev
    return mt.T.contiguous()


def twist(mt: torch.Tensor) -> torch.Tensor:
    """One full twist of [B, 624] states, matching the in-place loop's
    read-after-write pattern exactly."""
    def mix(cur, nxt, src):
        y = (cur & UPPER) | (nxt & LOWER)
        return src ^ (y >> 1) ^ ((y & 1) * MATRIX_A)

    # The in-place loop reads mt[(k+M) % N], which for k >= N-M is an
    # ALREADY-UPDATED word new[k-(N-M)]: lag N-M = 227, so the 624 updates
    # split into phases that each read only finished words.
    K = N - M  # 227
    p1 = mix(mt[:, 0:K], mt[:, 1:K + 1], mt[:, M:N])
    p2a = mix(mt[:, K:2 * K], mt[:, K + 1:2 * K + 1], p1)
    p2b = mix(mt[:, 2 * K:N - 1], mt[:, 2 * K + 1:N],
              p2a[:, 0:N - 1 - 2 * K])
    # k = N-1: the neighbour is the NEW mt[0] (= p1[0]), the source the
    # NEW mt[M-1] (= p2a[M-1-K])
    p3 = mix(mt[:, N - 1:N], p1[:, 0:1], p2a[:, M - 1 - K:M - K])
    return torch.cat([p1, p2a, p2b, p3], dim=1)


def temper(y: torch.Tensor) -> torch.Tensor:
    y = y ^ (y >> 11)
    y = y ^ ((y << 7) & 0x9D2C5680)
    y = y ^ ((y << 15) & 0xEFC60000)
    return y ^ (y >> 18)


def _bit_length32(x: torch.Tensor) -> torch.Tensor:
    """Branchless bit length of uint32 values (0 -> 0), int64."""
    n = torch.zeros_like(x)
    for shift in (16, 8, 4, 2, 1):
        big = x >= (1 << shift)
        n = n + big * shift
        x = torch.where(big, x >> shift, x)
    return n + (x > 0).to(torch.int64)


def double_bits(a: torch.Tensor, b: torch.Tensor):
    """(hi, lo) uint32 bit-pattern words (int64) of (a*2**26 + b) / 2**53,
    where a < 2**27 (one word >> 5) and b < 2**26 (the next word >> 6):
    numpy's random_sample double, assembled with integer ops."""
    # 53-bit mantissa m = (a << 26) | b, split into 32-bit words
    m_hi = a >> 6
    m_lo = ((a << 26) | b) & M32
    nbits = torch.where(m_hi > 0, 32 + _bit_length32(m_hi),
                        _bit_length32(m_lo))
    zero = (m_hi == 0) & (m_lo == 0)

    # left-shift m by s = 53 - nbits so the leading bit lands at bit 52
    s = 53 - nbits
    big = s >= 32
    s_lo = torch.where(big, 0, s)
    s_hi = torch.where(big, s - 32, 0)
    hi1 = torch.where(s_lo > 0,
                      ((m_hi << s_lo) | (m_lo >> (32 - s_lo))) & M32, m_hi)
    lo1 = (m_lo << s_lo) & M32
    hi2 = torch.where(big, (lo1 << s_hi) & M32, hi1)
    lo2 = torch.where(big, 0, lo1)

    # drop the implicit leading bit (bit 52 = bit 20 of the hi word)
    frac_hi = hi2 & 0x000FFFFF
    exponent = 969 + nbits
    hi = torch.where(zero, 0, (exponent << 20) | frac_hi)
    lo = torch.where(zero, 0, lo2)
    return hi, lo


def device_streams(seeds, n_draws: int, device):
    """Per-instance uniform streams as (hi, lo) uint32 words held in int64,
    [B, n_draws] each, on ``device``: bit-identical to numpy's
    ``RandomState(seeds[i]).random_sample(n_draws)``.  Each twist yields
    312 doubles."""
    seeds = torch.as_tensor(seeds, device=device)
    mt = seed_states(seeds)
    his, los = [], []
    for _ in range(-(-n_draws // (N // 2))):
        mt = twist(mt)
        words = temper(mt)
        hi, lo = double_bits(words[:, 0::2] >> 5, words[:, 1::2] >> 6)
        his.append(hi)
        los.append(lo)
    B = seeds.shape[0]
    empty = torch.empty((B, 0), dtype=torch.int64, device=mt.device)
    hi = torch.cat(his, dim=1)[:, :n_draws] if his else empty
    lo = torch.cat(los, dim=1)[:, :n_draws] if los else empty
    return hi, lo
