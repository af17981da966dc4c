"""The plain twin of ``csrc/counter_rng.cuh``: Philox4x32-10 random bits
keyed by (seed, flat element index), in torch int64 ops.

Element ``i`` takes word ``i % 4`` of the Philox block for counter
``(i // 4, 0)`` and key ``(seed & 0xffffffff, seed >> 32)``, so the bits
of an element do not depend on how a kernel's launch splits the work, and
:func:`random_bits` returns the bits the stochastic-pool and dropout
kernels draw.  A 32 x 32-bit product is below 2**64, so int64's
wraparound keeps it exact modulo 2**64 and both 32-bit halves come back
with a shift and a mask.

The TPU kernels drew from the TPU's hardware PRNG, which no GPU can
reproduce: parity with the JAX package goes through the ``bits=``
operand both kernels take.
"""

from __future__ import annotations

import torch

#: Philox4x32 multipliers and key bumps (Salmon et al., SC 2011)
M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK32 = 0xFFFFFFFF
#: a seed is any int in [0, 2**64)
SEED_LIMIT = 1 << 64


def philox4x32_10(c0, c1, c2, c3, seed: int) -> tuple:
    """The four output words of Philox4x32-10 for int64 counter tensors
    ``c0..c3`` holding values in [0, 2**32), each an int64 tensor of the
    same values range."""
    k0, k1 = seed & MASK32, (seed >> 32) & MASK32
    for r in range(10):
        if r:
            k0, k1 = (k0 + W0) & MASK32, (k1 + W1) & MASK32
        p0, p1 = c0 * M0, c2 * M1          # exact modulo 2**64
        hi0, lo0 = (p0 >> 32) & MASK32, p0 & MASK32
        hi1, lo1 = (p1 >> 32) & MASK32, p1 & MASK32
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def check_seed(seed) -> int:
    seed = int(seed)
    if not 0 <= seed < SEED_LIMIT:
        raise ValueError(f"seed {seed} is outside [0, 2**64)")
    return seed


def random_bits(seed: int, n: int, device="cpu") -> torch.Tensor:
    """The ``n`` uint32 words for flat indices ``0 .. n-1`` under ``seed``,
    as an int64 tensor of values in [0, 2**32)."""
    seed = check_seed(seed)
    groups = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    zero = torch.zeros_like(groups)
    words = philox4x32_10(groups & MASK32, groups >> 32, zero, zero, seed)
    return torch.stack(words, dim=1).reshape(-1)[:n]


def as_words(bits) -> torch.Tensor:
    """uint32 (or int32) ``bits`` as int64 values in [0, 2**32)."""
    if bits.dtype not in (torch.uint32, torch.int32):
        raise ValueError(f"bits must be uint32 (or int32), not {bits.dtype}")
    return bits.view(torch.int32).to(torch.int64) & MASK32


def uniform24(words) -> torch.Tensor:
    """f32 uniforms in [0, 1) from the top 24 bits of int64 ``words``,
    exact (the TPU kernels' ``(bits >> 8) * 2**-24``)."""
    return (words >> 8).to(torch.float32) * (2.0 ** -24)
