"""JAX's threefry2x32 PRNG in torch int64 ops: the keys, bits, uniforms and
Gumbel noise that ``jax.random`` gives with its default implementation
(``jax_default_prng_impl = threefry2x32``) and partitionable key splitting
(``jax_threefry_partitionable = True``).

Counterpart of jax/_src/prng.py (``threefry_2x32``, ``threefry_seed``,
``_threefry_split_foldlike``, ``threefry_fold_in``,
``_threefry_random_bits_partitionable``) and jax/_src/random.py
(``_uniform``, ``_gumbel`` in its default "low" mode), so that the port's
Viterbi draws equal the JAX package's.  A key is a pair (k0, k1) of 32-bit
words; every function takes Python ints or int64 tensors holding values in
[0, 2^32) and broadcasts like an elementwise op.  csrc/viterbi_gumbel.cu
computes the same words in uint32 arithmetic.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
# threefry2x32's rotation schedule, the first set for rounds 1-4, 9-12 and
# 17-20, the second for rounds 5-8 and 13-16, and its key-schedule parity
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """The 20-round Threefry-2x32 block cipher of the counter (x0, x1)
    under the key (k0, k1): (y0, y1), each in [0, 2^32).  The key schedule
    is (k0, k1, k0 ^ k1 ^ PARITY), injected after every 4 rounds with the
    injection's count added to the second word."""
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for n in range(5):
        for r in ROTATIONS[n % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(n + 1) % 3]) & M32
        x1 = (x1 + ks[(n + 2) % 3] + n + 1) & M32
    return x0, x1


def prng_key(seed: int):
    """``jax.random.PRNGKey(seed)``'s words: (seed >> 32, seed & M32) of the
    seed's 64-bit two's complement, as JAX takes a seed with
    ``jax_enable_x64``; for 0 <= seed < 2^31 that is (0, seed) either way."""
    return (seed >> 32) & M32, seed & M32


def split(key, n: int, device=None):
    """``jax.random.split(key, n)``: key k is threefry2x32(key, (0, k));
    two int64 tensors [n]."""
    k = torch.arange(n, dtype=torch.int64, device=device)
    return threefry2x32(key[0], key[1], torch.zeros_like(k), k)


def fold_in(key, data):
    """``jax.random.fold_in(key, data)``: threefry2x32(key, (0, data)),
    data taken mod 2^32."""
    return threefry2x32(key[0], key[1], 0, data & M32)


def random_bits(key, n: int, dtype):
    """The bits ``jax.random.uniform(key, (n,), dtype)`` draws from: for
    counter j, (y0, y1) = threefry2x32(key, (0, j)), and the float's fraction
    bits, y0 ^ y1 >> 9 (f32: 23 bits) or (y0 << 32 | y1) >> 12 (f64: 52
    bits, built as y0 << 20 | y1 >> 12 so that no int64 overflows).  key
    words broadcast against the trailing counter axis: [..., 1] gives
    [..., n] int64."""
    j = torch.arange(n, dtype=torch.int64, device=getattr(key[0], "device",
                                                          None))
    y0, y1 = threefry2x32(key[0], key[1], torch.zeros_like(j), j)
    if dtype == torch.float32:
        return (y0 ^ y1) >> 9
    if dtype == torch.float64:
        return (y0 << 20) | (y1 >> 12)
    raise ValueError(f"random_bits: dtype {dtype}")


def uniform(key, n: int, dtype):
    """``jax.random.uniform(key, (n,), dtype, minval=tiny, maxval=1.)``, the
    uniforms of ``jax.random.gumbel``: the fraction bits m as 1.m - 1 = m /
    2^p (exact), times (1 - tiny) plus tiny, at least tiny (tiny the
    dtype's least normal number)."""
    p = 23 if dtype == torch.float32 else 52
    f = random_bits(key, n, dtype).to(dtype) * 2.0 ** -p
    tiny = torch.finfo(dtype).tiny
    return torch.clamp(f * (1.0 - tiny) + tiny, min=tiny)


def gumbel(key, n: int, dtype):
    """``jax.random.gumbel(key, (n,), dtype)``: -log(-log(u)) of
    ``uniform``."""
    return -torch.log(-torch.log(uniform(key, n, dtype)))
