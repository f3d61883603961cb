"""Threefry-2x32 in integer tensors: the counterpart of the `jax.random` calls
the fused trainer makes (hibag_tpu/models/train_fused.py:167-170, :590-591).

Bitwise equal to jax's threefry2x32 PRNG with ``jax_threefry_partitionable``
on (the default of the jax releases the reference runs on): a key is two
uint32 words, ``split`` hashes the counters (0, i), and the 32 random bits at
position i of a draw are the XOR of the two words hashed from (0, i). Words
are held in int64 tensors masked to 32 bits, so the same code runs on the CPU
and on a CUDA device.

``gumbel`` follows jax's ``mode="low"`` formula. Its two float32 logs are
the device's: each is within an ulp of jax's, but the outer log magnifies
the inner one's last bit where -log(u) is near 1, so a value can differ from
jax's by some tens of ulps. The candidate draw therefore never takes a log:
-log(-log(u)) is strictly increasing in u, so the top-k of the Gumbel scores
is the top-k of the uniforms' 23 random bits, which are bitwise jax's.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter pair (x0, x1) under the key
    (k0, k1); all int64 tensors of 32-bit words that broadcast together.
    Returns the two hashed words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """jax.random.PRNGKey(seed) for a 32-bit seed: int64 [2] = (0, seed)."""
    if not -2**31 <= seed < 2**31:
        raise ValueError(f"seed {seed} is outside the 32-bit range")
    return torch.tensor([0, seed & _M32], dtype=torch.int64, device=device)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split over a batch: keys int64 [..., 2] -> [..., num, 2]."""
    k0, k1 = keys[..., 0:1], keys[..., 1:2]
    ctr = torch.arange(num, dtype=torch.int64, device=keys.device)
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(ctr), ctr)
    return torch.stack([b0, b1], dim=-1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """32-bit random words of jax.random.bits(key, (n,)) for each key:
    keys int64 [..., 2] -> int64 [..., n] in [0, 2^32)."""
    k0, k1 = keys[..., 0:1], keys[..., 1:2]
    ctr = torch.arange(n, dtype=torch.int64, device=keys.device)
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(ctr), ctr)
    return b0 ^ b1


def uniform_low(keys: torch.Tensor, n: int) -> torch.Tensor:
    """jax.random.uniform(key, (n,), minval=tiny, maxval=1.) in float32."""
    bits = (random_bits(keys, n) >> 9) | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    one = torch.tensor(1.0, dtype=torch.float32, device=keys.device)
    tiny = torch.tensor(_TINY, dtype=torch.float32, device=keys.device)
    return torch.maximum(tiny, f * (one - tiny) + tiny)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """jax.random.gumbel(key, (n,)) for each key: float32 [..., n]."""
    return -torch.log(-torch.log(uniform_low(keys, n)))


def draw_top_k(keys: torch.Tensor, pool: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of jax.lax.top_k(where(pool, gumbel(key, (P,)), -inf), k) for
    each key: keys int64 [..., 2], pool bool [..., P] -> int64 [..., k].

    Ranks by the uniform's mantissa bits (see the module docstring). Equal
    values come in ascending index order, as top_k gives them: a stable
    descending sort, since torch.topk promises no order among ties. Slots
    outside the pool rank below every slot in it."""
    P = pool.shape[-1]
    score = torch.where(pool, random_bits(keys, P) >> 9, -1)
    order = torch.sort(score, dim=-1, descending=True, stable=True).indices
    return order[..., :k]
