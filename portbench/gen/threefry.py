"""Threefry-2x32 in integer tensors, bitwise jax's threefry2x32 PRNG with
``jax_threefry_partitionable`` on: a frozen copy of
``hibag_tpu_torch/utils/threefry.py``, which the fused trainer draws its
candidate SNPs with. The reference redraws the candidates with this copy.

A key is two uint32 words; ``split`` hashes the counters (0, i); the 32
random bits at position i of a draw are the XOR of the two words hashed
from (0, i). Words are held in int64 tensors masked to 32 bits. The
candidate draw ranks the uniforms' 23 random bits, as the Gumbel top-k
does (the Gumbel transform is strictly increasing).
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


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
