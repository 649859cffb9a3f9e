"""The parts of ``jax.random`` that the device envs and Anakin's acting draw
from, in torch, bitwise equal to jax's default PRNG (``threefry2x32`` with
``jax_threefry_partitionable=True``, the default since jax 0.5).

A key is an int64 tensor ``[..., 2]`` holding the two uint32 words (torch's
uint32 lacks operators on some backends, so the words live in int64 and
every step masks with ``& 0xFFFFFFFF``). Every function takes any leading
batch shape, as ``vmap`` over the jax function does:

- ``prng_key(seed)``        — ``jax.random.PRNGKey(seed)`` (an int32 seed);
- ``split(key, n)``         — ``jax.random.split(key, n)`` → ``[..., n, 2]``;
- ``fold_in(key, data)``    — ``jax.random.fold_in(key, data)``;
- ``uniform(key)``          — scalar ``jax.random.uniform(key)`` (float32);
- ``uniforms(key, n)``      — ``jax.random.uniform(key, (n,))``, ``[..., n]``
  (the fused samplers' draws); ``uniforms_host`` the same from numpy
  keys, computed by numpy on the host;
- ``randint(key, lo, hi)``  — scalar ``jax.random.randint(key, (), lo, hi)``
  (int32), with jax's two-draw construction.

This is plain tensor arithmetic, not a kernel: the reference leaves this
work to XLA. One hash is 20 rounds of a few elementwise ops each; the hash
uses only operators numpy arrays share, so ``uniforms_host`` runs it on
numpy int64 arrays.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the counter pair ``(x0, x1)``
    under the key ``(k0, k1)``; all int64 tensors (or all int64 numpy
    arrays) holding uint32 words, broadcast together. Returns the two
    output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    a = (x0 + ks[0]) & _M32
    b = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            a = (a + b) & _M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _M32
    return a, b


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for an int32 seed: ``[0, seed mod 2³²]``
    (the high word is the seed's upper 32 bits, zero for an int32)."""
    seed = int(seed)
    if not -2**31 <= seed < 2**31:
        raise ValueError(f"seed {seed} does not fit an int32")
    return torch.tensor([0, seed & _M32], dtype=torch.int64, device=device)


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)``: key ``[..., 2]`` → ``[..., n, 2]``,
    the hash of the counters ``(0, i)`` for i < n."""
    k0, k1 = key[..., 0, None], key[..., 1, None]
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    a, b = threefry2x32(k0, k1, torch.zeros_like(i), i)
    return torch.stack([a, b], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the hash of the counters
    ``(0, data mod 2³²)``. ``data`` is an int or an integer tensor that
    broadcasts against the key's batch shape."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _M32
    a, b = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([a, b], dim=-1)


def random_bits(key: torch.Tensor) -> torch.Tensor:
    """One 32-bit draw per key (``random_bits(key, 32, ())``): the two
    output words of the hash of the counters ``(0, 0)``, xored."""
    z = torch.zeros_like(key[..., 0])
    a, b = threefry2x32(key[..., 0], key[..., 1], z, z)
    return a ^ b


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """32 random bits → float32 in [0, 1): the top 23 bits as the mantissa
    of a float in [1, 2), minus 1 (jax's ``_uniform`` for float32)."""
    bits = (bits >> 9) | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp(f, min=0.0)


def uniform(key: torch.Tensor) -> torch.Tensor:
    """Scalar ``jax.random.uniform(key)`` per key (float32 in [0, 1))."""
    return _bits_to_unit(random_bits(key))


def uniforms(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.uniform(key, (n,))`` per key: ``[..., 2]`` → ``[..., n]``
    float32. Draw i hashes the counters ``(0, i)`` and xors the two output
    words: the partitionable layout's ``iota_2x32_shape`` for a 1-D shape,
    whose high counter word is 0 below 2³² draws."""
    i = torch.arange(int(n), dtype=torch.int64, device=key.device)
    a, b = threefry2x32(key[..., 0, None], key[..., 1, None],
                        torch.zeros_like(i), i)
    return _bits_to_unit(a ^ b)


def uniforms_host(key: np.ndarray, n: int) -> np.ndarray:
    """``uniforms`` for numpy keys (``[..., 2]``, uint32 words), computed by
    numpy on the host: the same hash and mantissa step, bit for bit.
    Returns float32 ``[..., n]``."""
    k = np.asarray(key).astype(np.int64)
    i = np.arange(int(n), dtype=np.int64)
    a, b = threefry2x32(k[..., 0, None], k[..., 1, None], np.zeros_like(i),
                        i)
    bits = ((a ^ b) >> 9) | 0x3F800000
    f = bits.astype(np.int32).view(np.float32) - np.float32(1.0)
    return np.maximum(f, np.float32(0.0))


def randint(key: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Scalar ``jax.random.randint(key, (), lo, hi, int32)`` per key: split
    the key in two, one 32-bit draw from each (high, low), and
    ``(high % span · (2¹⁶ % span)² % span + low % span) % span`` in uint32
    arithmetic, plus ``lo``."""
    lo, hi = int(lo), int(hi)
    span = max(hi - lo, 1) & _M32
    mult = (((2**16 % span) ** 2) & _M32) % span   # uint32 product wraps
    k = split(key, 2)
    high, low = random_bits(k[..., 0, :]), random_bits(k[..., 1, :])
    off = ((high % span) * mult) & _M32
    off = (off + low % span) & _M32
    return (lo + off % span).to(torch.int32)
