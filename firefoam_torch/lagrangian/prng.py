"""The counter-based random generator of the spray cloud: threefry2x32.

The cloud draws every random number (injection directions, diameters,
bins, collector thinning) from an explicit key carried in its state, so a
run is reproducible and a resumed run draws what the uninterrupted one
would have drawn. The generator is JAX's default one, reproduced bit for
bit (threefry2x32 in its *partitionable* form, JAX >= 0.5 defaults), so
the port and the JAX package draw the same numbers from the same key:

  * a key is a [2] uint32 tensor on the host, as JAX holds it (torch's
    uint32 arithmetic is thin, so the hash works on int64 with 32-bit
    masks);
  * `split(key, n)` hashes the counters 0..n-1 (as two 32-bit halves of a
    64-bit iota) under the key, [n, 2];
  * `random_bits` hashes the flat counters of the shape: 32 bits are
    b1 ^ b2, 64 bits are (b1 << 32) | b2;
  * `uniform` fills the mantissa of a float in [1, 2) and subtracts 1,
    then max(minval, u·(maxval − minval) + minval), the product and sum
    fused into one rounding (XLA's CPU backend contracts them to an FMA);
  * `normal` is √2·erfinv(uniform(nextafter(−1, 0), 1));
  * `randint` draws two 64-bit arrays (the sampler's int64 width) from a
    split key and folds them by the span.

A key's chain does not depend on the data, so keys stay on the host: a
split is hashed in Python, and draws are made on the device asked for with
the key's words as constants, with no device launch for a split and no
host read.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["PRNGKey", "split", "random_bits", "uniform", "normal", "randint"]

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
Shape = Union[int, Sequence[int]]


def PRNGKey(seed: int) -> torch.Tensor:
    """The key of an integer seed: (seed >> 32, seed & 0xFFFFFFFF)."""
    s = int(seed) & ((1 << 64) - 1)
    return torch.tensor([(s >> 32) & _M32, s & _M32], dtype=torch.uint32)


def _rotl(v, r):
    return ((v << r) | (v >> (32 - r))) & _M32


def _threefry2x32(k1: int, k2: int, x0, x1):
    """The threefry2x32 hash of the counter pairs (x0, x1) under (k1, k2):
    20 rounds, key injection every 4 (the unrolled form of JAX's lowering).
    The counters are Python ints or int64 tensors."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _key_words(key: torch.Tensor) -> Tuple[int, int]:
    k1, k2 = (int(v) for v in key.tolist())
    return k1, k2


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, (int, np.integer)) else tuple(int(s) for s in shape)


def _hash_iota(key: torch.Tensor, shape: Tuple[int, ...], device=None):
    n = math.prod(shape)
    i = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = _threefry2x32(*_key_words(key), i >> 32, i & _M32)
    return b1.reshape(shape), b2.reshape(shape)


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """[n, 2] new keys (jax.random.split)."""
    k1, k2 = _key_words(key)
    return torch.tensor([_threefry2x32(k1, k2, 0, i) for i in range(int(n))],
                        dtype=torch.uint32)


def random_bits(key: torch.Tensor, bit_width: int, shape: Shape, device=None):
    """32-bit draws as int64 in [0, 2^32); 64-bit draws as the (hi, lo)
    32-bit halves (int64 cannot hold an unsigned 64-bit value). On
    `device` (default: the CPU)."""
    b1, b2 = _hash_iota(key, _shape(shape), device)
    if bit_width == 32:
        return b1 ^ b2
    if bit_width == 64:
        return b1, b2
    raise ValueError(f"bit_width {bit_width}: 32 or 64")


def uniform(key: torch.Tensor, shape: Shape, dtype=torch.float64, minval=0.0,
            maxval=1.0, device=None) -> torch.Tensor:
    """Uniform floats in [minval, maxval) (jax.random.uniform)."""
    shape = _shape(shape)
    if dtype == torch.float64:
        hi, lo = random_bits(key, 64, shape, device)
        # the top 52 of the 64 bits fill the mantissa of 1.x
        mant = ((hi << 20) | (lo >> 12)) | 0x3FF0000000000000
        floats = mant.view(torch.float64) - 1.0
    elif dtype == torch.float32:
        bits = random_bits(key, 32, shape, device)
        mant = (bits >> 9) | 0x3F800000
        floats = mant.to(torch.int32).view(torch.float32) - 1.0
    else:
        raise ValueError(f"uniform: dtype {dtype}")
    # minval, maxval and their difference rounded as `dtype` holds them;
    # filled on the card (a host-to-device copy would wait for it)
    npd = np.float64 if dtype == torch.float64 else np.float32
    mn, mx = npd(minval), npd(maxval)
    span = float(npd(mx - mn))
    out = torch.addcmul(torch.full_like(floats, float(mn)), floats, torch.full_like(floats, span))
    return torch.clamp(out, min=float(mn))


def normal(key: torch.Tensor, shape: Shape, dtype=torch.float64, device=None) -> torch.Tensor:
    """Standard normal draws (jax.random.normal: √2·erfinv(u))."""
    npd = np.float64 if dtype == torch.float64 else np.float32
    lo = float(np.nextafter(npd(-1.0), npd(0.0)))
    u = uniform(key, shape, dtype, lo, 1.0, device)
    return torch.erfinv(u) * float(npd(np.sqrt(2)))


def randint(key: torch.Tensor, shape: Shape, minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """Integers in [minval, maxval) as int64 (jax.random.randint with the
    int64 default dtype): two 64-bit draws folded by the span. The span
    must stay below 2^31 so every product fits in int64."""
    span = int(maxval) - int(minval)
    span = 1 if span <= 0 else span
    if span >= 1 << 31:
        raise ValueError(f"randint: span {span} >= 2^31")
    keys = split(key, 2)
    p32 = (1 << 32) % span  # 2^32 mod span
    mult = (p32 * p32) % span  # 2^64 mod span

    def mod64(k):
        h, l = random_bits(k, 64, shape, device)
        return ((h % span) * p32 + l % span) % span

    off = (mod64(keys[0]) * mult + mod64(keys[1])) % span
    return off + int(minval)
