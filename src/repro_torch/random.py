"""``jax.random``'s threefry2x32 PRNG in PyTorch, word for word.

Reproduces JAX's default PRNG under ``jax_threefry_partitionable=True`` (the
default of JAX 0.9) so that the port draws the same stochastic-rounding
uniforms as the reference, key for key:

* a key is a ``(2,)`` int64 CPU tensor holding two uint32 words;
* ``PRNGKey(seed)`` = ``[0, seed & 0xFFFFFFFF]`` for 32-bit seeds;
* ``fold_in(key, d)`` hashes the count pair ``(0, d)`` under ``key``;
* ``split(key, n)`` hashes the counts ``(0, i)``, i < n, and returns (n, 2);
* ``bits(key, shape)`` hashes the 64-bit flat index ``(hi, lo)`` of each
  element and returns ``out1 ^ out2``;
* ``uniform(key, shape)`` puts the top 23 bits of ``bits`` into the mantissa
  of a float in [1, 2) and subtracts 1 (the float32 path of ``jax.random``).

uint32 arithmetic is emulated in int64 with ``& 0xFFFFFFFF``. Large draws are
made in chunks of ``_CHUNK`` elements on the requested device, which bounds
the int64 temporaries (the LOFAR Φ̂ draw is 2 × 57M uniforms).
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_CHUNK = 1 << 22

Shape = Union[int, Sequence[int]]


def _key_words(key: torch.Tensor) -> tuple[int, int]:
    if key.shape != (2,):
        raise ValueError(f"a PRNG key is a (2,) tensor of uint32 words, got shape {tuple(key.shape)}")
    return int(key[0]) & _M32, int(key[1]) & _M32


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32(k1: int, k2: int, x1: torch.Tensor, x2: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of the count pairs ``(x1, x2)``,
    int64 tensors holding uint32 values, under the key words ``(k1, k2)``."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for r in range(5):
        for d in _ROTATIONS[r % 2]:
            x1 = (x1 + x2) & _M32
            x2 = x1 ^ _rotl(x2, d)
        x1 = (x1 + ks[(r + 1) % 3]) & _M32
        x2 = (x2 + ks[(r + 2) % 3] + r + 1) & _M32
    return x1, x2


def _as_key(k1: int, k2: int) -> torch.Tensor:
    return torch.tensor([k1, k2], dtype=torch.int64)


def PRNGKey(seed: int) -> torch.Tensor:  # noqa: N802 -- jax.random's spelling
    """Key from a 32-bit integer seed, as ``jax.random.PRNGKey``."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 32):
        raise ValueError(f"seed must fit 32 bits, got {seed}")
    return _as_key(0, seed & _M32)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """New key from ``key`` and an integer, as ``jax.random.fold_in``."""
    k1, k2 = _key_words(key)
    o1, o2 = threefry2x32(k1, k2, torch.zeros(1, dtype=torch.int64),
                          torch.tensor([int(data) & _M32], dtype=torch.int64))
    return _as_key(int(o1[0]), int(o2[0]))


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """(num, 2) new keys, as ``jax.random.split``."""
    k1, k2 = _key_words(key)
    o1, o2 = threefry2x32(k1, k2, torch.zeros(num, dtype=torch.int64),
                          torch.arange(num, dtype=torch.int64))
    return torch.stack([o1, o2], dim=1)


def _shape(shape: Shape) -> tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(int(d) for d in shape)


def _bits_flat(key: torch.Tensor, start: int, stop: int, device) -> torch.Tensor:
    k1, k2 = _key_words(key)
    idx = torch.arange(start, stop, dtype=torch.int64, device=device)
    o1, o2 = threefry2x32(k1, k2, idx >> 32, idx & _M32)
    return o1 ^ o2


def bits(key: torch.Tensor, shape: Shape, device=None) -> torch.Tensor:
    """uint32 random words (held in int64), as ``jax.random.bits(key, shape,
    jnp.uint32)``."""
    shp = _shape(shape)
    n = math.prod(shp)
    out = torch.empty(n, dtype=torch.int64, device=device)
    for s in range(0, n, _CHUNK):
        out[s:s + _CHUNK] = _bits_flat(key, s, min(n, s + _CHUNK), device)
    return out.view(shp)


def uniform(key: torch.Tensor, shape: Shape, device=None) -> torch.Tensor:
    """float32 uniforms in [0, 1), as ``jax.random.uniform(key, shape)``."""
    shp = _shape(shape)
    n = math.prod(shp)
    out = torch.empty(n, dtype=torch.float32, device=device)
    for s in range(0, n, _CHUNK):
        b = _bits_flat(key, s, min(n, s + _CHUNK), device)
        mant = ((b >> 9) | 0x3F800000).to(torch.int32)
        out[s:s + _CHUNK] = mant.view(torch.float32) - 1.0
    return out.view(shp)
