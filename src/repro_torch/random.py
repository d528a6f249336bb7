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
* ``uniform(key, shape, minval, maxval)`` puts the top 23 bits of ``bits``
  into the mantissa of a float in [1, 2), subtracts 1 and maps [0, 1) onto
  [minval, maxval) as ``max(minval, u·(maxval − minval) + minval)``, the
  multiply-add rounded once, as XLA computes it (the float32 path of
  ``jax.random``);
* ``randint(key, shape, minval, maxval)`` splits the key, draws two words per
  element and folds them into the span with uint32 remainders (the int32
  path of ``jax.random.randint`` in JAX 0.9), bit for bit;
* ``normal(key, shape)`` is √2·erfinv(u) of a uniform u on (−1, 1), as
  ``jax.random.normal``, with XLA's float32 erfinv polynomial; the values
  agree with JAX's to within 1e-6 (the order of the polynomial's float
  operations is the only difference);
* ``bernoulli(key, p, shape)`` is ``uniform < p`` and ``rademacher(key,
  shape)`` is ``2·bernoulli(key, 0.5) − 1``, as in ``jax.random``;
* ``permutation(key, n)`` shuffles ``arange(n)`` as ``jax.random``'s
  ``_shuffle`` does: ⌈3·ln n / ln(2³² − 1)⌉ rounds, each splitting the key
  and sorting stably by fresh 32-bit words, bit for bit;
* ``choice(key, n, size)`` without replacement is ``permutation(key, n)[:size]``,
  as ``jax.random.choice(key, n, (size,), replace=False)`` computes it.

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


def uniform(key: torch.Tensor, shape: Shape, device=None, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 uniforms in [minval, maxval), as ``jax.random.uniform(key,
    shape, minval=minval, maxval=maxval)``."""
    shp = _shape(shape)
    n = math.prod(shp)
    out = torch.empty(n, dtype=torch.float32, device=device)
    for s in range(0, n, _CHUNK):
        b = _bits_flat(key, s, min(n, s + _CHUNK), device)
        mant = ((b >> 9) | 0x3F800000).to(torch.int32)
        out[s:s + _CHUNK] = mant.view(torch.float32) - 1.0
    if (minval, maxval) != (0.0, 1.0):
        # u·span + lo with one rounding, as XLA fuses it (a multiply-add):
        # the product of two float32 values is exact in float64
        lo = torch.tensor(minval, dtype=torch.float32, device=device)
        span = torch.tensor(maxval, dtype=torch.float32, device=device) - lo
        fused = (out.to(torch.float64) * span.to(torch.float64) + lo.to(torch.float64))
        out = torch.maximum(lo, fused.to(torch.float32))
    return out.view(shp)


def randint(key: torch.Tensor, shape: Shape, minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """int32 integers in [minval, maxval), as ``jax.random.randint(key, shape,
    minval, maxval)`` (int32, integer bounds): words ``hi`` and ``lo`` from the
    two halves of ``split(key)``, then ``((hi % span)·m + lo % span) % span``
    with m = ((2¹⁶ % span)² mod 2³²) % span, all in wrapping uint32
    arithmetic as JAX computes it."""
    minval, maxval = int(minval), int(maxval)
    for v in (minval, maxval):
        if not -(1 << 31) <= v < (1 << 31):
            raise OverflowError(f"randint bounds must fit int32, got {v}")
    span = (maxval - minval) if maxval > minval else 1
    k1, k2 = split(key)
    higher, lower = bits(k1, shape, device), bits(k2, shape, device)
    # (2¹⁶ % span)² wraps in uint32, as in JAX (to 0 for span > 2¹⁶)
    multiplier = ((((1 << 16) % span) ** 2) & _M32) % span
    offset = ((((higher % span) * multiplier) & _M32) + lower % span) & _M32
    offset = offset % span
    # uint32 → int32 is a reinterpretation, and the int32 add wraps
    value = (minval + offset) & _M32
    return torch.where(value >= (1 << 31), value - (1 << 32), value).to(torch.int32)


# XLA's float32 erfinv (M. Giles, "Approximating the erfinv function"): the
# polynomial in w = −log1p(−x²), one set of coefficients below w = 5, one above
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 erfinv as XLA computes it; log1p is taken in float64 and
    rounded, so the branch and w do not depend on the device's log1p."""
    w = (-torch.log1p(-(x * x).to(torch.float64))).to(torch.float32)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(lt, torch.tensor(_ERFINV_LT5[i], device=x.device),
                           torch.tensor(_ERFINV_GE5[i], device=x.device))

    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = coef(i) + p * w
    return p * x


def normal(key: torch.Tensor, shape: Shape, device=None) -> torch.Tensor:
    """float32 standard normals, as ``jax.random.normal(key, shape)``:
    √2·erfinv(u), u uniform on [nextafter(−1, 0), 1)."""
    lo = torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)).item()
    u = uniform(key, shape, device=device)
    u = torch.clamp_min(u * (1.0 - lo) + lo, lo)
    return math.sqrt(2.0) * _erfinv_f32(u)


def bernoulli(key: torch.Tensor, p: float = 0.5, shape: Shape = (), device=None) -> torch.Tensor:
    """bool samples, True with probability p, as ``jax.random.bernoulli(key,
    p, shape)``: a float32 uniform below p."""
    return uniform(key, shape, device=device) < p


def rademacher(key: torch.Tensor, shape: Shape = (), dtype=torch.int32,
               device=None) -> torch.Tensor:
    """±1 samples, as ``jax.random.rademacher(key, shape, dtype)``."""
    b = bernoulli(key, 0.5, shape, device=device).to(dtype)
    return (2 * b - 1).to(dtype)


def permutation(key: torch.Tensor, n: int, device=None) -> torch.Tensor:
    """A shuffle of ``arange(n)`` (int32), as ``jax.random.permutation(key,
    n)``: each round splits the key, draws one uint32 sort key per element
    and sorts stably by it."""
    x = torch.arange(n, dtype=torch.int32, device=device)
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(_M32))
    for _ in range(rounds):
        key, sub = split(key)
        x = x[torch.sort(bits(sub, (n,), device), stable=True).indices]
    return x


def choice(key: torch.Tensor, n: int, size: int, device=None) -> torch.Tensor:
    """``size`` distinct integers of ``arange(n)`` (int32), as
    ``jax.random.choice(key, n, (size,), replace=False)``: the first ``size``
    entries of :func:`permutation`."""
    if not 0 <= size <= n:
        raise ValueError(f"cannot take {size} distinct samples of {n} without replacement")
    return permutation(key, n, device)[:size]
