"""``jax.random``'s threefry2x32 stream in plain PyTorch integer ops, bit
for bit, on any device.

The reference draws its traces with ``jax.random`` (``PRNGKey``, ``split``,
``fold_in``, ``randint``, ``bernoulli``, ``choice``, ``normal``). A port
that gives the same trace for a seed needs the same bits, so this module
copies the generator and the transforms that turn its bits into values,
operation by operation:

* ``threefry2x32``: the 20-round Threefry-2x32 block cipher of
  ``jax._src.prng`` (rotations 13 15 26 6 / 17 29 16 24, the key schedule
  ``k1 ^ k2 ^ 0x1BD11BDA``, a key injection after every four rounds);
* keys: ``prng_key(seed)`` is ``PRNGKey`` with 64-bit types off (the low
  32 bits of the seed, a zero high word); ``split`` and ``fold_in`` run on
  the host as Python integers, since a key is two words;
* ``bits`` in the **partitionable** layout, which jax 0.9 uses
  (``jax_threefry_partitionable=True``): the draw of shape ``(n,)``
  encrypts, for each flat index ``i``, the counter pair ``(i >> 32,
  i & 0xFFFFFFFF)`` and returns the two output words xor-ed. So the bits at
  a position depend on the position alone, and a window of the stream is
  the counters of its positions. ``split`` is fold-like in this mode (iota
  counters, the two output words the new key). The classic layout, where
  the counters of an ``n``-draw are cut into two half-length lanes, is not
  followed: under it a window's bits depend on the length of the whole
  draw;
* the transforms of ``jax._src.random``: ``randint`` (two draws from
  ``split(key)`` reduced by ``span`` and ``multiplier``, a ``span`` of 1
  when ``maxval <= minval``), ``uniform`` (``(bits >> 9) |
  0x3F800000`` as f32, minus 1, scaled and shifted in one fused
  multiply-add as XLA contracts it, then the ``max``), ``bernoulli``
  (``uniform < f32(p)``), ``choice`` with ``p`` (an f32 prefix sum in
  XLA's blocked order, ``p_cuml[-1] * (1 - uniform)``, a left
  ``searchsorted``) and ``normal`` (``sqrt(2) *
  erf_inv(uniform(nextafter(-1, 0), 1))`` with XLA's f32 ``erf_inv``
  polynomial written out).

Unsigned 32-bit words are held in int64 tensors (wrapping sums and
products are masked back to 32 bits), so every op exists on the CPU and on
the card. Draws take positions (an int64 tensor of flat indices), not a
shape: ``bits(key, torch.arange(n))`` is ``jax.random.bits(key, (n,))``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "MASK32",
    "threefry2x32",
    "prng_key",
    "split",
    "fold_in",
    "bits",
    "uniform_bits",
    "uniform",
    "bernoulli",
    "randint_params",
    "randint",
    "xla_cumsum",
    "choice",
    "erf_inv_f32",
    "normal",
]

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block: ``(out1, out2)`` for keys ``k1, k2`` and
    counter words ``x1, x2`` (Python ints or int64 tensors holding u32)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = (x1 + ks[0]) & MASK32
    b = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & MASK32
            b = ((b << r) | (b >> (32 - r))) & MASK32
            b = a ^ b
        a = (a + ks[(i + 1) % 3]) & MASK32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return a, b


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off: ``(0, seed mod
    2**32)``."""
    return 0, int(seed) & MASK32


def split(key: tuple[int, int], num: int = 2) -> list[tuple[int, int]]:
    """``jax.random.split`` (fold-like): key ``i`` is the block of the
    counter pair ``(0, i)``."""
    return [threefry2x32(key[0], key[1], 0, i) for i in range(num)]


def fold_in(key: tuple[int, int], data) -> tuple:
    """``jax.random.fold_in``: the block of the counter pair ``(0, data mod
    2**32)``. ``data`` may be an int64 tensor: then the result is a key of
    tensors, one key a value (``bits`` and ``randint`` broadcast over it)."""
    data = data & MASK32 if isinstance(data, torch.Tensor) else int(data) & MASK32
    return threefry2x32(key[0], key[1], 0, data)


def bits(key: tuple[int, int], pos: torch.Tensor) -> torch.Tensor:
    """The 32-bit words of the stream at flat positions ``pos`` (int64),
    as int64: ``jax.random.bits(key, (n,))[pos]`` for any ``n > pos``."""
    pos = pos.to(torch.int64)
    out1, out2 = threefry2x32(key[0], key[1], pos >> 32, pos & MASK32)
    return out1 ^ out2


def uniform_bits(words: torch.Tensor) -> torch.Tensor:
    """Words to f32 in ``[0, 1)``: 23 random mantissa bits at exponent 0,
    minus 1 (exact)."""
    f = ((words >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - torch.ones((), dtype=torch.float32, device=f.device)


def uniform(key, pos: torch.Tensor, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)[pos]``:
    ``max(lo, f * (hi - lo) + lo)`` with the scale and shift one fused
    multiply-add, as XLA's CPU program contracts it (an f64 product and sum,
    rounded once)."""
    f = uniform_bits(bits(key, pos))
    lo = torch.full((), float(np.float32(minval)), dtype=torch.float32, device=f.device)
    hi = torch.full((), float(np.float32(maxval)), dtype=torch.float32, device=f.device)
    return torch.maximum(lo, (f.double() * (hi - lo).double() + lo.double()).float())


def bernoulli(key, p: float, pos: torch.Tensor) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, (n,))[pos]``: ``uniform < f32(p)``."""
    return uniform_bits(bits(key, pos)) < float(np.float32(p))


def randint_params(minval: int, maxval: int) -> tuple[int, int]:
    """``(span, multiplier)`` of ``randint``'s reduction for int32 bounds:
    ``span = maxval - minval`` as u32 (1 when ``maxval <= minval``) and
    ``multiplier = (2**16 % span)**2 % span``, the square taken in wrapping
    u32 arithmetic as the reference takes it (so above a span of 2**16 it is
    not ``2**32 % span``)."""
    if not (-(2**31) <= minval < 2**31 and -(2**31) <= maxval < 2**31):
        raise ValueError(f"randint bounds {minval}, {maxval} must be int32")
    span = (maxval - minval) & MASK32 if maxval > minval else 1
    mult = (((2**16 % span) * (2**16 % span)) & MASK32) % span
    return span, mult


def randint(key, pos: torch.Tensor, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, (n,), minval, maxval)[pos]`` (int32): two
    draws from ``split(key)``, ``((hi % span) * mult + lo % span) % span``
    in wrapping u32 arithmetic."""
    span, mult = randint_params(minval, maxval)
    k1, k2 = split(key)
    higher, lower = bits(k1, pos), bits(k2, pos)
    offset = (((higher % span) * mult + (lower % span)) & MASK32) % span
    return (offset + minval).to(torch.int32)


def xla_cumsum(p: np.ndarray) -> np.ndarray:
    """``jnp.cumsum`` of an f32 vector as XLA's CPU program forms it: its
    reduce-window rewrite cuts the vector into blocks of 16, takes each
    block's prefix sum left to right, the blocks' totals' prefix sums the
    same way (recursively), and adds each block's exclusive offset. Up to 16
    values that is the plain left-to-right sum."""
    p = np.asarray(p, dtype=np.float32)
    n = p.shape[0]
    if n <= 16:
        return np.cumsum(p, dtype=np.float32)
    blocks = np.concatenate([p, np.zeros((-n) % 16, np.float32)]).reshape(-1, 16)
    inner = np.cumsum(blocks, axis=1, dtype=np.float32)
    outer = xla_cumsum(inner[:, -1])
    offset = np.concatenate([np.zeros(1, np.float32), outer[:-1]])
    return (inner + offset[:, None]).astype(np.float32).reshape(-1)[:n]


def choice(key, num: int, pos: torch.Tensor, p: torch.Tensor | None = None, *,
           cuml: torch.Tensor | None = None) -> torch.Tensor:
    """``jax.random.choice(key, num, (n,), p=p)[pos]`` with replacement
    (int32): the f32 prefix sum of ``p`` as XLA forms it (``xla_cumsum``),
    ``r = p_cuml[-1] * (1 - u)``, the first index with ``p_cuml >= r``. A
    caller that draws often passes the prefix sum as ``cuml``."""
    if cuml is None:
        p = p.to(torch.float32)
        if p.shape != (num,):
            raise ValueError(f"choice: p has shape {tuple(p.shape)}, expected ({num},)")
        cuml = torch.from_numpy(xla_cumsum(p.cpu().numpy()))
    elif cuml.shape != (num,):
        raise ValueError(f"choice: cuml has shape {tuple(cuml.shape)}, expected ({num},)")
    u = uniform_bits(bits(key, pos))
    cuml = cuml.to(u.device)
    r = cuml[-1] * (torch.ones((), dtype=torch.float32, device=u.device) - u)
    return torch.searchsorted(cuml, r).to(torch.int32)


# XLA's f32 erf_inv (M. Giles' single-precision approximation), coefficients
# highest degree first, for w = -log1p(-x*x) below 5 and at or above it.
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erf_inv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv``: ``w = -log1p(-x*x)``; below 5 a degree-8
    polynomial in ``w - 2.5``, else in ``sqrt(w) - 3``; times ``x``; ``+-inf``
    at ``+-1``. The Horner steps are fused multiply-adds, as XLA's CPU
    program contracts them (an f64 product and sum, rounded once to f32).
    ``log1p`` is correctly rounded here, where XLA's is up to two ulps off;
    so about one value in a hundred differs from the reference by an ulp or
    two."""
    x = x.to(torch.float32)
    f32 = dict(dtype=torch.float32, device=x.device)
    w = -torch.log1p((x * -x).double()).float()
    small = w < 5.0
    w = torch.where(small, w - torch.full((), 2.5, **f32), torch.sqrt(w) - torch.full((), 3.0, **f32))
    coef = [torch.where(small, torch.full((), float(np.float32(a)), **f32),
                        torch.full((), float(np.float32(b)), **f32))
            for a, b in zip(_ERFINV_SMALL, _ERFINV_LARGE)]
    p = coef[0]
    for c in coef[1:]:
        p = (p.double() * w.double() + c.double()).float()
    out = p * x
    return torch.where(x.abs() == 1.0, x * math.inf, out)


def normal(key, pos: torch.Tensor) -> torch.Tensor:
    """``jax.random.normal(key, (n,))[pos]`` (f32): ``sqrt(2) *
    erf_inv(u)`` with ``u`` uniform on ``[nextafter(-1, 0), 1)``."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, pos, lo, 1.0)
    return torch.full((), float(np.float32(np.sqrt(2))), dtype=torch.float32, device=u.device) \
        * erf_inv_f32(u)
