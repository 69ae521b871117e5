"""Threefry-2x32 keys and draws, bit for bit those of ``jax.random``.

The reference seeds its weights and its sampled decodes with ``jax.random``
under the default ``threefry2x32`` implementation and the partitionable bit
layout (``jax_threefry_partitionable=True``).  This module reproduces that
stream on the host in numpy ``uint32`` arithmetic (which wraps modulo 2^32,
as the hash needs), so a seed gives the reference's keys, bits, uniforms and
normals; callers move the results to the device, so the card sees the
host's bits.

A key is a ``(2,)`` uint32 array; every function also takes a stack of keys
``(..., 2)`` and then returns one result per key.

* :func:`PRNGKey` — ``[0, seed mod 2^32]`` (JAX's 32-bit seeding: the high
  word of a 64-bit seed is dropped);
* :func:`split` — key ``i`` of ``num`` is the hash of the counter ``(0, i)``;
* :func:`fold_in` — the hash of ``(0, data)``, the same words as
  ``split(key, data + 1)[data]``;
* :func:`bits` — the hash of each element's flat index (high, low words),
  the two output words xor-ed;
* :func:`uniform` — 23 random mantissa bits in [1, 2), minus 1, then
  ``floats * (maxval - minval) + minval`` with ONE rounding: XLA's CPU
  backend fuses that multiply-add, so it is emulated exactly here;
* :func:`normal` — ``sqrt(2) * erf_inv(u)`` for ``u`` uniform in
  ``(-1, 1)``, with XLA's float32 ``erf_inv`` (the nine-coefficient
  polynomial of Giles) and XLA's float32 ``log1p`` (a Cephes rational
  function below ``sqrt(2) - 1``, else its own ``log`` of ``1 + x``), both
  written out with the multiply-adds XLA's compiled code fuses.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["PRNGKey", "split", "fold_in", "bits", "uniform", "normal", "threefry2x32"]

_U32 = np.uint32
_F32 = np.float32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(k1, k2, x1, x2) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of counter words ``(x1, x2)``
    under key words ``(k1, k2)``; every argument broadcasts."""
    k1, k2 = np.asarray(k1, _U32), np.asarray(k2, _U32)
    ks = (k1, k2, k1 ^ k2 ^ _U32(0x1BD11BDA))
    with np.errstate(over="ignore"):          # uint32 sums wrap, as the hash needs
        x = [np.asarray(x1, _U32) + ks[0], np.asarray(x2, _U32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return np.asarray(x[0]), np.asarray(x[1])


def _key(key) -> np.ndarray:
    key = np.asarray(key)
    if key.dtype != _U32 or key.shape[-1:] != (2,):
        raise TypeError(f"a key is a (..., 2) uint32 array, got {key.dtype} {key.shape}")
    return key


def PRNGKey(seed: int) -> np.ndarray:  # noqa: N802 — the reference's name
    """The key of an integer ``seed``: ``[0, seed mod 2^32]``."""
    return np.array([0, int(np.int64(seed)) & 0xFFFFFFFF], dtype=_U32)


def split(key, num: int = 2) -> np.ndarray:
    """``num`` new keys from ``key``: ``(..., num, 2)``."""
    key = _key(key)
    y0, y1 = threefry2x32(key[..., 0, None], key[..., 1, None], 0,
                          np.arange(num, dtype=_U32))
    return np.stack([y0, y1], axis=-1)


def fold_in(key, data) -> np.ndarray:
    """``key`` folded with the non-negative integer(s) ``data`` (broadcast
    against the key's leading dimensions)."""
    key = _key(key)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], 0, np.asarray(data, dtype=_U32))
    return np.stack([y0, y1], axis=-1)


def bits(key, shape=()) -> np.ndarray:
    """Random uint32 words of ``shape`` (``key.shape[:-1] + shape``)."""
    key = _key(key)
    shape = tuple(shape)
    idx = np.arange(math.prod(shape), dtype=np.uint64).reshape(shape)
    hi, lo = (idx >> np.uint64(32)).astype(_U32), idx.astype(_U32)
    lead = (slice(None),) * (key.ndim - 1) + (None,) * len(shape)
    y0, y1 = threefry2x32(key[..., 0][lead], key[..., 1][lead], hi, lo)
    return y0 ^ y1


# ---------------------------------------------------------------------- #
# float32 arithmetic as XLA's CPU code runs it
# ---------------------------------------------------------------------- #
def _fma(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add: the
    product is exact in float64, and the float64 sum is rounded to odd
    (its last bit set when inexact), so the one rounding to float32 that
    follows is the correctly rounded result."""
    a, b, c = (np.asarray(v, _F32).astype(np.float64) for v in (a, b, c))
    p = a * b
    s = p + c
    # the exact residue of the float64 sum (Knuth's two-sum)
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    sb = s.view(np.int64)
    even = (sb & 1) == 0
    inexact = (err != 0) & even & np.isfinite(s)
    toward = np.where(err > 0, np.inf, -np.inf)
    s = np.where(inexact, np.nextafter(s, toward), s)
    return s.astype(_F32)


def _f32(x) -> np.ndarray:
    return np.asarray(x, _F32)


_LOG_P = (7.0376836292e-2, -1.1514610310e-1, -1.2420140846e-1, 1.4249322787e-1,
          2.0000714765e-1, -2.4999993993e-1, 1.1676998740e-1, -1.6668057665e-1,
          3.3333331174e-1)
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _log_f32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``log`` (Cephes ``logf``: a degree-9 polynomial on the
    mantissa folded into [sqrt(1/2), sqrt(2)), plus the exponent times ln 2
    split in two), with the CPU code's fused multiply-adds."""
    f = _F32
    one = f(1.0)
    with np.errstate(invalid="ignore", over="ignore"):
        xc = np.where(x > f(np.finfo(f).tiny), x, f(np.finfo(f).tiny)).astype(f)
        b = xc.view(np.uint32)
        m = ((b & _U32(0x7FFFFF)) | _U32(0x3F000000)).view(f)
        e = ((b >> _U32(23)).astype(np.int32) - 127).astype(f) + one
        small = m < f(0.707106781186547524)
        e = e - np.where(small, one, f(0.0))
        x2 = (m - one) + np.where(small, m, f(0.0))
        z = x2 * x2
        z3 = z * x2
        y = _fma(x2, _LOG_P[0], _LOG_P[1])
        y1 = _fma(x2, _LOG_P[2], _LOG_P[3])
        y2 = _fma(x2, _LOG_P[4], _LOG_P[5])
        y = _fma(y, x2, _LOG_P[6])
        y1 = _fma(y1, x2, _LOG_P[7])
        y2 = _fma(y2, x2, _LOG_P[8])
        y = _fma(y, z3, y1)
        y = _fma(y, z3, y2)
        y = _fma(y, z3, e * f(-2.12194440e-4))
        r = _fma(-z, f(0.5), x2) + y
        r = _fma(e, f(0.693359375), r).view(np.int32)
        # log(0) = -inf, log(inf) = inf, NaN below 0 and for NaN
        r = np.where(x > 0, r, np.int32(-1))
        r = np.where((x == 0) | (x == np.inf), np.int32(0), r)
        edge = np.where(x == 0, np.int32(-8388608), np.where(x == np.inf, np.int32(0x7F800000), 0))
        return (edge | r).astype(np.int32).view(f)


def _log1p_f32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``log1p``: a Cephes rational approximation for
    |x| < sqrt(2) - 1, else ``log(1 + x)``."""
    f = _F32
    x = _f32(x)
    with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
        large = _log_f32(x + f(1.0))
        x2 = x * x
        num = f(_LOG1P_NUM[0])
        den = f(_LOG1P_DEN[0])
        for cn, cd in zip(_LOG1P_NUM[1:], _LOG1P_DEN[1:]):
            num = _fma(num, x, cn)
            den = _fma(den, x, cd)
        small = x + _fma(x2, f(-0.5), (x * x2) * (num / den))
        return np.where(np.abs(x) < f(0.41421356237309504880), small, large).astype(f)


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _erf_inv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``erf_inv`` (Giles' single-precision approximation)."""
    f = _F32
    x = _f32(x)
    with np.errstate(invalid="ignore", over="ignore"):
        w = -_log1p_f32(-(x * x))
        lt = w < f(5.0)
        t = np.where(lt, w - f(2.5), np.sqrt(w) - f(3.0)).astype(f)
        p = np.where(lt, f(_ERFINV_LT5[0]), f(_ERFINV_GE5[0]))
        for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
            p = _fma(p, t, np.where(lt, f(a), f(b)))
        return np.where(np.abs(x) == f(1.0), x * f(np.inf), p * x).astype(f)


def uniform(key, shape=(), minval=0.0, maxval=1.0) -> np.ndarray:
    """float32 uniforms in ``[minval, maxval)`` (``key.shape[:-1] + shape``)."""
    f = _F32
    minval, maxval = f(minval), f(maxval)
    mant = (bits(key, shape) >> _U32(9)) | _U32(0x3F800000)
    floats = mant.view(f) - f(1.0)
    return np.maximum(minval, _fma(floats, maxval - minval, minval)).astype(f)


def normal(key, shape=()) -> np.ndarray:
    """float32 standard normals (``key.shape[:-1] + shape``)."""
    f = _F32
    lo = np.nextafter(f(-1.0), f(0.0))
    u = uniform(key, shape, lo, f(1.0))
    return (f(np.sqrt(2)) * _erf_inv_f32(u)).astype(f)
