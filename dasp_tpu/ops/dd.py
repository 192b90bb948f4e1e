"""Double-double (float32 x 2) arithmetic for the fp64 SpMV path.

The reference's ``spmv_double`` binary (``main_f64.cu``, ``dasp_f64.h``) maps
to an error-free-transformation emulation that needs no 64-bit mode in JAX:
every fp64 value v is carried as a pair of float32s ``(hi, lo)`` with
``hi = f32(v)`` and ``lo = f32(v - hi)``, giving ~48 bits of effective
mantissa — comfortably inside the reference's 1e-5 verification tolerance
(``main_f64.cu:8``).  Replacing it with native f64 is a measured change
still to come (ROADMAP A3/B2).

Algorithms are the classic Dekker/Knuth error-free transforms (TwoSum, Split,
TwoProd) specialized to f32 (split constant 2^12+1).  All functions are
elementwise on jnp arrays and safe inside jit.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

_SPLIT = np.float32(4097.0)  # 2^12 + 1 for the 24-bit f32 mantissa

Pair = Tuple[jnp.ndarray, jnp.ndarray]


def from_f64(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side split of a float64 numpy array into (hi, lo) float32."""
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def to_f64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Host-side combine back to float64."""
    return np.asarray(hi, dtype=np.float64) + np.asarray(lo, dtype=np.float64)


def _bar(x):
    """Stop XLA from rewriting an error-free transform across this value.

    An algebraic simplification (under ``--xla_allow_excess_precision``) or
    a contraction of ``a*b +- c`` into one fused multiply-add cancels the
    residual the transform exists to keep; the ``safe=True`` variants put
    a barrier at each such point."""
    import jax
    return jax.lax.optimization_barrier(x)


def two_sum(a, b, safe: bool = False) -> Pair:
    if safe:
        s = _bar(a + b)
        bb = _bar(s - a)
        err = _bar(a - _bar(s - bb)) + _bar(b - bb)
        return s, err
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a, b, safe: bool = False) -> Pair:
    """Requires |a| >= |b| (or a == 0)."""
    if safe:
        s = _bar(a + b)
        err = b - _bar(s - a)
        return s, err
    s = a + b
    err = b - (s - a)
    return s, err


def split(a, safe: bool = False) -> Pair:
    if safe:
        t = _bar(_SPLIT * a)
        hi = t - _bar(t - a)
        lo = a - _bar(hi)
        return hi, lo
    t = _SPLIT * a
    hi = t - (t - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b, safe: bool = False) -> Pair:
    p = a * b
    ah, al = split(a, safe)
    bh, bl = split(b, safe)
    if safe:
        err = (_bar(ah * bh - _bar(p)) + ah * bl + al * bh) + al * bl
    else:
        err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def add(ah, al, bh, bl, safe: bool = False) -> Pair:
    """(ah, al) + (bh, bl), renormalized."""
    sh, sl = two_sum(ah, bh, safe)
    sl = sl + (al + bl)
    return quick_two_sum(sh, sl, safe)


def mul(ah, al, bh, bl, safe: bool = False) -> Pair:
    """(ah, al) * (bh, bl), renormalized."""
    ph, pl = two_prod(ah, bh, safe)
    pl = pl + (ah * bl + al * bh)
    return quick_two_sum(ph, pl, safe)


def sum_axis(h: jnp.ndarray, l: jnp.ndarray, axis: int,
             safe: bool = False) -> Pair:
    """Exact-compensated reduction along ``axis`` via a pairwise tree of
    dd-adds (log2(n) elementwise passes; n is static).  Pass safe=True to
    fence every transform with ``_bar``."""
    n = h.shape[axis]
    if n == 1:
        return jnp.squeeze(h, axis), jnp.squeeze(l, axis)
    half = n // 2

    def slc(x, start, size):
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(start, start + size)
        return x[tuple(idx)]

    sh, sl = add(slc(h, 0, half), slc(l, 0, half),
                 slc(h, half, half), slc(l, half, half), safe)
    rh, rl = sum_axis(sh, sl, axis, safe)
    if n % 2:
        lh = jnp.squeeze(slc(h, n - 1, 1), axis)
        ll = jnp.squeeze(slc(l, n - 1, 1), axis)
        rh, rl = add(rh, rl, lh, ll, safe)
    return rh, rl


def div(ah, al, bh, bl, safe: bool = False) -> Pair:
    """(ah, al) / (bh, bl) by one Newton refinement of the f32 quotient:
    q0 = ah/bh; r = a - q0*b (dd-exact); q = q0 + r_hi/bh."""
    q0 = ah / bh
    ph, pl = mul(bh, bl, q0, jnp.zeros_like(q0), safe)
    rh, rl = add(ah, al, -ph, -pl, safe)
    return quick_two_sum(q0, rh / bh + rl / bh, safe)


def dot(ah, al, bh, bl, safe: bool = False) -> Pair:
    """dd inner product of two flat dd vectors: elementwise dd products
    reduced by the compensated pairwise tree."""
    ph, pl = mul(ah, al, bh, bl, safe)
    return sum_axis(ph, pl, 0, safe)
