"""Double-float32 (compensated) reductions for on-device f32 accuracy.

x64 is global and doubles the bytes every SpMV streams.  These kernels give ~2x-f32
precision for the few reductions that gate PDHG termination (objective
gap at 1e-6 relative), staying in native f32 throughout:

- ``two_sum``: error-free addition transform (Knuth);
- ``two_prod``: Dekker product with bitmask splitting (exact because f32
  has an exact FMA-free split at 12 bits);
- ``sum2`` / ``dot2``: tree reduction over (hi, lo) pairs — log2(N)
  vectorized halving steps, the compensation term carried alongside.

Used by pdlp/solver when the problem dtype is f32 (ROADMAP round-1 item 2
"double-precision on device ... selective df32 is the fast middle").
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def two_sum(a, b):
    """Error-free (s, e) with s = fl(a+b), a + b = s + e exactly."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def _split(a):
    """Dekker split: a = hi + lo with hi carrying the top 12 mantissa
    bits (mask the low 12 of the 23-bit mantissa)."""
    bits = jax.lax.bitcast_convert_type(a, jnp.uint32)
    hi = jax.lax.bitcast_convert_type(
        bits & jnp.uint32(0xFFFFF000), jnp.float32)
    return hi, a - hi


def two_prod(a, b):
    """Error-free (p, e) with p = fl(a*b), a*b = p + e exactly."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _ceil_pow2(n: int) -> int:
    k = 1
    while k < n:
        k *= 2
    return k


def sum2(x):
    """Compensated sum of a 1-D f32 array; returns (hi, lo) with
    hi + lo accurate to ~2x f32 precision."""
    x = x.astype(jnp.float32).ravel()
    n = int(x.shape[0])
    if n == 0:
        z = jnp.float32(0.0)
        return z, z
    m = _ceil_pow2(n)
    hi = jnp.pad(x, (0, m - n))
    lo = jnp.zeros_like(hi)
    while m > 1:
        m //= 2
        a, b = hi[:m], hi[m:]
        s, e = two_sum(a, b)
        hi = s
        lo = lo[:m] + lo[m:] + e
    return hi[0], lo[0]


def dot2(x, y):
    """Compensated dot product; returns (hi, lo)."""
    p, e = two_prod(x.astype(jnp.float32), y.astype(jnp.float32))
    hi, lo = sum2(p)
    lo = lo + jnp.sum(e)  # second-order terms: plain sum suffices
    return hi, lo


def vdot_df32(x, y):
    """Scalar f32 result of the compensated dot (hi + lo folded last)."""
    hi, lo = dot2(x, y)
    return hi + lo


def sum_df32(x):
    hi, lo = sum2(x)
    return hi + lo
