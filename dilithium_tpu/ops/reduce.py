"""Vectorized mod-q arithmetic over uint32 lanes (q = 8380417).

Elementwise replacement for the reference's 3-stage pipelined Barrett
multiplier (`rtl_src/Barrett_8380417.v:189-220`). jnp has no 32x32->hi32
multiply on uint32, so we build an exact one out of 16-bit limbs with a
carry chain, then do Montgomery reduction with
R = 2^32 — the same algebra as the widely used AVX2 software approach, but
expressed as pure elementwise jnp ops so it fuses inside XLA/Pallas kernels.

All functions operate elementwise on arrays of any shape and work both in
plain jnp (traced by XLA) and inside Pallas kernel bodies.

Representation conventions:
  * canonical coefficients live in [0, q) as uint32
  * `mont_mul(a, b)` returns a*b*R^-1 mod q; zeta tables are stored
    premultiplied by R so `mont_mul(x, zeta_mont) == x*zeta mod q`
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from dilithium_tpu.params import Q, QINV, MONT_R, MONT_R2

_U32 = jnp.uint32
_MASK16 = np.uint32(0xFFFF)
_NQINV = (1 << 32) - QINV  # (-q)^-1 mod 2^32, the REDC multiplier


def u32(x) -> jnp.ndarray:
    return jnp.asarray(x, dtype=_U32)


def mulhi_u32(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Exact high 32 bits of the 64-bit product of two uint32 arrays.

    16-bit limb decomposition with a carry chain; every intermediate fits
    in uint32. 4 multiplies + a few shifts/adds per element.
    """
    a = a.astype(_U32)
    b = b.astype(_U32)
    al = a & _MASK16
    ah = a >> 16
    bl = b & _MASK16
    bh = b >> 16
    t = al * bl                       # < 2^32
    w = t >> 16
    t = ah * bl + w                   # < 2^32
    w1 = t >> 16
    w2 = t & _MASK16
    t = al * bh + w2                  # < 2^32
    return ah * bh + w1 + (t >> 16)   # < 2^32


def mont_reduce(lo: jnp.ndarray, hi: jnp.ndarray) -> jnp.ndarray:
    """Montgomery-reduce a 64-bit value P = hi*2^32 + lo to P*R^-1 mod q.

    Requires P < q * 2^32. Result in [0, q).
    """
    m = lo * np.uint32(_NQINV)                     # (-P * q^-1) mod 2^32
    mq_hi = mulhi_u32(m, np.uint32(Q))
    # lo + m*q ≡ 0 (mod 2^32): carry-out is 1 iff lo != 0
    carry = (lo != 0).astype(_U32)
    t = hi + mq_hi + carry                          # < 2q
    return csubq(t)


def mont_mul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """a * b * R^-1 mod q for a, b in [0, q). Result in [0, q)."""
    a = a.astype(_U32)
    b = b.astype(_U32)
    return mont_reduce(a * b, mulhi_u32(a, b))


def to_mont(a: jnp.ndarray) -> jnp.ndarray:
    """Lift to Montgomery domain: a * R mod q."""
    return mont_mul(a, np.uint32(MONT_R2))


def from_mont(a: jnp.ndarray) -> jnp.ndarray:
    """Drop from Montgomery domain: a * R^-1 mod q."""
    return mont_reduce(a.astype(_U32), jnp.zeros_like(a, dtype=_U32))


def mul_mod(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Plain a * b mod q (two Montgomery multiplies)."""
    return mont_mul(to_mont(a), b)


def csubq(a: jnp.ndarray) -> jnp.ndarray:
    """Conditional subtract: map [0, 2q) -> [0, q)."""
    return jnp.where(a >= np.uint32(Q), a - np.uint32(Q), a)


def add_mod(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(a + b) mod q for inputs in [0, q)."""
    return csubq(a.astype(_U32) + b.astype(_U32))


def sub_mod(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(a - b) mod q for inputs in [0, q)."""
    return csubq(a.astype(_U32) + np.uint32(Q) - b.astype(_U32))


def neg_mod(a: jnp.ndarray) -> jnp.ndarray:
    """(-a) mod q for input in [0, q)."""
    return csubq(np.uint32(Q) - a.astype(_U32))  # maps 0 -> q -> 0


def center(a: jnp.ndarray) -> jnp.ndarray:
    """Map canonical [0, q) to centered representative in (-q/2, q/2] as int32."""
    a = a.astype(_U32)
    hi = a > np.uint32((Q - 1) // 2)
    return jnp.where(hi, a.astype(jnp.int32) - jnp.int32(Q), a.astype(jnp.int32))


def uncenter(a: jnp.ndarray) -> jnp.ndarray:
    """Map centered int32 in (-q, q) back to canonical [0, q) uint32."""
    a = a.astype(jnp.int32)
    return jnp.where(a < 0, a + jnp.int32(Q), a).astype(_U32)
