"""Rounding, decomposition, hints and norm checks — fused elementwise ops.

Elementwise replacement for the reference's streaming rounding datapath
(`rtl_src/coeff_decomposer.v` 5-stage pipeline, `decomp_map1.v` threshold
trees, `uncenter_coeff.v`, `makehint.v`, `usehint.v`, `norm_check.v`).
Everything here is branch-free int32 arithmetic over whole `[..., 256]`
polynomial batches; XLA fuses these into neighbouring kernels, which is the
software analog of the RTL wiring these units inline with BRAM streams.

Conventions: canonical coefficients are uint32 in [0, q); "centered" values
are int32 in (-q/2, q/2]. High/low decomposition follows the round-3 spec
exactly (the magic-constant forms are the published reference algorithms,
mirrored by the RTL's shift-add trees at `coeff_decomposer.v:84-88`).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from dilithium_tpu.params import Q, D, DilithiumParams
from dilithium_tpu.ops.reduce import center, uncenter

_I32 = jnp.int32


def power2round(a: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Split canonical a in [0, q) into (a1, a0) with a = a1*2^13 + a0.

    a1 uint32 in [0, 1023]; a0 int32 centered in (-2^12, 2^12].
    Mirrors `uncenter_coeff.v:51-55` (t1 = (d + T - 1) >> 13).
    """
    a = a.astype(_I32)
    a1 = (a + (1 << (D - 1)) - 1) >> D
    a0 = a - (a1 << D)
    return a1.astype(jnp.uint32), a0


def decompose(a: jnp.ndarray, p: DilithiumParams) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Round-3 Decompose: a = a1 * 2*gamma2 + a0 (mod q).

    a canonical [0, q). Returns (a1 uint32 small, a0 int32 centered in
    [-gamma2, gamma2] with the q-1 boundary folded). Exact per-spec magic
    forms; the RTL computes the same map with 44/16 comparators
    (`decomp_map1.v:36-171`).
    """
    a = a.astype(_I32)
    a1 = (a + 127) >> 7
    if p.gamma2 == (Q - 1) // 32:
        a1 = (a1 * 1025 + (1 << 21)) >> 22
        a1 = a1 & 15
    else:  # gamma2 == (Q - 1) // 88
        a1 = (a1 * 11275 + (1 << 23)) >> 24
        a1 = a1 ^ (((43 - a1) >> 31) & a1)
    a0 = a - a1 * (2 * p.gamma2)
    a0 = a0 - ((((Q - 1) // 2 - a0) >> 31) & Q)
    return a1.astype(jnp.uint32), a0


def highbits(a: jnp.ndarray, p: DilithiumParams) -> jnp.ndarray:
    return decompose(a, p)[0]


def lowbits(a: jnp.ndarray, p: DilithiumParams) -> jnp.ndarray:
    return decompose(a, p)[1]


def make_hint(a0: jnp.ndarray, a1: jnp.ndarray, p: DilithiumParams) -> jnp.ndarray:
    """Hint bit per coefficient (uint32 0/1).

    a0: centered int32 low part of (w - cs2 + ct0); a1: w1 high part.
    Mirrors the boundary test in `makehint.v:98-99`.
    """
    g2 = jnp.int32(p.gamma2)
    a0 = a0.astype(_I32)
    hint = (a0 > g2) | (a0 < -g2) | ((a0 == -g2) & (a1.astype(_I32) != 0))
    return hint.astype(jnp.uint32)


def use_hint(h: jnp.ndarray, a: jnp.ndarray, p: DilithiumParams) -> jnp.ndarray:
    """Recover w1 from hint bits and canonical a (verify path).

    Mirrors `usehint.v:140-159` (±1 with per-level wrap 15 / 43).
    """
    a1, a0 = decompose(a, p)
    a1 = a1.astype(_I32)
    pos = a0 > 0
    if p.gamma2 == (Q - 1) // 32:
        up = (a1 + 1) & 15
        dn = (a1 - 1) & 15
    else:
        up = jnp.where(a1 == 43, 0, a1 + 1)
        dn = jnp.where(a1 == 0, 43, a1 - 1)
    shifted = jnp.where(pos, up, dn)
    return jnp.where(h.astype(jnp.bool_), shifted, a1).astype(jnp.uint32)


def norm_exceeds(a: jnp.ndarray, bound: int, axis=None) -> jnp.ndarray:
    """True where the centered infinity norm is >= bound (reject condition).

    a: canonical uint32 or centered int32. Reduces over `axis` (default:
    none — elementwise). Mirrors `norm_check.v:84-106` (streaming ∞-norm,
    modes ||z|| < gamma1-beta, ||w0-cs2|| < gamma2-beta, ||ct0|| < gamma2).
    Per spec the check uses |a| via a centered representative and rejects
    on >= bound.
    """
    if a.dtype == jnp.uint32:
        a = center(a)
    bad = jnp.abs(a.astype(_I32)) >= jnp.int32(bound)
    if axis is None:
        return bad
    return jnp.any(bad, axis=axis)


__all__ = [
    "power2round", "decompose", "highbits", "lowbits",
    "make_hint", "use_hint", "norm_exceeds", "center", "uncenter",
]
