"""Batched 256-point NTT over Z_q (q = 8380417) in roll/select form.

Batched replacement for the reference's polynomial compute engine
(`rtl_src/operation_module.v`, `address_unit.v`, `butterfly2x2.v`,
`twiddle_resolver.v`, `ntt_fifo*.v` — the 2x2 BRAM-streamed dataflow,
≈290 cycles/poly at 4 coeff/cycle). Each of the 8 stages is ONE
full-width butterfly pass expressed as roll + select + Montgomery
multiply over the last axis, so a `[B, 256]` batch runs all B transforms
in lockstep as elementwise ops that XLA fuses, with no gathers. The FPGA's in-place address permutations
(`address_resolver.v:38-53`) are unnecessary — XLA owns layout.

Zeta tables are the standard Dilithium twiddles (r = 1753, bit-reversed
order — equivalent to the reference's `zetas.txt` / `consts.cpp:64-97`
up to reduction convention), stored premultiplied by R = 2^32 so that
`mont_mul(x, zeta_mont) == x * zeta mod q`.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from dilithium_tpu.params import Q, N, MONT_R
from dilithium_tpu.ops.reduce import mont_mul, add_mod, sub_mod

_ROOT = 1753  # primitive 512th root of unity mod q


def _bitrev8(x: int) -> int:
    return int(f"{x:08b}"[::-1], 2)


def _build_tables():
    """Per-stage, per-position zeta tables for forward and inverse NTT.

    Mirrors the scalar loop structure of the standard reference NTT so the
    vectorized passes are index-for-index identical to it.
    """
    zetas = np.array([pow(_ROOT, _bitrev8(i), Q) for i in range(256)], dtype=np.uint64)
    R = 1 << 32

    fwd = np.zeros((8, N), dtype=np.uint32)  # zeta (mont) for each row, per stage
    k = 0
    for s, length in enumerate([128, 64, 32, 16, 8, 4, 2, 1]):
        for start in range(0, N, 2 * length):
            k += 1
            z = int(zetas[k])
            fwd[s, start: start + 2 * length] = (z * R) % Q

    inv = np.zeros((8, N), dtype=np.uint32)
    k = 256
    for s, length in enumerate([1, 2, 4, 8, 16, 32, 64, 128]):
        for start in range(0, N, 2 * length):
            k -= 1
            z = (-int(zetas[k])) % Q
            inv[s, start: start + 2 * length] = (z * R) % Q

    # row parity masks per stage: True where the row is the "a" (low) half
    is_a_fwd = np.zeros((8, N), dtype=bool)
    for s, length in enumerate([128, 64, 32, 16, 8, 4, 2, 1]):
        idx = np.arange(N)
        is_a_fwd[s] = (idx % (2 * length)) < length
    is_a_inv = np.zeros((8, N), dtype=bool)
    for s, length in enumerate([1, 2, 4, 8, 16, 32, 64, 128]):
        idx = np.arange(N)
        is_a_inv[s] = (idx % (2 * length)) < length

    return fwd, inv, is_a_fwd, is_a_inv


_FWD_ZETAS, _INV_ZETAS, _ISA_FWD, _ISA_INV = _build_tables()

# final inverse-NTT scaling factors (Montgomery-form multipliers):
#   product path: input carries an R^-1 from pointwise mont_mul ->
#                 multiply by 256^-1 * R^2  (net: x * 256^-1 * R * R^-1... see below)
#   plain path:   multiply by 256^-1 * R
_N_INV = pow(256, -1, Q)
_F_PRODUCT = (_N_INV * (1 << 32) % Q) * (1 << 32) % Q  # mont_mul(x, .) = x*256^-1*R
_F_PLAIN = (_N_INV * (1 << 32)) % Q                     # mont_mul(x, .) = x*256^-1

_FWD_LENGTHS = (128, 64, 32, 16, 8, 4, 2, 1)
_INV_LENGTHS = (1, 2, 4, 8, 16, 32, 64, 128)


def ntt(x: jnp.ndarray) -> jnp.ndarray:
    """Forward NTT. x: uint32 [..., 256] in [0, q) -> NTT domain, [0, q).

    Output ordering/semantics match the standard Dilithium reference ntt()
    (bit-reversed-zeta CT; cf. `dilithium-256/reference_code/ref_ntt.cpp`).
    """
    fwd = jnp.asarray(_FWD_ZETAS)
    for s, length in enumerate(_FWD_LENGTHS):
        is_a = jnp.asarray(_ISA_FWD[s])
        zrow = fwd[s]
        partner_dn = jnp.roll(x, -length, axis=-1)  # row j sees x[j+len]
        partner_up = jnp.roll(x, length, axis=-1)   # row j sees x[j-len]
        b_operand = jnp.where(is_a, partner_dn, x)
        t = mont_mul(zrow, b_operand)
        x = jnp.where(is_a, add_mod(x, t), sub_mod(partner_up, t))
    return x


def invntt(x: jnp.ndarray, from_product: bool = True) -> jnp.ndarray:
    """Inverse NTT. x: uint32 [..., 256] NTT-domain -> coefficients, [0, q).

    from_product=True assumes x came from `pointwise`/`matvec` (carries an
    R^-1 Montgomery factor, as all inverse transforms in the scheme do —
    SURVEY.md §3: every INTT follows a MULT) and folds the correction into
    the final scaling, like the reference folds 1/256 into per-stage div2
    (`ref_ntt2x2.cpp:91`, `butterfly.v:214-222`).
    """
    inv = jnp.asarray(_INV_ZETAS)
    for s, length in enumerate(_INV_LENGTHS):
        is_a = jnp.asarray(_ISA_INV[s])
        zrow = inv[s]
        partner_dn = jnp.roll(x, -length, axis=-1)
        partner_up = jnp.roll(x, length, axis=-1)
        # a' = a + b ; b' = zeta * (a - b)
        a_new = add_mod(x, partner_dn)
        b_new = mont_mul(zrow, sub_mod(partner_up, x))
        x = jnp.where(is_a, a_new, b_new)
    f = jnp.uint32(_F_PRODUCT if from_product else _F_PLAIN)
    return mont_mul(x, f)


def pointwise(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """NTT-domain coefficient product, carrying an R^-1 factor.

    Feed the result to `invntt(..., from_product=True)` (or accumulate with
    `add_mod` first — the reference's MULT mode is also multiply-accumulate,
    `operation_module.v:187-202`).
    """
    return mont_mul(a, b)


def matvec(a_hat: jnp.ndarray, s_hat: jnp.ndarray) -> jnp.ndarray:
    """NTT-domain matrix-vector product: [..., K, L, 256] x [..., L, 256].

    Returns [..., K, 256] with Sum_l A[k,l] o s[l], each term carrying R^-1
    (the reference accumulates via the butterfly acc port; here it is a
    tree of mod-q adds the compiler fuses).
    """
    prod = mont_mul(a_hat, s_hat[..., None, :, :])  # [..., K, L, 256]
    L = prod.shape[-2]
    acc = prod[..., 0, :]
    for l in range(1, L):
        acc = add_mod(acc, prod[..., l, :])
    return acc


def poly_mul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Negacyclic polynomial product a*b mod (X^256+1, q), both [..., 256]."""
    return invntt(pointwise(ntt(a), ntt(b)), from_product=True)
