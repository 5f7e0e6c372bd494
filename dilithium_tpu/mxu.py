"""Int8-operator signing path: per-key linear operators as int8 matmuls.

(The module name is historical: "mxu" = matrix unit, the int8 tensor-core
path on the GPU.) The FPGA streams every polynomial through its butterfly
pipeline because BRAM is tiny; an accelerator has int8 matrix units and
device memory to spare. For a FIXED key the whole hot chain of a sign attempt,

    w  = INTT(A_hat . NTT(y))        (`combined_top.v` FSM1 MULT_A_Y/NTTI_W)
    cs1 = INTT(c_hat o s1_hat)       (FSM2 MULTACC)
    cs2 = INTT(c_hat o s2_hat)
    ct0 = INTT(c_hat o t0_hat)

is LINEAR in y (resp. c). So expand the key once into dense matrices and
evaluate attempts as matmuls:

  * W_y: [L*256, K*256] over Z_q — built by pushing the identity basis
    through the existing NTT pipeline; split into 3 balanced base-256
    int8 limbs per side (9 int8 matmuls, exact in int32 accumulation:
    |sum| <= 1280 * 128 * 128 < 2^31), recombined mod q with a short
    Horner chain of Barrett reductions.
  * S1/S2 negacyclic convolution matrices: entries are the CENTERED
    secret coefficients (|s| <= eta <= 4) — single int8 matmul, result
    bounded by beta <= 196: no reduction at all.
  * T0 convolution matrices in 2 int8 limbs (|t0| <= 2^12).

c has entries in {0, +-1} (int8, 1 "limb"), y needs 3 limbs.

This path powers the single-key throughput service (`sign_stream_mxu`);
batched-independent-keys paths keep the generic NTT (a composite matrix
per key would be 5.9 MB/key).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# In-loop matmul grouping: the signer always uses the "cat" form — the 9
# W_y limb products as 3 dots against a [L*N, 3*K*N] concatenation and
# the 4 c-side products (cs1/cs2/ct0_lo/ct0_hi) as 1 dot against a
# [N, (L+3K)*N] concatenation — fewer kernel launches, same FLOPs. The
# 9-dot "split" form survives as the wy_limbs-argument path of _apply_wy
# (the verify path uses it via VerifyOperators.wz_limbs; tests pin both
# forms equal). The old DILITHIUM_MXU_GROUPING env A/B was read at import
# time and therefore silently inert when set late — removed.

from dilithium_tpu.params import Q, N, D, CRHBYTES, TRBYTES, DilithiumParams
from dilithium_tpu import scheme
from dilithium_tpu.ops import keccak, ntt, pack, rounding, sampling
from dilithium_tpu.ops.reduce import (
    add_mod, center, csubq, mont_mul, mulhi_u32, sub_mod, uncenter,
)

_I8 = jnp.int8
_I32 = jnp.int32
_U8 = jnp.uint8
_U32 = jnp.uint32


class KeyOperators(NamedTuple):
    """Dense per-key operators (see module docstring).

    Only the column-concatenated forms are STORED (one copy of each
    operator, ~5.9 MB/key at level 3); the individual limb matrices are
    exposed as slicing properties — wy_cat[:, j*KN:(j+1)*KN] is W limb j,
    c_cat = [s1 | s2 | t0_lo | t0_hi] — so the in-loop attempt runs 3+1
    MXU dots instead of 9+4 and the split A/B path costs no extra HBM.
    """
    wy_cat: jnp.ndarray     # int8 [L*256, 3*K*256]
    c_cat: jnp.ndarray      # int8 [256, (L+3K)*256]
    key: jnp.ndarray        # uint8 [32]
    tr: jnp.ndarray         # uint8 [32]

    @property
    def _kn(self) -> int:
        return self.wy_cat.shape[-1] // 3

    @property
    def wy_limbs(self) -> jnp.ndarray:  # int8 [3, L*256, K*256]
        kn = self._kn
        return jnp.stack(
            [self.wy_cat[:, j * kn:(j + 1) * kn] for j in range(3)]
        )

    @property
    def s1_mat(self) -> jnp.ndarray:  # int8 [256, L*256]
        return self.c_cat[:, :self.wy_cat.shape[0]]

    @property
    def s2_mat(self) -> jnp.ndarray:  # int8 [256, K*256]
        ln = self.wy_cat.shape[0]
        return self.c_cat[:, ln:ln + self._kn]

    @property
    def t0_lo(self) -> jnp.ndarray:  # int8 [256, K*256]
        ln, kn = self.wy_cat.shape[0], self._kn
        return self.c_cat[:, ln + kn:ln + 2 * kn]

    @property
    def t0_hi(self) -> jnp.ndarray:  # int8 [256, K*256]
        ln, kn = self.wy_cat.shape[0], self._kn
        return self.c_cat[:, ln + 2 * kn:]


def _to_limbs_i8(m_centered: jnp.ndarray):
    """Centered int32 in (-q/2, q/2] -> 3 balanced base-256 int8 digits.

    x = d0 + 256*d1 + 65536*d2 with each d in [-128, 127].
    """
    x = m_centered.astype(_I32)  # |x| <= q/2 < 2^23: int32 exact throughout
    d0 = ((x + 128) % 256) - 128
    x1 = (x - d0) >> 8           # exact: x - d0 divisible by 256
    d1 = ((x1 + 128) % 256) - 128
    d2 = (x1 - d1) >> 8
    return (
        d0.astype(_I8), d1.astype(_I8), d2.astype(_I8),
    )


def _conv_matrix(s_centered: jnp.ndarray) -> jnp.ndarray:
    """Negacyclic convolution matrix of one poly: c @ M == c * s mod X^N+1.

    M[j, i] = sign * s[(i - j) mod N], sign = -1 where i < j.
    s_centered: int32 [..., N]; returns int32 [..., N(j), N(i)].
    """
    i = jnp.arange(N)[None, :]
    j = jnp.arange(N)[:, None]
    idx = (i - j) % N
    sgn = jnp.where(i >= j, 1, -1).astype(_I32)
    return sgn * jnp.take(s_centered, idx, axis=-1)


def _wy_limbs_from_ahat(a_hat: jnp.ndarray, p: DilithiumParams) -> jnp.ndarray:
    """A_hat [K, L, 256] -> the dense y->w (= z->Az) map as int8 limbs.

    w[k] = sum_l y[l] * A[k,l] mod (X^N+1), so the [L*N, K*N] matrix is the
    KxL grid of negacyclic convolution matrices of the PLAIN matrix
    polynomials A[k,l] = INTT(A_hat[k,l]) — no basis push through the NTT
    pipeline needed. Shared by the signer (y -> w) and verifier (z -> Az).
    """
    K, L = p.K, p.L
    a_poly = center(ntt.invntt(a_hat, from_product=False))  # [K, L, N] int32
    w_mat = jnp.concatenate(
        [
            jnp.concatenate(
                [_conv_matrix(a_poly[k, l]) for k in range(K)], axis=-1
            )  # [N, K*N]
            for l in range(L)
        ],
        axis=0,
    )  # [L*N, K*N] centered int32
    return jnp.stack(_to_limbs_i8(w_mat))  # [3, L*N, K*N]


@partial(jax.jit, static_argnames=("p",))
def build_operators(sk: jnp.ndarray, p: DilithiumParams) -> KeyOperators:
    """Expand one UNBATCHED sk into dense MXU operators."""
    rho, key, tr, s1, s2, t0 = pack.unpack_sk(sk, p)
    a_hat, ok_a = sampling.expand_a(rho, p)
    sampling.debug_check_ok(ok_a, "build_operators.expand_a")
    L, K = p.L, p.K

    wy_limbs = _wy_limbs_from_ahat(a_hat, p)

    s1_mat = jnp.concatenate(
        [_conv_matrix(center(s1[l])) for l in range(L)], axis=-1
    ).astype(_I8)  # [256, L*N]
    s2_mat = jnp.concatenate(
        [_conv_matrix(center(s2[k])) for k in range(K)], axis=-1
    ).astype(_I8)
    # base-128 digits: the conv matrix NEGATES entries (negacyclic wrap),
    # so digit magnitude must stay <= 127 after negation — base-256's -128
    # digit would overflow int8 when flipped. |lo| <= 64, |hi| <= 32.
    t0c = t0.astype(_I32)  # centered already
    lo = ((t0c + 64) % 128) - 64
    hi = (t0c - lo) >> 7
    t0_lo = jnp.concatenate(
        [_conv_matrix(lo[k]) for k in range(K)], axis=-1
    ).astype(_I8)
    t0_hi = jnp.concatenate(
        [_conv_matrix(hi[k]) for k in range(K)], axis=-1
    ).astype(_I8)
    wy_cat = jnp.concatenate([wy_limbs[0], wy_limbs[1], wy_limbs[2]], axis=-1)
    c_cat = jnp.concatenate([s1_mat, s2_mat, t0_lo, t0_hi], axis=-1)
    return KeyOperators(wy_cat, c_cat, key, tr)


# ---- exact mod-q recombination of limb products ----

_MAGIC45 = np.uint32((1 << 45) // Q)  # floor(2^45 / q) = 4198404, 23 bits
_LIFT = np.uint32((256 * Q) & 0xFFFFFFFF)  # 256*q = 2145386752 < 2^32


def _mod_q_i32(x: jnp.ndarray) -> jnp.ndarray:
    """Exact x mod q -> [0, q) uint32, for int32 x with x + 256*q < 2^32
    (i.e. x > -256*q and x < 2^32 - 256*q ~ 2.1e9; we use |x| <= ~1.2e9).

    Lift into uint32 via two's-complement add of 256*q, then Barrett with
    magic = floor(2^45/q): r = u - ((u*magic)>>45)*q lands in [0, ~2q);
    two conditional subtracts finish. Validated exhaustively-at-random in
    tests/test_mxu.py.
    """
    u = x.astype(_U32) + _LIFT  # exact x + 256q (two's complement)
    hi = mulhi_u32(u, _MAGIC45)  # (u * magic) >> 32
    est = hi >> np.uint32(13)    # >> 45 total
    r = u - est * np.uint32(Q)
    return csubq(csubq(r))


def _recombine(p0, p1, p2, p3, p4):
    """sum_k 2^(8k) * P_k mod q, P_k int32 |P_k| <= ~2.1e7. Horner chain."""
    def step(acc_canon, pk):
        # acc' = pk + 256 * centered(acc); |centered| <= q/2 -> |256*c| < 2^30
        c = center(acc_canon)
        return _mod_q_i32(pk + (c << 8))

    acc = _mod_q_i32(p4)
    acc = step(acc, p3)
    acc = step(acc, p2)
    acc = step(acc, p1)
    acc = step(acc, p0)
    return acc  # canonical [0, q)


def _dot_i8(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """int8 [M, K] @ int8 [K, N] -> int32 [M, N] (int8 tensor cores)."""
    return jax.lax.dot_general(
        a, b, (((1,), (0,)), ((), ())), preferred_element_type=_I32
    )


def _apply_wy(
    y: jnp.ndarray,
    wy_limbs: jnp.ndarray | None,
    p: DilithiumParams,
    wy_cat: jnp.ndarray | None = None,
):
    """y uint32 [B, L*256] canonical -> w uint32 [B, K*256] canonical.

    Pass wy_cat (and wy_limbs=None) for the 3-wide-dot grouping, or
    wy_limbs [3, L*N, K*N] alone for the 9-dot split form (the verify
    path; pinned equal to the cat form in tests/test_mxu.py)."""
    yc = center(y)  # int32, |.| <= q/2
    y0 = ((yc + 128) % 256) - 128
    r = (yc - y0) >> 8
    y1 = ((r + 128) % 256) - 128
    y2 = (r - y1) >> 8
    ylimbs = [y0.astype(_I8), y1.astype(_I8), y2.astype(_I8)]
    prods = {}  # power -> int32 sum
    if wy_cat is not None:
        # 3 wide dots (limb i of y against ALL weight limbs at once)
        kn = wy_cat.shape[-1] // 3
        for i in range(3):
            p3 = _dot_i8(ylimbs[i], wy_cat)  # [B, 3*KN]
            for j in range(3):
                pij = p3[..., j * kn:(j + 1) * kn]
                k = i + j
                prods[k] = pij if k not in prods else prods[k] + pij
    else:
        for i in range(3):
            for j in range(3):
                pij = _dot_i8(ylimbs[i], wy_limbs[j])
                k = i + j
                prods[k] = pij if k not in prods else prods[k] + pij
    return _recombine(
        prods[0], prods[1], prods[2], prods[3], prods[4]
    )


def _sign_attempt_mxu(ops: KeyOperators, mu, rhoprime, kappa,
                      p: DilithiumParams):
    """One candidate per lane using the dense operators. Mirrors
    scheme._sign_attempt bit-for-bit (pinned by tests/test_mxu.py)."""
    B = mu.shape[0]
    L, K = p.L, p.K
    y = sampling.expand_mask(rhoprime, kappa, p)  # [B, L, 256]
    y_cent = center(y).astype(_I32)
    w = _apply_wy(y.reshape(B, L * N), None, p,
                  ops.wy_cat).reshape(B, K, N)
    w1, w0 = rounding.decompose(w, p)

    w1_packed = pack.pack_w1(w1, p).reshape(B, K * p.polyw1_packedbytes)
    c_tilde = keccak.shake256(
        jnp.concatenate([mu.astype(_U8), w1_packed], axis=-1), 32
    )
    c, ok_ball = sampling.sample_in_ball(c_tilde, p)  # canonical {0,1,q-1}
    c_i8 = center(c).astype(_I8)  # {0, +-1}

    ln, kn = L * N, K * N
    prod = _dot_i8(c_i8, ops.c_cat)  # [B, (L+3K)*N]
    cs1 = prod[..., :ln].reshape(B, L, N)         # int32, |.| <= beta
    cs2 = prod[..., ln:ln + kn].reshape(B, K, N)  # |.| <= beta
    ct0_lo = prod[..., ln + kn:ln + 2 * kn]
    ct0_hi = prod[..., ln + 2 * kn:]

    z = uncenter(y_cent + cs1)
    rej_z = rounding.norm_exceeds(z, p.gamma1 - p.beta, axis=(-2, -1))

    w0_cs2 = w0 - cs2
    rej_w0 = rounding.norm_exceeds(w0_cs2, p.gamma2 - p.beta, axis=(-2, -1))

    ct0 = (ct0_lo + (ct0_hi << 7)).reshape(B, K, N)  # exact, |.| <= tau*2^12
    rej_t0 = rounding.norm_exceeds(ct0, p.gamma2, axis=(-2, -1))

    hint_a0 = w0_cs2 + ct0
    h = rounding.make_hint(hint_a0, w1, p)
    nhints = jnp.sum(h, axis=(-2, -1))
    rej_h = nhints > jnp.uint32(p.omega)

    accept = ~(rej_z | rej_w0 | rej_t0 | rej_h) & ok_ball
    return c_tilde, z, h, accept


@partial(jax.jit, static_argnames=("p", "window", "max_rounds"))
def sign_stream_mxu(
    ops: KeyOperators,
    mu: jnp.ndarray,
    p: DilithiumParams,
    window: int = 768,
    max_rounds: int = 8192,
    rhoprime: jnp.ndarray | None = None,
) -> scheme.SignResult:
    """Elastic-scheduler stream signer over the MXU operators — same loop
    as `scheme.sign_stream` (shared `_stream_loop`), with the attempt body
    running on dense int8 matmuls instead of the NTT pipeline. Pass
    uniformly random `rhoprime` uint8 [Q, 64] for randomized signing
    (`scheme.sign` docstring, docs/SECURITY.md)."""
    Q_ = mu.shape[0]
    W = min(window, Q_)

    if rhoprime is None:
        key_b = jnp.broadcast_to(ops.key, (Q_,) + ops.key.shape)
        rhoprime = keccak.shake256(
            jnp.concatenate([key_b.astype(_U8), mu.astype(_U8)], axis=-1), CRHBYTES
        )
    else:
        scheme.validate_rhoprime(rhoprime, mu.shape)

    def attempt(mu_s, rp_s, kappa_s, q_s):
        del q_s  # one key: operators are slot-invariant
        return _sign_attempt_mxu(ops, mu_s, rp_s, kappa_s, p)

    return scheme._stream_loop(attempt, mu, rhoprime, p, W, max_rounds)


# ---------------------------------------------------------------------------
# Dense-operator VERIFY: w' = A.z - c.(t1 * 2^d) is linear in (z, c) for a
# fixed public key, so the whole VY_MULT_AZ/VY_MULT_CT1/VY_SUB_AZ_CT1/VY_INTT
# chain (`combined_top.v:1346-1469`) collapses to int8 matmuls against the
# SAME z->Az matrix the signer uses for y->w, plus 3 tiny c @ T1-limb
# products (c has entries {0, +-1}).
# ---------------------------------------------------------------------------


class VerifyOperators(NamedTuple):
    """Dense per-public-key verify operators."""
    wz_limbs: jnp.ndarray  # int8 [3, L*256, K*256] — z -> Az map limbs
    t1_limbs: jnp.ndarray  # int8 [3, 256, K*256] — c -> c.(t1<<d) conv limbs
    tr: jnp.ndarray        # uint8 [32] (mu = CRH(tr || M) precursor)


@partial(jax.jit, static_argnames=("p",))
def build_verify_operators(pk: jnp.ndarray, p: DilithiumParams) -> VerifyOperators:
    """Expand one UNBATCHED pk into dense MXU verify operators."""
    rho, t1 = pack.unpack_pk(pk, p)
    a_hat, ok_a = sampling.expand_a(rho, p)
    sampling.debug_check_ok(ok_a, "build_verify_operators.expand_a")
    wz_limbs = _wy_limbs_from_ahat(a_hat, p)

    # t1 << d <= q-1 stays canonical; conv matrix of the CENTERED values,
    # then balanced base-256 limbs (limbs AFTER the negacyclic sign flip,
    # as for W — a flipped -128 digit would overflow int8 the other way)
    t1s = center((t1.astype(_U32) << D))  # [K, N] int32, |.| <= q/2
    t1_mat = jnp.concatenate(
        [_conv_matrix(t1s[k]) for k in range(p.K)], axis=-1
    )  # [N, K*N] int32
    t1_limbs = jnp.stack(_to_limbs_i8(t1_mat))  # [3, N, K*N]

    tr = keccak.shake256(pk, TRBYTES)
    return VerifyOperators(wz_limbs, t1_limbs, tr)


@partial(jax.jit, static_argnames=("p",))
def verify_mxu(
    vops: VerifyOperators, sig: jnp.ndarray, mu: jnp.ndarray, p: DilithiumParams
) -> jnp.ndarray:
    """Verify a batch of signatures under ONE key's dense operators.

    sig uint8 [B, sig_bytes], mu uint8 [B, 64] -> bool [B]. Bit-identical
    accept/reject to `scheme.verify` (pinned by tests/test_mxu.py).
    """
    B = mu.shape[0]
    K, L = p.K, p.L
    c_tilde, z, h, h_ok = pack.unpack_sig(sig, p)
    z_ok = ~rounding.norm_exceeds(z, p.gamma1 - p.beta, axis=(-2, -1))

    c, _ = sampling.sample_in_ball(c_tilde, p)
    c_i8 = center(c).astype(_I8)  # {0, +-1}

    az = _apply_wy(z.reshape(B, L * N), vops.wz_limbs, p)  # [B, K*N] canonical

    # ct1 = sum_j 2^(8j) (c @ T1_j): |c @ T1_j| <= tau*128 <= 7680, so the
    # Horner-free direct sum fits int32 (|.| <= ~5.05e8) and _mod_q_i32's
    # domain
    p0 = _dot_i8(c_i8, vops.t1_limbs[0])
    p1 = _dot_i8(c_i8, vops.t1_limbs[1])
    p2 = _dot_i8(c_i8, vops.t1_limbs[2])
    ct1 = _mod_q_i32(p0 + (p1 << 8) + (p2 << 16))  # [B, K*N] canonical

    w = sub_mod(az, ct1).reshape(B, K, N)
    return scheme._verify_tail(w, h, c_tilde, mu, z_ok & h_ok, p)
