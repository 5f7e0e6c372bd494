"""MXU dense-operator signing path vs the generic NTT path — bit-exact."""

import numpy as np
import jax.numpy as jnp
import pytest

from dilithium_tpu import mxu, params, scheme
from dilithium_tpu.ops import ntt
from dilithium_tpu.ops.reduce import center

LEVEL = 2
RNG = np.random.default_rng(11)
Q = params.Q


def test_mod_q_i32_exact():
    x = RNG.integers(-1_200_000_000, 1_200_000_000, size=(1 << 16,), dtype=np.int64)
    got = np.asarray(mxu._mod_q_i32(jnp.asarray(x.astype(np.int32))))
    np.testing.assert_array_equal(got, (x % Q).astype(np.uint32))


def test_limb_split_exact():
    x = RNG.integers(-(Q // 2), Q // 2 + 1, size=(4096,), dtype=np.int64).astype(np.int32)
    d0, d1, d2 = mxu._to_limbs_i8(jnp.asarray(x))
    recon = (
        np.asarray(d0).astype(np.int64)
        + 256 * np.asarray(d1).astype(np.int64)
        + 65536 * np.asarray(d2).astype(np.int64)
    )
    np.testing.assert_array_equal(recon, x)
    for d in (d0, d1, d2):
        assert np.asarray(d).dtype == np.int8


@pytest.fixture(scope="module")
def key_ctx():
    p = params.get_params(LEVEL)
    seed = jnp.asarray(RNG.integers(0, 256, size=(32,), dtype=np.uint8))
    kp = scheme.keygen(seed, p)
    ek = scheme.expand_sk(kp.sk, p)
    ops = mxu.build_operators(kp.sk, p)
    return p, kp, ek, ops


def test_apply_wy_matches_ntt_pipeline(key_ctx):
    p, kp, ek, ops = key_ctx
    B = 4
    y = jnp.asarray(
        RNG.integers(0, Q, size=(B, p.L, 256), dtype=np.int64).astype(np.uint32)
    )
    w_ref = ntt.invntt(
        ntt.matvec(jnp.broadcast_to(ek.a_hat, (B,) + ek.a_hat.shape), ntt.ntt(y)),
        from_product=True,
    )
    w_got = mxu._apply_wy(y.reshape(B, -1), ops.wy_limbs, p).reshape(B, p.K, 256)
    np.testing.assert_array_equal(np.asarray(w_got), np.asarray(w_ref))


def test_conv_matrix_matches_poly_mul(key_ctx):
    p, kp, ek, ops = key_ctx
    c_full = jnp.asarray(
        RNG.integers(0, 2, size=(3, 256), dtype=np.int64).astype(np.uint32)
    )  # {0, 1} poly
    prod_ref = ntt.poly_mul(c_full, jnp.broadcast_to(kp.s1[0], (3, 256)))
    # compare via the s1 conv matrix, first poly block
    c_i8 = center(c_full).astype(jnp.int8)
    got = mxu._dot_i8(c_i8, ops.s1_mat)[:, :256]
    ref_c = np.asarray(center(prod_ref)).astype(np.int64)
    np.testing.assert_array_equal(np.asarray(got).astype(np.int64), ref_c)


def test_sign_stream_mxu_matches_generic(key_ctx):
    p, kp, ek, ops = key_ctx
    mus = jnp.asarray(RNG.integers(0, 256, size=(10, 64), dtype=np.uint8))
    ref = scheme.sign_stream(ek, mus, p, window=4, max_rounds=512)
    got = mxu.sign_stream_mxu(ops, mus, p, window=4, max_rounds=512)
    assert np.asarray(got.ok).all()
    np.testing.assert_array_equal(np.asarray(got.sig), np.asarray(ref.sig))
    np.testing.assert_array_equal(np.asarray(got.attempts), np.asarray(ref.attempts))


def test_verify_mxu_matches_generic(key_ctx):
    p, kp, ek, ops = key_ctx
    mus = jnp.asarray(RNG.integers(0, 256, size=(6, 64), dtype=np.uint8))
    res = mxu.sign_stream_mxu(ops, mus, p, window=4, max_rounds=512)
    vops = mxu.build_verify_operators(kp.pk, p)

    # valid signatures accept; a corrupted batch matches scheme.verify
    sigs = np.asarray(res.sig)
    bad = sigs.copy()
    bad[0, 40] ^= 1            # flip a z byte
    bad[1, 3] ^= 0x80          # flip a c_tilde bit
    bad[2, -1] ^= 1            # corrupt hint section
    for s in (sigs, bad):
        pk_b = jnp.broadcast_to(kp.pk, (6,) + kp.pk.shape)
        ref = np.asarray(scheme.verify(pk_b, jnp.asarray(s), mus, p))
        got = np.asarray(mxu.verify_mxu(vops, jnp.asarray(s), mus, p))
        np.testing.assert_array_equal(got, ref)
    assert np.asarray(mxu.verify_mxu(vops, res.sig, mus, p)).all()


@pytest.mark.parametrize("level", [3, 5])
def test_mxu_sign_verify_other_levels(level):
    """Dense-operator sign AND verify pinned bit-exact at the other two
    parameter sets (K/L/gamma/omega all differ; a shape- or
    constant-dependent bug in the operator builders would hide at
    LEVEL=2 only)."""
    p = params.get_params(level)
    seed = jnp.asarray(RNG.integers(0, 256, size=(32,), dtype=np.uint8))
    kp = scheme.keygen(seed, p)
    ek = scheme.expand_sk(kp.sk, p)
    ops = mxu.build_operators(kp.sk, p)
    mus = jnp.asarray(RNG.integers(0, 256, size=(3, 64), dtype=np.uint8))
    ref = scheme.sign_stream(ek, mus, p, window=3, max_rounds=512)
    got = mxu.sign_stream_mxu(ops, mus, p, window=3, max_rounds=512)
    assert np.asarray(got.ok).all()
    np.testing.assert_array_equal(np.asarray(got.sig), np.asarray(ref.sig))

    vops = mxu.build_verify_operators(kp.pk, p)
    assert np.asarray(mxu.verify_mxu(vops, got.sig, mus, p)).all()
    bad = np.asarray(got.sig).copy()
    bad[:, 33] ^= 1
    assert not np.asarray(mxu.verify_mxu(vops, jnp.asarray(bad), mus, p)).any()


def test_verify_expanded_matches_generic(key_ctx):
    p, kp, ek, ops = key_ctx
    mus = jnp.asarray(RNG.integers(0, 256, size=(4, 64), dtype=np.uint8))
    res = mxu.sign_stream_mxu(ops, mus, p, window=4, max_rounds=512)
    epk = scheme.expand_pk(kp.pk, p)
    np.testing.assert_array_equal(np.asarray(epk.tr), np.asarray(kp.tr))
    got = np.asarray(scheme.verify_expanded(epk, res.sig, mus, p))
    assert got.all()
    bad = np.asarray(res.sig).copy()
    bad[:, 100] ^= 0xFF
    assert not np.asarray(
        scheme.verify_expanded(epk, jnp.asarray(bad), mus, p)
    ).any()


def test_key_operator_views_consistent(key_ctx):
    """The slicing properties (wy_limbs/s1_mat/s2_mat/t0_lo/t0_hi) must
    tile the stored concatenations exactly — the split/cat matmul
    groupings read the same bytes."""
    p, kp, ek, ops = key_ctx
    ln, kn = p.L * 256, p.K * 256
    wy = np.asarray(ops.wy_cat)
    assert wy.shape == (ln, 3 * kn)
    limbs = np.asarray(ops.wy_limbs)
    for j in range(3):
        np.testing.assert_array_equal(limbs[j], wy[:, j * kn:(j + 1) * kn])
    cc = np.asarray(ops.c_cat)
    assert cc.shape == (256, ln + 3 * kn)
    np.testing.assert_array_equal(np.asarray(ops.s1_mat), cc[:, :ln])
    np.testing.assert_array_equal(np.asarray(ops.s2_mat), cc[:, ln:ln + kn])
    np.testing.assert_array_equal(
        np.asarray(ops.t0_lo), cc[:, ln + kn:ln + 2 * kn]
    )
    np.testing.assert_array_equal(np.asarray(ops.t0_hi), cc[:, ln + 2 * kn:])
    # and the limb recombination reconstructs centered W entries exactly
    w_full = (
        limbs[0].astype(np.int64)
        + 256 * limbs[1].astype(np.int64)
        + 65536 * limbs[2].astype(np.int64)
    )
    assert np.abs(w_full).max() <= (Q - 1) // 2
