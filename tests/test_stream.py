"""sign_stream (refill-queue signer) must be bit-identical to sign.

Lane packing / window size must not affect any signature: each message's
kappa sequence is independent (`expandmask_ext.v:287-293`).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from dilithium_tpu import params, scheme

LEVEL = 2
RNG = np.random.default_rng(9)


@pytest.fixture(scope="module")
def ctx():
    p = params.get_params(LEVEL)
    seed = jnp.asarray(RNG.integers(0, 256, size=(32,), dtype=np.uint8))
    kp = scheme.keygen(seed, p)
    ek = scheme.expand_sk(kp.sk, p)
    mus = jnp.asarray(RNG.integers(0, 256, size=(12, 64), dtype=np.uint8))
    ref = scheme.sign_expanded(ek, mus, p, attempts_per_round=2, max_rounds=64)
    return p, kp, ek, mus, ref


@pytest.mark.parametrize("window", [3, 12])
def test_stream_matches_sign(ctx, window):
    p, kp, ek, mus, ref = ctx
    res = scheme.sign_stream(ek, mus, p, window=window, max_rounds=512)
    assert np.asarray(res.ok).all()
    np.testing.assert_array_equal(np.asarray(res.sig), np.asarray(ref.sig))
    np.testing.assert_array_equal(np.asarray(res.attempts), np.asarray(ref.attempts))


def test_stream_drain_double_accept(ctx):
    """Regression: an elastic drain round where one item accepts at TWO
    speculative kappa slots must append exactly one log entry.

    With window == Q the queue is exhausted at round 0, so every round
    after the first commit is an elastic drain round with W // n_active
    speculative attempts per item — at L2's ~23% per-attempt accept rate
    a double accept is near-certain across 24 items. The old code advanced
    the log by accepting-SLOT count, appending bogus rows that target
    queue item 0 with attempts 0 (item 0 then reads back unsigned).
    """
    p, kp, ek, _, _ = ctx
    mus = jnp.asarray(RNG.integers(0, 256, size=(24, 64), dtype=np.uint8))
    ref = scheme.sign_expanded(ek, mus, p, attempts_per_round=2, max_rounds=256)
    res = scheme.sign_stream(ek, mus, p, window=24, max_rounds=1024)
    assert np.asarray(res.ok).all()
    np.testing.assert_array_equal(np.asarray(res.attempts), np.asarray(ref.attempts))
    np.testing.assert_array_equal(np.asarray(res.sig), np.asarray(ref.sig))


def test_stream_signatures_verify(ctx):
    p, kp, ek, mus, ref = ctx
    res = scheme.sign_stream(ek, mus, p, window=5, max_rounds=512)
    pk = jnp.broadcast_to(kp.pk, (12,) + kp.pk.shape)
    ok = scheme.verify(pk, res.sig, mus, p)
    assert np.asarray(ok).all()


@pytest.mark.parametrize("window", [5, 12])
def test_stream_keys_matches_sign(ctx, window):
    """Independent-keys elastic signer: N distinct keys x M messages must
    be bit-identical to the lockstep `sign` under the matching per-message
    sk (the reference streams a fresh key every invocation,
    `tb_sign_top.v:171-283`)."""
    p, _, _, mus, _ = ctx
    nkeys = 3
    seeds = jnp.asarray(RNG.integers(0, 256, size=(nkeys, 32), dtype=np.uint8))
    kps = scheme.keygen(seeds, p)
    eks = scheme.expand_sk(kps.sk, p)  # batched over the key axis
    key_idx = jnp.asarray(
        RNG.integers(0, nkeys, size=(mus.shape[0],), dtype=np.int32)
    )
    ref = scheme.sign(
        jnp.take(kps.sk, key_idx, axis=0), mus, p,
        attempts_per_round=2, max_rounds=64,
    )
    res = scheme.sign_stream_keys(
        eks, key_idx, mus, p, window=window, max_rounds=512
    )
    assert np.asarray(res.ok).all()
    np.testing.assert_array_equal(np.asarray(res.sig), np.asarray(ref.sig))
    np.testing.assert_array_equal(
        np.asarray(res.attempts), np.asarray(ref.attempts)
    )
    # and the signatures verify under each message's own public key
    ok = scheme.verify(jnp.take(kps.pk, key_idx, axis=0), res.sig, mus, p)
    assert np.asarray(ok).all()

    # sort_by_key (queue pre-sorted by key, results un-permuted) must be
    # bit-identical: signatures, attempts AND ordering
    res_s = scheme.sign_stream_keys(
        eks, key_idx, mus, p, window=window, max_rounds=512, sort_by_key=True
    )
    np.testing.assert_array_equal(np.asarray(res_s.sig), np.asarray(ref.sig))
    np.testing.assert_array_equal(
        np.asarray(res_s.attempts), np.asarray(ref.attempts)
    )
    assert np.asarray(res_s.ok).all()


def test_shared_rhoprime_rejected(ctx):
    """A rhoprime that would broadcast across messages must be rejected:
    two messages accepting at the same kappa under one rhoprime leak
    s1 = (z1 - z2)/(c1 - c2) — classic nonce reuse."""
    p, kp, ek, mus, _ = ctx
    shared = jnp.zeros((64,), dtype=jnp.uint8)
    with pytest.raises(ValueError, match="rhoprime"):
        scheme.sign_expanded(ek, mus, p, rhoprime=shared)
    with pytest.raises(ValueError, match="rhoprime"):
        scheme.sign_stream(ek, mus, p, window=3, rhoprime=shared[None, :])
    # wrong dtype must be rejected too, not silently cast
    with pytest.raises(ValueError, match="uint8"):
        scheme.sign_stream(
            ek, mus, p, window=3, rhoprime=jnp.zeros(mus.shape, dtype=jnp.int32)
        )
    # correctly-shaped per-message rhoprime is accepted and verifies
    rp = jnp.asarray(RNG.integers(0, 256, size=mus.shape, dtype=np.uint8))
    res = scheme.sign_stream(ek, mus, p, window=12, max_rounds=1024, rhoprime=rp)
    assert np.asarray(res.ok).all()
    pk = jnp.broadcast_to(kp.pk, (mus.shape[0],) + kp.pk.shape)
    assert np.asarray(scheme.verify(pk, res.sig, mus, p)).all()
