"""Differential tests: JAX device path vs the C++ host oracle.

Random seeds/messages (not just the shipped KATs) — the analog of the
reference's randomized C++ self-tests (`ntt2x2_test.cpp:139-197`, 1M
random iterations) extended to the full scheme.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from dilithium_tpu import oracle, params, scheme
from dilithium_tpu.ops import ntt as jntt

RNG = np.random.default_rng(8)
Q = params.Q


def test_ntt_matches_oracle():
    x = RNG.integers(0, Q, size=(8, 256), dtype=np.int64).astype(np.int32)
    got = np.asarray(jntt.ntt(jnp.asarray(x.astype(np.uint32)))).astype(np.int32)
    exp = oracle.ntt(x)
    np.testing.assert_array_equal(got, exp)


def test_invntt_matches_oracle():
    x = RNG.integers(0, Q, size=(8, 256), dtype=np.int64).astype(np.int32)
    got = np.asarray(
        jntt.invntt(jnp.asarray(x.astype(np.uint32)), from_product=False)
    ).astype(np.int32)
    exp = oracle.invntt(x)
    np.testing.assert_array_equal(got, exp)


def test_pointwise_matches_oracle():
    a = RNG.integers(0, Q, size=(4, 256), dtype=np.int64).astype(np.int32)
    b = RNG.integers(0, Q, size=(4, 256), dtype=np.int64).astype(np.int32)
    got = np.asarray(
        jntt.pointwise(jnp.asarray(a.astype(np.uint32)), jnp.asarray(b.astype(np.uint32)))
    ).astype(np.int32)
    np.testing.assert_array_equal(got, oracle.pointwise(a, b))


@pytest.mark.parametrize("level", [2, 3, 5])
def test_scheme_matches_oracle_random_inputs(level):
    p = params.get_params(level)
    batch = 3
    seeds = RNG.integers(0, 256, size=(batch, 32), dtype=np.uint8)
    mus = RNG.integers(0, 256, size=(batch, 64), dtype=np.uint8)

    pk_o, sk_o = oracle.keygen(level, seeds)
    kp = scheme.keygen(jnp.asarray(seeds), p)
    np.testing.assert_array_equal(np.asarray(kp.pk), pk_o)
    np.testing.assert_array_equal(np.asarray(kp.sk), sk_o)

    sig_o, att_o = oracle.sign(level, sk_o, mus)
    res = scheme.sign(kp.sk, jnp.asarray(mus), p)
    np.testing.assert_array_equal(np.asarray(res.sig), sig_o)
    np.testing.assert_array_equal(np.asarray(res.attempts), att_o)

    assert oracle.verify(level, pk_o, mus, sig_o).all()
    assert np.asarray(scheme.verify(kp.pk, res.sig, jnp.asarray(mus), p)).all()

    # cross: oracle verifies device signatures and vice versa (trivially the
    # same bytes, but guards against accidental layout divergence)
    assert oracle.verify(level, np.asarray(kp.pk), mus, np.asarray(res.sig)).all()


def test_ntt2x2_model():
    """2x2-NTT algorithmic model (cpp/ntt2x2.cpp): fused 2-stage passes,
    div2-folded inverse, and the BRAM line-layout mapping chains — the
    replay of the reference's own model-layer tests
    (`ref_test_ntt_ntt2x2.cpp`, `ntt2x2_test.cpp`). Full-depth runs via
    `make -C cpp test` (20k iterations, ~1 s)."""
    import os
    import subprocess

    cpp = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "cpp")
    subprocess.run(["make", "-s", "-C", cpp, "ntt2x2_test"], check=True)
    out = subprocess.run(
        [os.path.join(cpp, "ntt2x2_test"), "500"],
        check=True, capture_output=True, text=True,
    ).stdout
    assert "differential tests OK" in out


def test_crh_batch_matches_hashlib():
    """Native multithreaded mu batch == hashlib, per-message and shared
    tr, ragged lengths including empty."""
    import hashlib
    from dilithium_tpu import oracle

    rng = np.random.default_rng(11)
    msgs = [
        rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
        for n in rng.integers(0, 500, 40)
    ] + [b""]
    trs = rng.integers(0, 256, (len(msgs), 32), dtype=np.uint8)
    mus = oracle.crh_batch(trs, msgs, nthreads=3)
    for i, m in enumerate(msgs):
        h = hashlib.shake_256()
        h.update(trs[i].tobytes())
        h.update(m)
        assert mus[i].tobytes() == h.digest(64), i
    # shared tr form
    mus1 = oracle.crh_batch(trs[0], msgs)
    h = hashlib.shake_256()
    h.update(trs[0].tobytes())
    h.update(msgs[3])
    assert mus1[3].tobytes() == h.digest(64)


def test_crh_batch_wide_itemsize_messages():
    """Offsets must come from the CONVERTED byte length, not len(m):
    a memoryview/ndarray with itemsize > 1 has len(m) = element count but
    bytes(m) = itemsize * len(m) bytes (mixing the two
    misaligned every message after the first wide one)."""
    import hashlib
    from dilithium_tpu import oracle

    rng = np.random.default_rng(7)
    tr = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
    wide = rng.integers(0, 2**31, 37, dtype=np.int64)  # 37 elems, 296 bytes
    msgs = [
        rng.integers(0, 256, 100, dtype=np.uint8).tobytes(),
        memoryview(wide),                  # itemsize 8: len() != nbytes
        wide,                              # ndarray directly (buffer proto)
        rng.integers(0, 256, 55, dtype=np.uint8).tobytes(),
    ]
    mus = oracle.crh_batch(np.frombuffer(tr, dtype=np.uint8), msgs)
    for i, m in enumerate(msgs):
        h = hashlib.shake_256()
        h.update(tr)
        h.update(bytes(m))
        assert mus[i].tobytes() == h.digest(64), i


def test_compute_mu_many_wide_itemsize_matches_hashlib_path():
    """api.compute_mu_many must agree between the native crh_batch branch
    (n >= 64) and the hashlib loop (n < 64) for wide-itemsize inputs."""
    from dilithium_tpu import api

    rng = np.random.default_rng(8)
    tr = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
    msgs = [memoryview(rng.integers(0, 2**31, 5, dtype=np.int64))
            for _ in range(70)]
    big = api.compute_mu_many(tr, msgs)          # native branch
    small = np.stack([
        np.frombuffer(api.compute_mu(tr, m), dtype=np.uint8) for m in msgs
    ])
    np.testing.assert_array_equal(big, small)
