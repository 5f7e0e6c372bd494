"""Multi-chip sharding tests on the 8-device virtual CPU mesh.

No reference analog (the FPGA is single-chip); mandated by SURVEY.md §4's
test plan item (d): sharded batch + gather, psum counters, and agreement
with the single-chip path.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from dilithium_tpu import params, scheme
from dilithium_tpu.parallel import (
    make_mesh, sharded_keygen, sharded_sign, sharded_verify, throughput_counters,
)

LEVEL = 2
RNG = np.random.default_rng(7)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(jax.devices())


@pytest.fixture(scope="module")
def data(mesh):
    batch = 8
    seed = RNG.integers(0, 256, size=(batch, 32), dtype=np.uint8)
    mu = RNG.integers(0, 256, size=(batch, 64), dtype=np.uint8)
    sh = NamedSharding(mesh, P("batch", None))
    return jax.device_put(seed, sh), jax.device_put(mu, sh)


def test_sharded_pipeline_matches_single_chip(mesh, data):
    p = params.get_params(LEVEL)
    seed, mu = data

    pk, sk, kg_ok = sharded_keygen(mesh, p)(seed)
    assert np.asarray(kg_ok).all()
    res = sharded_sign(mesh, p, attempts_per_round=2, max_rounds=64)(sk, mu)
    assert np.asarray(res.ok).all()
    ok, total = sharded_verify(mesh, p)(pk, res.sig, mu)
    assert np.asarray(ok).all()
    assert int(total) == 8
    assert int(res.total_signed) == 8

    c = throughput_counters(res)
    assert c["signed"] == 8 and c["mean_attempts"] >= 1.0

    # bit-identical to the unsharded path (batch packing must not matter)
    kp = scheme.keygen(seed, p)
    np.testing.assert_array_equal(np.asarray(pk), np.asarray(kp.pk))
    ref = scheme.sign(kp.sk, mu, p, attempts_per_round=2, max_rounds=64)
    np.testing.assert_array_equal(np.asarray(res.sig), np.asarray(ref.sig))


def test_replicated_key_sign(mesh, data):
    p = params.get_params(LEVEL)
    seed, mu = data
    kp = scheme.keygen(seed[0], p)
    res = sharded_sign(
        mesh, p, attempts_per_round=2, max_rounds=64, replicate_key=True
    )(kp.sk, mu)
    assert np.asarray(res.ok).all()
    ok, total = sharded_verify(mesh, p, replicate_key=True)(kp.pk, res.sig, mu)
    assert np.asarray(ok).all() and int(total) == 8


def test_sharding_layout(mesh, data):
    p = params.get_params(LEVEL)
    seed, mu = data
    pk, sk, _ = sharded_keygen(mesh, p)(seed)
    # outputs stay batch-sharded on all 8 devices — no implicit gather
    assert len(sk.sharding.device_set) == 8
    res = sharded_sign(mesh, p, attempts_per_round=2, max_rounds=64)(sk, mu)
    assert len(res.sig.sharding.device_set) == 8
    assert res.total_signed.sharding.is_fully_replicated


def test_sharded_sign_stream_matches_single_chip(mesh, data):
    """One replicated key, queue sharded over 8 devices; both stream
    backends (generic NTT and MXU dense operators) must produce the same
    bytes as the single-chip lockstep signer."""
    from dilithium_tpu import mxu
    from dilithium_tpu.parallel import sharded_sign_stream

    p = params.get_params(LEVEL)
    seed, mu = data
    kp = scheme.keygen(seed[0], p)
    ref = scheme.sign(
        jnp.broadcast_to(kp.sk, (8,) + kp.sk.shape), mu, p,
        attempts_per_round=2, max_rounds=64,
    )

    ek = scheme.expand_sk(kp.sk, p)
    res = sharded_sign_stream(mesh, p, window=1, max_rounds=512,
                              use_mxu=False)(ek, mu)
    assert np.asarray(res.ok).all()
    np.testing.assert_array_equal(np.asarray(res.sig), np.asarray(ref.sig))
    assert int(res.total_signed) == 8
    assert int(res.total_attempts) == int(np.asarray(ref.attempts).sum())

    ops = mxu.build_operators(kp.sk, p)
    res2 = sharded_sign_stream(mesh, p, window=1, max_rounds=512,
                               use_mxu=True)(ops, mu)
    assert np.asarray(res2.ok).all()
    np.testing.assert_array_equal(np.asarray(res2.sig), np.asarray(ref.sig))


def test_sharded_verify_stream(mesh, data):
    """One-key verify service: both backends accept the batch, reject
    corruption, and psum the right total."""
    from dilithium_tpu import mxu
    from dilithium_tpu.parallel import sharded_verify_stream

    p = params.get_params(LEVEL)
    seed, mu = data
    kp = scheme.keygen(seed[0], p)
    res = scheme.sign(
        jnp.broadcast_to(kp.sk, (8,) + kp.sk.shape), mu, p,
        attempts_per_round=2, max_rounds=64,
    )
    sh = NamedSharding(mesh, P("batch", None))
    sig = jax.device_put(np.asarray(res.sig), sh)

    epk = scheme.expand_pk(kp.pk, p)
    ok, total = sharded_verify_stream(mesh, p, use_mxu=False)(epk, sig, mu)
    assert np.asarray(ok).all() and int(total) == 8

    vops = mxu.build_verify_operators(kp.pk, p)
    ok2, total2 = sharded_verify_stream(mesh, p, use_mxu=True)(vops, sig, mu)
    assert np.asarray(ok2).all() and int(total2) == 8

    bad = np.asarray(res.sig).copy()
    bad[:, 50] ^= 1
    bad = jax.device_put(bad, sh)
    ok3, total3 = sharded_verify_stream(mesh, p, use_mxu=True)(vops, bad, mu)
    assert not np.asarray(ok3).any() and int(total3) == 0


def test_sharded_sign_stream_keys_matches_single_chip(mesh, data):
    """Independent-keys stream service: replicated batched ExpandedKey,
    sharded key_idx + queue; bit-identical to unsharded sign_stream_keys
    and to lockstep sign under the matching per-message sk."""
    from dilithium_tpu.parallel import sharded_sign_stream_keys

    p = params.get_params(LEVEL)
    seed, mu = data
    batch = mu.shape[0]
    kp = scheme.keygen(seed, p)
    eks = scheme.expand_sk(kp.sk[:3], p)  # 3 distinct keys
    key_idx_np = (np.arange(batch) % 3).astype(np.int32)
    key_idx = jax.device_put(key_idx_np, NamedSharding(mesh, P("batch")))

    res = sharded_sign_stream_keys(mesh, p, window=1, max_rounds=512)(
        eks, key_idx, mu
    )
    assert np.asarray(res.ok).all()
    assert int(res.total_signed) == batch

    ref = scheme.sign(
        jnp.take(kp.sk, jnp.asarray(key_idx_np), axis=0), mu, p,
        attempts_per_round=2, max_rounds=64,
    )
    np.testing.assert_array_equal(np.asarray(res.sig), np.asarray(ref.sig))


@pytest.mark.parametrize("service", [
    "keygen", "sign", "verify", "sign_stream", "verify_stream", "sign_stream_keys",
])
def test_sharded_services_lower_with_gpu_kernel(mesh, service):
    """Every sharded service traces and lowers for CUDA with the Keccak
    kernel inside shard_map: the kernel's output must carry the varying
    mesh axes of its input (shard_map's check_vma), which the CPU's jnp
    path never exercises."""
    from dilithium_tpu import mxu
    from dilithium_tpu.ops import keccak
    from dilithium_tpu.parallel import (
        sharded_sign_stream, sharded_sign_stream_keys, sharded_verify_stream,
    )

    p = params.get_params(LEVEL)
    S, u8, B = jax.ShapeDtypeStruct, jnp.uint8, 16
    mu, sig = S((B, 64), u8), S((B, p.sig_bytes), u8)
    with keccak.use_impl("kernel"):
        fn, args = {
            "keygen": lambda: (sharded_keygen(mesh, p), (S((B, 32), u8),)),
            "sign": lambda: (sharded_sign(mesh, p), (S((B, p.sk_bytes), u8), mu)),
            "verify": lambda: (sharded_verify(mesh, p), (S((B, p.pk_bytes), u8), sig, mu)),
            "sign_stream": lambda: (sharded_sign_stream(mesh, p, window=2), (
                jax.eval_shape(lambda sk: mxu.build_operators(sk, p),
                               S((p.sk_bytes,), u8)), mu)),
            "verify_stream": lambda: (sharded_verify_stream(mesh, p), (
                jax.eval_shape(lambda pk: mxu.build_verify_operators(pk, p),
                               S((p.pk_bytes,), u8)), sig, mu)),
            "sign_stream_keys": lambda: (sharded_sign_stream_keys(mesh, p, window=2), (
                jax.eval_shape(lambda sk: scheme.expand_sk(sk, p), S((3, p.sk_bytes), u8)),
                S((B,), jnp.int32), mu)),
        }[service]()
        text = fn.trace(*args).lower(lowering_platforms=("cuda",)).as_text()
    assert "xla.gpu.triton" in text
