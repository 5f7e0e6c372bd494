"""GPU Keccak kernel (`keccak_triton`) in Pallas interpret mode vs hashlib.

The kernel compiles only for a GPU; `interpret=True` runs the same kernel
body through the Pallas interpreter on the CPU, so these cases pin its
sponge schedule and padding bit for bit. Each shape is one the scheme
uses.
"""

import hashlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from dilithium_tpu.ops import keccak, keccak_triton

RNG = np.random.default_rng(11)


def _kernel_words(msgs, out_words, rate, domain=0x1F):
    return np.asarray(keccak._shake_words_kernel(
        jnp.asarray(msgs), out_words, rate, domain, interpret=True))


@pytest.mark.parametrize("msg_len,out_words,rate", [
    (34, 252, 168),   # ExpandA: rho || nonce, SHAKE128, 6 squeeze blocks
    (66, 160, 136),   # ExpandMask: rhoprime || nonce, SHAKE256
    (832, 8, 136),    # c_tilde: mu || w1 (level 3), 7 absorb blocks
    (32, 68, 136),    # SampleInBall: c_tilde, 2 squeeze blocks
    (96, 16, 136),    # rhoprime = CRH(key || mu)
    (1952, 8, 136),   # tr = H(pk) at level 3, 15 absorb blocks
])
def test_shake_words_matches_hashlib(msg_len, out_words, rate):
    msgs = RNG.integers(0, 256, size=(3, msg_len), dtype=np.uint8)
    got = _kernel_words(msgs, out_words, rate)
    h = hashlib.shake_128 if rate == 168 else hashlib.shake_256
    for i in range(3):
        exp = np.frombuffer(h(msgs[i].tobytes()).digest(out_words * 4),
                            dtype=np.uint32)
        np.testing.assert_array_equal(got[i], exp, err_msg=f"lane {i}")


@pytest.mark.parametrize("href,rate,mlen", [
    (hashlib.sha3_256, keccak.SHA3_256_RATE, 135),
    (hashlib.sha3_512, keccak.SHA3_512_RATE, 73),
])
def test_sha3_domain_matches_hashlib(href, rate, mlen):
    """SHA3 fixed-output modes: domain byte 0x06 through the kernel."""
    msgs = RNG.integers(0, 256, size=(3, mlen), dtype=np.uint8)
    digest = href().digest_size
    got = _kernel_words(msgs, digest // 4, rate, domain=0x06)
    for i in range(3):
        exp = np.frombuffer(href(msgs[i].tobytes()).digest(), dtype=np.uint32)
        np.testing.assert_array_equal(got[i], exp, err_msg=f"lane {i}")


def test_batch_not_multiple_of_block():
    """BLOCK + 5 states: the second program is padded."""
    n = keccak_triton.BLOCK + 5
    msgs = RNG.integers(0, 256, size=(n, 34), dtype=np.uint8)
    words = keccak._pad_words(jnp.asarray(msgs), 168, 0x1F)
    got = np.asarray(keccak_triton.shake_words(words.T, 42, 168 // 8,
                                               interpret=True)).T
    assert got.shape == (n, 42)
    for i in (0, keccak_triton.BLOCK - 1, keccak_triton.BLOCK, n - 1):
        exp = np.frombuffer(hashlib.shake_128(msgs[i].tobytes()).digest(168),
                            dtype=np.uint32)
        np.testing.assert_array_equal(got[i], exp, err_msg=f"lane {i}")


def _lowered(fn, platform):
    m = jax.ShapeDtypeStruct((4, 32), jnp.uint8)
    return fn.trace(m).lower(lowering_platforms=(platform,)).as_text()


def test_use_impl_retraces_jitted_functions():
    """A function jitted and traced before the block takes the block's
    implementation inside it, and the choice does not outlive the block."""
    fn = jax.jit(lambda m: keccak.shake_words(m, 8, 136))
    assert keccak.impl() == "loop"
    assert "triton" not in _lowered(fn, "cpu")
    with keccak.use_impl("kernel"):
        assert "xla.gpu.triton" in _lowered(fn, "cuda")
    assert "triton" not in _lowered(fn, "cpu")


def test_use_impl_rejects_unknown():
    with pytest.raises(ValueError):
        with keccak.use_impl("unrolled"):
            pass
    assert keccak.impl() == "loop"


_GPU_CHECK = r"""
import hashlib
import numpy as np, jax
from dilithium_tpu.ops import keccak

assert jax.devices()[0].platform == "gpu", jax.devices()
rng = np.random.default_rng(0)
for b, mlen, words, rate, h in ((3840, 66, 160, 136, hashlib.shake_256),   # ExpandMask, W=768
                                (7680, 34, 252, 168, hashlib.shake_128),   # ExpandA, 256 keys
                                (770, 832, 8, 136, hashlib.shake_256)):    # c_tilde, ragged B
    msgs = rng.integers(0, 256, size=(b, mlen), dtype=np.uint8)
    got = np.asarray(jax.jit(lambda m: keccak._shake_words_kernel(m, words, rate))(msgs))
    for i in (0, 1, b - 1):
        exp = np.frombuffer(h(msgs[i].tobytes()).digest(4 * words), np.uint32)
        assert np.array_equal(got[i], exp), (b, i)
print("kernel ok")
"""


@pytest.mark.gpu
def test_compiled_kernel_on_gpu(gpu_env):
    """The kernel compiled for the card, at the signer's real widths."""
    import subprocess
    import sys

    r = subprocess.run([sys.executable, "-c", _GPU_CHECK], env=gpu_env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "kernel ok" in r.stdout
