"""Batched Keccak-f[1600] and SHAKE128/256 / SHA3 XOFs.

Data-parallel replacement for the reference's VHDL Keccak core
(`rtl_src/keccak_top.vhd`, `keccak_round.vhd`, `keccak_fsm2.vhd:46-78` —
1 round/cycle, 24 cycles per permutation, shared by 3 instances): the
batch dimension provides what the FPGA got from pipelining, and all five
scheme hash uses (seed expansion, tr, mu, ExpandA/S/Mask streams,
SampleInBall — see SURVEY.md §2.3 header-word list) funnel through
`shake` / `shake_words`.

Layout: 64-bit lanes are uint32 (lo, hi) pairs held as a
structure-of-arrays — 50 uint32 planes whose shape is the flattened batch.

Implementations (`impl()`), chosen once per process outside any trace:
  "kernel" — the Pallas/Triton GPU kernel (`keccak_triton`): the state
             stays in registers through absorb and squeeze. GPU default.
  "loop"   — plain jnp, the 24 rounds as a `fori_loop`. CPU default and
             the reference of the CPU tests.
`use_impl` overrides the choice inside a block. (A third form,
the 24 rounds unrolled for XLA to fuse, compiled for minutes per XOF call
on the H100 and ran 9x slower than the kernel; it was removed, PERF.md.)

All shapes are static; variable-length absorb is handled by the caller
padding to a fixed byte length (pad10*1 indices are computed at trace
time), the device analog of the reference's header-word protocol
(`keccak_datapath.vhd:92-131`).
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from dilithium_tpu.params import SHAKE128_RATE, SHAKE256_RATE

_U32 = jnp.uint32

IMPLS = ("kernel", "loop")
_override: List[str] = []


def impl() -> str:
    """The XOF implementation code traced now will use (see module doc)."""
    if _override:
        return _override[-1]
    return "kernel" if jax.default_backend() == "gpu" else "loop"


@contextlib.contextmanager
def use_impl(name: str) -> Iterator[None]:
    """Trace the XOFs with implementation `name` inside this block.

    The choice is read while tracing, and jit's caches do not key on it,
    so entering and leaving the block clears them (`jax.clear_caches`):
    every jitted function traces anew on its next call. Compiled
    executables the caller holds stay valid and keep the implementation
    they were traced with.
    """
    if name not in IMPLS:
        raise ValueError(f"unknown Keccak implementation {name!r}; one of {IMPLS}")
    _override.append(name)
    jax.clear_caches()
    try:
        yield
    finally:
        _override.pop()
        jax.clear_caches()


# Keccak round constants, split into (lo32, hi32)
_RC64 = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
_RC_LO_ARR = np.array([c & 0xFFFFFFFF for c in _RC64], dtype=np.uint32)
_RC_HI_ARR = np.array([c >> 32 for c in _RC64], dtype=np.uint32)

# rho rotation offsets, indexed [x][y] (lane (x, y), x = column)
_RHO = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]


def _rotl64(lo: jnp.ndarray, hi: jnp.ndarray, r: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Rotate a 64-bit lane (as uint32 lo/hi) left by static amount r."""
    r = r % 64
    if r == 0:
        return lo, hi
    if r == 32:
        return hi, lo
    if r > 32:
        lo, hi = hi, lo
        r -= 32
    s = jnp.uint32(r)
    t = jnp.uint32(32 - r)
    return (lo << s) | (hi >> t), (hi << s) | (lo >> t)


def _round_soa(lo: List, hi: List, rc_lo, rc_hi) -> Tuple[List, List]:
    """One Keccak round (theta-rho-pi-chi-iota) on lists of lane planes.

    rho/pi and chi are interleaved per OUTPUT ROW: each chi output row is
    computed as soon as its five rho-rotated inputs are formed, instead of
    materializing the full 50-plane B state first, which keeps the live
    set small for the register allocator (shared by the jnp paths and the
    GPU kernel, `keccak_triton`).
    """
    # theta
    c_lo = [lo[x] ^ lo[x + 5] ^ lo[x + 10] ^ lo[x + 15] ^ lo[x + 20] for x in range(5)]
    c_hi = [hi[x] ^ hi[x + 5] ^ hi[x + 10] ^ hi[x + 15] ^ hi[x + 20] for x in range(5)]
    for x in range(5):
        r_lo, r_hi = _rotl64(c_lo[(x + 1) % 5], c_hi[(x + 1) % 5], 1)
        d_lo = c_lo[(x + 4) % 5] ^ r_lo
        d_hi = c_hi[(x + 4) % 5] ^ r_hi
        for y in range(5):
            lo[x + 5 * y] = lo[x + 5 * y] ^ d_lo
            hi[x + 5 * y] = hi[x + 5 * y] ^ d_hi

    # pi+chi per output row: B[bx + 5by] = rot(A[x + 5y]) with bx = y and
    # by = (2x + 3y) % 5, so for output row `by`: y = bx, x solves
    # (2x + 3y) % 5 == by  =>  x = 3*(by + 2*y) % 5
    out_lo: List = [None] * 25
    out_hi: List = [None] * 25
    for by in range(5):
        row_lo: List = [None] * 5
        row_hi: List = [None] * 5
        for bx in range(5):
            y = bx
            x = (3 * (by + 2 * y)) % 5
            rl, rh = _rotl64(lo[x + 5 * y], hi[x + 5 * y], _RHO[x][y])
            row_lo[bx] = rl
            row_hi[bx] = rh
        for bx in range(5):
            out_lo[bx + 5 * by] = row_lo[bx] ^ (~row_lo[(bx + 1) % 5] & row_lo[(bx + 2) % 5])
            out_hi[bx + 5 * by] = row_hi[bx] ^ (~row_hi[(bx + 1) % 5] & row_hi[(bx + 2) % 5])

    # iota
    out_lo[0] = out_lo[0] ^ rc_lo
    out_hi[0] = out_hi[0] ^ rc_hi
    return out_lo, out_hi


def _f1600_soa(lo: List[jnp.ndarray], hi: List[jnp.ndarray]) -> Tuple[List, List]:
    """Keccak-f[1600] on a structure-of-arrays state, in plain jnp.

    lo/hi: 25 uint32 arrays each (lane k = x + 5*y, FIPS-202 order), any
    common shape. The 24 rounds run as a fori_loop over a stacked carry.
    """
    rc_lo = jnp.asarray(_RC_LO_ARR)
    rc_hi = jnp.asarray(_RC_HI_ARR)

    def body(rnd, st):
        lo = [st[k] for k in range(25)]
        hi = [st[25 + k] for k in range(25)]
        lo, hi = _round_soa(lo, hi, rc_lo[rnd], rc_hi[rnd])
        return jnp.stack(lo + hi)

    st = jax.lax.fori_loop(0, 24, body, jnp.stack(list(lo) + list(hi)))
    return [st[k] for k in range(25)], [st[25 + k] for k in range(25)]


def keccak_f1600(state: jnp.ndarray) -> jnp.ndarray:
    """Apply Keccak-f[1600] to a batch of states.

    state: uint32 array [..., 25, 2] with [..., k, 0] = low 32 bits of lane
    k and [..., k, 1] = high 32 bits; lane index k = x + 5*y (column-major,
    as in the FIPS-202 spec). Returns the permuted state, same shape.

    Public/testing API — the scheme's hot path goes through `shake`, which
    keeps the structure-of-arrays layout end to end.
    """
    lo = [state[..., k, 0] for k in range(25)]
    hi = [state[..., k, 1] for k in range(25)]
    lo, hi = _f1600_soa(lo, hi)
    return jnp.stack(
        [jnp.stack([lo[k], hi[k]], axis=-1) for k in range(25)], axis=-2
    )


def _pad_words(data: jnp.ndarray, rate: int, domain: int) -> jnp.ndarray:
    """uint8 [..., msg_len] -> uint32 [b, nblocks_in * rate/4] absorb words.

    The batch is flattened to b rows. pad10*1 with the domain byte (0x1F
    SHAKE, 0x06 SHA3) is applied, and the padded bytes are read as
    little-endian uint32 words in one bitcast: word 2k / 2k+1 of block i is
    the low / high half of rate lane k.
    """
    msg_len = data.shape[-1]
    nblocks_in = msg_len // rate + 1  # pad10*1 always appends at least 1 byte
    padded_len = nblocks_in * rate
    b = math.prod(data.shape[:-1])
    pad = np.zeros(padded_len - msg_len, dtype=np.uint8)
    pad[0] = domain
    pad[-1] |= 0x80
    padded = jnp.concatenate(
        [data.reshape(b, msg_len).astype(jnp.uint8),
         jnp.broadcast_to(jnp.asarray(pad), (b, pad.size))],
        axis=-1,
    )
    return jax.lax.bitcast_convert_type(
        padded.reshape(b, padded_len // 4, 4), _U32
    )


def _sponge_jnp(words: jnp.ndarray, out_words: int, rate: int) -> jnp.ndarray:
    """Plain-jnp sponge: absorb words [b, n_in] -> squeeze words [b, out_words]."""
    rate_w = rate // 8
    zeros = jnp.zeros(words.shape[:1], dtype=_U32)
    lo = [zeros] * 25
    hi = [zeros] * 25
    for i in range(words.shape[-1] // (2 * rate_w)):
        base = 2 * rate_w * i
        for k in range(rate_w):
            lo[k] = lo[k] ^ words[:, base + 2 * k]
            hi[k] = hi[k] ^ words[:, base + 2 * k + 1]
        lo, hi = _f1600_soa(lo, hi)
    out: List[jnp.ndarray] = []
    while True:
        for k in range(rate_w):
            out.extend((lo[k], hi[k]))
        if len(out) >= out_words:
            return jnp.stack(out[:out_words], axis=-1)
        lo, hi = _f1600_soa(lo, hi)


def _shake_words_kernel(data: jnp.ndarray, out_words: int, rate: int,
                        domain: int = 0x1F, interpret: bool = False) -> jnp.ndarray:
    """`shake_words` through the GPU kernel (`keccak_triton.shake_words`)."""
    from dilithium_tpu.ops import keccak_triton

    words = _pad_words(data, rate, domain)
    out = keccak_triton.shake_words(words.T, out_words, rate // 8,
                                    interpret=interpret)
    return out.T.reshape(data.shape[:-1] + (out_words,))


def _shake_words(data: jnp.ndarray, out_words: int, rate: int, domain: int) -> jnp.ndarray:
    if impl() == "kernel":
        return _shake_words_kernel(data, out_words, rate, domain)
    out = _sponge_jnp(_pad_words(data, rate, domain), out_words, rate)
    return out.reshape(data.shape[:-1] + (out_words,))


def shake(data: jnp.ndarray, out_bytes: int, rate: int, domain: int = 0x1F) -> jnp.ndarray:
    """Sponge hash over a batch of fixed-length messages.

    data: uint8 [..., msg_len]; returns uint8 [..., out_bytes].
    rate: 168 for SHAKE128, 136 for SHAKE256 (domain 0x1F); the SHA3
    fixed-output modes use domain 0x06 (see `sha3_256` / `sha3_512`).
    """
    out_words = -(-out_bytes // 4)
    words = _shake_words(data, out_words, rate, domain)
    by = jax.lax.bitcast_convert_type(words, jnp.uint8)  # [..., out_words, 4]
    return by.reshape(words.shape[:-1] + (out_words * 4,))[..., :out_bytes]


def shake_words(data: jnp.ndarray, out_words: int, rate: int) -> jnp.ndarray:
    """SHAKE XOF squeezing uint32 words — no byte materialization.

    data: uint8 [..., msg_len]; returns uint32 [..., out_words] where word
    j holds output-stream bytes 4j..4j+3 little-endian (i.e. the uint32 LE
    view of the byte stream `shake` would produce). The samplers bit-slice
    coefficients straight from these words (`pack.unpack_bits_w`).
    """
    return _shake_words(data, out_words, rate, 0x1F)


# Fixed-output SHA3 rates: rate = 200 - 2*digest_len (FIPS-202 §5.1).
# The reference Keccak core is a 4-mode engine — header bits 62:61 select
# SHA3-256 / SHA3-512 / SHAKE128 / SHAKE256 (`keccak_datapath.vhd:92-131`);
# Dilithium itself uses only the SHAKE modes, these two close the
# capability-parity gap of the subsystem.
SHA3_256_RATE = 136
SHA3_512_RATE = 72


def sha3_256(data: jnp.ndarray) -> jnp.ndarray:
    """SHA3-256 over a batch: uint8 [..., msg_len] -> uint8 [..., 32]."""
    return shake(data, 32, SHA3_256_RATE, domain=0x06)


def sha3_512(data: jnp.ndarray) -> jnp.ndarray:
    """SHA3-512 over a batch: uint8 [..., msg_len] -> uint8 [..., 64]."""
    return shake(data, 64, SHA3_512_RATE, domain=0x06)


def shake128(data: jnp.ndarray, out_bytes: int) -> jnp.ndarray:
    return shake(data, out_bytes, SHAKE128_RATE)


def shake256(data: jnp.ndarray, out_bytes: int) -> jnp.ndarray:
    return shake(data, out_bytes, SHAKE256_RATE)


def shake128_words(data: jnp.ndarray, out_words: int) -> jnp.ndarray:
    return shake_words(data, out_words, SHAKE128_RATE)


def shake256_words(data: jnp.ndarray, out_words: int) -> jnp.ndarray:
    return shake_words(data, out_words, SHAKE256_RATE)
