"""Keccak XOF kernel for NVIDIA GPUs, in Pallas on the Triton route.

One program owns a block of independent sponge states. The states sit in
a word-major layout, uint32 [words, B], so the row of one word over the
block is one coalesced load. The 50 half-lane planes (25 lanes as uint32
lo/hi pairs, lane k = x + 5y as in FIPS-202) stay in registers through
the whole absorb and squeeze: the input is read once, the 24 rounds of
each permutation run as a `fori_loop` with the round constants read from
a small table, and every output word is written once. Absorbed and
squeezed rate blocks are loops too, so the kernel's size (and its compile
time, which grew steeply with unrolled blocks) does not depend on the
message or output length. This is the register-resident form of the
reference's Keccak core, which keeps its 1600-bit state in one register
through the whole absorb/squeeze schedule (`keccak_fsm2.vhd:46-78`).

The round function is `keccak._round_soa`, shared with the plain jnp
path. `interpret=True` runs the kernel through the Pallas interpreter,
which is how the CPU tests reach it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from dilithium_tpu.ops import keccak

# States per program: one warp, one state per thread. Small blocks spread
# the latency-bound sponge over more SMs. The block sweep (32 fastest of
# 32-256 at the ExpandMask shape on the H100, docs/PERF.md) was taken on
# an earlier form of this kernel, with unrolled rate blocks and 4 warps;
# this looped 1-warp form has not been re-swept.
BLOCK = 32

# round constants as a [2, 32] table (row 0 = low halves, row 1 = high
# halves; columns 24..31 pad the row to a power of two)
_RC = np.zeros((2, 32), dtype=np.uint32)
_RC[0, :24] = keccak._RC_LO_ARR
_RC[1, :24] = keccak._RC_HI_ARR


def _permute(rc_ref, lo, hi):
    def body(rnd, st):
        lo_, hi_ = keccak._round_soa(
            list(st[:25]), list(st[25:]), rc_ref[0, rnd], rc_ref[1, rnd]
        )
        return tuple(lo_) + tuple(hi_)

    st = jax.lax.fori_loop(0, 24, body, tuple(lo) + tuple(hi))
    return list(st[:25]), list(st[25:])


def _absorb(rc_ref, in_ref, nblocks_in, rate_w):
    """Absorb nblocks_in padded rate blocks; returns the state planes."""
    def body(b, st):
        lo, hi = list(st[:25]), list(st[25:])
        base = 2 * rate_w * b
        for k in range(rate_w):
            lo[k] = lo[k] ^ in_ref[base + 2 * k]
            hi[k] = hi[k] ^ in_ref[base + 2 * k + 1]
        lo, hi = _permute(rc_ref, lo, hi)
        return tuple(lo) + tuple(hi)

    zeros = jnp.zeros_like(in_ref[0])
    st = jax.lax.fori_loop(0, nblocks_in, body, (zeros,) * 50)
    return list(st[:25]), list(st[25:])


def _store_block(out_ref, base, lo, hi, rate_w):
    for k in range(rate_w):
        out_ref[base + 2 * k] = lo[k]
        out_ref[base + 2 * k + 1] = hi[k]


def _xof_kernel(rc_ref, in_ref, out_ref, *, nblocks_in, rate_w, nblocks_out):
    """out_ref rows = nblocks_out whole rate blocks of squeezed words."""
    lo, hi = _absorb(rc_ref, in_ref, nblocks_in, rate_w)

    def body(b, st):
        lo, hi = list(st[:25]), list(st[25:])
        _store_block(out_ref, 2 * rate_w * b, lo, hi, rate_w)
        lo, hi = _permute(rc_ref, lo, hi)
        return tuple(lo) + tuple(hi)

    st = jax.lax.fori_loop(0, nblocks_out - 1, body, tuple(lo) + tuple(hi))
    _store_block(out_ref, 2 * rate_w * (nblocks_out - 1), st[:25], st[25:], rate_w)


def shake_words(planes: jnp.ndarray, out_words: int, rate_w: int, *,
                interpret: bool = False) -> jnp.ndarray:
    """Sponge over padded absorb words.

    planes: uint32 [nblocks_in * 2*rate_w, B], word 2k / 2k+1 of block i
    = low / high half of rate lane k (pad10*1 already applied). Returns
    uint32 [out_words, B]: word j = squeeze bytes 4j..4j+3, little-endian.
    B is padded to a multiple of BLOCK states for the kernel.
    """
    n_in, b = planes.shape
    pad = (-b) % BLOCK
    if pad:
        planes = jnp.pad(planes, ((0, 0), (0, pad)))
    nblocks_out = -(-out_words // (2 * rate_w))
    out_rows = nblocks_out * 2 * rate_w
    kernel = functools.partial(
        _xof_kernel, nblocks_in=n_in // (2 * rate_w), rate_w=rate_w,
        nblocks_out=nblocks_out,
    )
    out = pl.pallas_call(
        kernel,
        grid=((b + pad) // BLOCK,),
        in_specs=[
            pl.BlockSpec((2, 32), lambda i: (0, 0)),
            pl.BlockSpec((n_in, BLOCK), lambda i: (0, i)),
        ],
        out_specs=pl.BlockSpec((out_rows, BLOCK), lambda i: (0, i)),
        # under shard_map the output varies over the same mesh axes as
        # the input states
        out_shape=jax.ShapeDtypeStruct((out_rows, b + pad), jnp.uint32,
                                       vma=jax.typeof(planes).vma),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="keccak_xof",
    )(jnp.asarray(_RC), planes)
    return out[:out_words, :b]
