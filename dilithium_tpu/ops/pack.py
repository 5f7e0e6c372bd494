"""Bit-pack / unpack codecs for every Dilithium encoding, plus pk/sk/sig.

Batched replacement for the reference's streaming encoder/decoder
(`rtl_src/encoder.v:96-133` — T0 13b, T1 10b, S 3/4b, W1 4/6b, Z 18/20b;
`decoder.v:90-143`; `zero_strip.v`). Instead of a 256-bit PISO shifting
4 coefficients/cycle, packing is a single dense bit-matrix reshape over the
whole `[..., 256]` batch: expand values to a `[..., 256*bits]` bit tensor,
regroup to bytes. XLA lowers this to vector shifts/ors; byte order matches
the little-endian bitstream of the spec (first coefficient in the low bits
of the first byte).

The hint codec (`makehint.v:104-148` position tables / `usehint.v:209-211`
bitmap expansion) is a rank-scatter: positions of set bits compacted by a
cumulative-sum rank, counts appended — with full canonicity validation on
decode, as the RTL's reject path requires.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from dilithium_tpu.params import (
    Q, N, D, SEEDBYTES, TRBYTES, DilithiumParams,
    POLYT0_PACKEDBYTES, POLYT1_PACKEDBYTES,
)

_U8 = jnp.uint8
_U32 = jnp.uint32
_I32 = jnp.int32


def _lcm(a: int, b: int) -> int:
    from math import gcd
    return a * b // gcd(a, b)


def pack_bits(vals: jnp.ndarray, bits: int) -> jnp.ndarray:
    """uint32 [..., n] (each < 2^bits) -> uint8 [..., n*bits/8] LE bitstream.

    Byte-group formulation: g = lcm(8,bits)/bits values produce bg bytes;
    each output byte is an OR of <= 3 shifted values (computed at trace
    time) — ~bits/8 x less data movement than a per-bit expansion, which
    matters because packing runs in every sign attempt (w1 for c_tilde).
    """
    n = vals.shape[-1]
    assert (n * bits) % 8 == 0
    period = _lcm(8, bits)
    g = period // bits     # values per group
    bg = period // 8       # bytes per group
    assert n % g == 0
    v = vals.astype(_U32).reshape(vals.shape[:-1] + (n // g, g))
    bytes_out = []
    for k in range(bg):
        lo_bit = 8 * k
        hi_bit = lo_bit + 8
        acc = None
        for i in range(g):
            vstart = bits * i
            vend = vstart + bits
            if vend <= lo_bit or vstart >= hi_bit:
                continue
            sh = lo_bit - vstart
            term = (v[..., i] >> np.uint32(sh)) if sh >= 0 else (
                v[..., i] << np.uint32(-sh)
            )
            acc = term if acc is None else (acc | term)
        bytes_out.append((acc & np.uint32(0xFF)).astype(_U8))
    out = jnp.stack(bytes_out, axis=-1)  # [..., n//g, bg]
    return out.reshape(vals.shape[:-1] + (n * bits // 8,))


def unpack_bits_w(words: jnp.ndarray, bits: int) -> jnp.ndarray:
    """uint32 [..., nwords] LE bitstream -> uint32 [..., nwords*32/bits].

    Word-domain counterpart of `unpack_bits` for XOF streams squeezed as
    words (`keccak.shake_words`): each value is an OR of <= 2 shifted
    words (vs <= 4 shifted bytes), and the stream never materializes as
    bytes. Requires bits <= 32 and nwords*32 % bits == 0.
    """
    nwords = words.shape[-1]
    assert (nwords * 32) % bits == 0
    period = _lcm(32, bits)
    g = period // bits      # values per group
    wg = period // 32       # words per group
    assert nwords % wg == 0
    w = words.astype(_U32).reshape(words.shape[:-1] + (nwords // wg, wg))
    mask = np.uint32((1 << bits) - 1) if bits < 32 else np.uint32(0xFFFFFFFF)
    vals = []
    for i in range(g):
        vstart = bits * i
        k = vstart // 32
        s = vstart % 32
        acc = w[..., k] >> np.uint32(s)
        if s + bits > 32:
            acc = acc | (w[..., k + 1] << np.uint32(32 - s))
        vals.append(acc & mask)
    out = jnp.stack(vals, axis=-1)  # [..., nwords//wg, g]
    return out.reshape(words.shape[:-1] + (nwords * 32 // bits,))


def unpack_bits(data: jnp.ndarray, bits: int) -> jnp.ndarray:
    """uint8 [..., nbytes] -> uint32 [..., nbytes*8/bits] LE bitstream.

    Inverse byte-group formulation of pack_bits (<= 4 shifted-byte ORs per
    value, trace-time unrolled).
    """
    nbytes = data.shape[-1]
    assert (nbytes * 8) % bits == 0
    n = nbytes * 8 // bits
    period = _lcm(8, bits)
    g = period // bits
    bg = period // 8
    assert nbytes % bg == 0
    b = data.astype(_U32).reshape(data.shape[:-1] + (nbytes // bg, bg))
    vals = []
    mask = np.uint32((1 << bits) - 1)
    for i in range(g):
        vstart = bits * i
        vend = vstart + bits
        acc = None
        for k in range(bg):
            lo_bit = 8 * k
            hi_bit = lo_bit + 8
            if hi_bit <= vstart or lo_bit >= vend:
                continue
            sh = lo_bit - vstart
            term = (b[..., k] << np.uint32(sh)) if sh >= 0 else (
                b[..., k] >> np.uint32(-sh)
            )
            acc = term if acc is None else (acc | term)
        vals.append(acc & mask)
    out = jnp.stack(vals, axis=-1)  # [..., nbytes//bg, g]
    return out.reshape(data.shape[:-1] + (n,))


# ---- per-poly codecs (last axis = 256 coefficients) ----

def pack_eta(s: jnp.ndarray, p: DilithiumParams) -> jnp.ndarray:
    """s: canonical uint32 [0,q) with centered value in [-eta, eta]."""
    from dilithium_tpu.ops.reduce import center
    vals = (jnp.int32(p.eta) - center(s)).astype(_U32)
    return pack_bits(vals, p.eta_bits)


def unpack_eta(b: jnp.ndarray, p: DilithiumParams) -> jnp.ndarray:
    from dilithium_tpu.ops.reduce import uncenter
    vals = unpack_bits(b, p.eta_bits).astype(_I32)
    return uncenter(jnp.int32(p.eta) - vals)


def pack_t1(t1: jnp.ndarray) -> jnp.ndarray:
    return pack_bits(t1.astype(_U32), 10)


def unpack_t1(b: jnp.ndarray) -> jnp.ndarray:
    return unpack_bits(b, 10)


def pack_t0(t0: jnp.ndarray) -> jnp.ndarray:
    """t0: centered int32 in (-2^12, 2^12]."""
    vals = (jnp.int32(1 << (D - 1)) - t0.astype(_I32)).astype(_U32)
    return pack_bits(vals, 13)


def unpack_t0(b: jnp.ndarray) -> jnp.ndarray:
    vals = unpack_bits(b, 13).astype(_I32)
    return jnp.int32(1 << (D - 1)) - vals  # centered int32


def pack_z(z: jnp.ndarray, p: DilithiumParams) -> jnp.ndarray:
    """z: canonical uint32 with centered value in (-gamma1, gamma1]."""
    from dilithium_tpu.ops.reduce import center
    vals = (jnp.int32(p.gamma1) - center(z)).astype(_U32)
    return pack_bits(vals, p.gamma1_bits)


def unpack_z(b: jnp.ndarray, p: DilithiumParams) -> jnp.ndarray:
    from dilithium_tpu.ops.reduce import uncenter
    vals = unpack_bits(b, p.gamma1_bits).astype(_I32)
    return uncenter(jnp.int32(p.gamma1) - vals)


def pack_w1(w1: jnp.ndarray, p: DilithiumParams) -> jnp.ndarray:
    return pack_bits(w1.astype(_U32), p.w1_bits)


# ---- hint codec (omega + K bytes) ----

def pack_hints(h: jnp.ndarray, p: DilithiumParams) -> jnp.ndarray:
    """h: uint32 0/1 [..., K, 256] -> uint8 [..., omega + K].

    Byte layout (round-3 signature format, cf. `makehint.v:104-148`):
    concatenated ascending positions of set bits for poly 0, poly 1, ...,
    then byte omega+k = cumulative count through poly k. Assumes total
    weight <= omega (the sign loop rejects otherwise).

    The required output order IS ascending global bit position, so slot s
    holds the position whose cumulative-rank equals s: a one-hot
    compare-and-reduce over the bit axis (rank[..., b] == s) & hint —
    a pure broadcast/reduce that XLA fuses without materializing,
    instead of a top_k sort or a per-row scatter.
    """
    K = p.K
    batch = h.shape[:-2]
    hf = h.reshape(batch + (K * N,)).astype(_I32)
    rank = jnp.cumsum(hf, axis=-1) - hf            # [..., K*N]
    slotids = jnp.arange(p.omega, dtype=_I32)      # [omega]
    sel = (rank[..., None, :] == slotids[:, None]) & (hf[..., None, :] == 1)
    gpos = jnp.arange(K * N, dtype=_I32) % N       # position within poly
    pos = jnp.sum(jnp.where(sel, gpos, 0), axis=-1)  # [..., omega]
    # cumulative counts per poly
    counts = jnp.cumsum(jnp.sum(h.astype(_U32), axis=-1), axis=-1)  # [..., K]
    return jnp.concatenate(
        [pos.astype(_U8), counts.astype(_U8)], axis=-1
    )


def unpack_hints(b: jnp.ndarray, p: DilithiumParams) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """uint8 [..., omega + K] -> (h [..., K, 256] uint32 0/1, ok [...] bool).

    Validates canonical encoding exactly as the reference decoder must
    (strictly increasing positions per poly, non-decreasing counts <= omega,
    zero padding after the last hint) — malformed signatures are rejected
    (`usehint.v` RECEIVE/EXPAND path; pq-crystals unpack_sig semantics).
    """
    K = p.K
    batch = b.shape[:-1]
    data = b.astype(_U32)
    ends = data[..., p.omega:]  # [..., K] cumulative counts
    total = ends[..., -1]

    ok = jnp.ones(batch, dtype=jnp.bool_)
    # counts sane: non-decreasing, <= omega
    prev = jnp.concatenate(
        [jnp.zeros(batch + (1,), dtype=_U32), ends[..., :-1]], axis=-1
    )
    ok = ok & jnp.all(ends >= prev, axis=-1) & jnp.all(ends <= p.omega, axis=-1)

    slots = jnp.arange(p.omega, dtype=_U32)  # [omega]
    pos = data[..., :p.omega]  # [..., omega]
    # poly index owning each slot: number of ends <= slot
    poly_of_slot = jnp.sum(
        slots[..., None, :] >= ends[..., :, None], axis=-2
    )  # [..., omega], == K for slots beyond total
    active = poly_of_slot < K
    # strictly increasing within a poly: slot j active and j-1 in same poly
    same_poly = jnp.concatenate(
        [jnp.zeros(batch + (1,), dtype=jnp.bool_),
         poly_of_slot[..., 1:] == poly_of_slot[..., :-1]], axis=-1
    )
    increasing = jnp.concatenate(
        [jnp.ones(batch + (1,), dtype=jnp.bool_),
         pos[..., 1:] > pos[..., :-1]], axis=-1
    )
    ok = ok & jnp.all(jnp.where(active & same_poly, increasing, True), axis=-1)
    # zero padding beyond the last hint
    ok = ok & jnp.all(jnp.where(active, True, pos == 0), axis=-1)

    # scatter into bitmap (vmap'd 1-D scatter; see pack_hints)
    flat_idx = jnp.where(active, poly_of_slot * N + pos, jnp.uint32(K * N))

    def scat(i):
        return jnp.zeros((K * N,), dtype=_U32).at[i].set(1, mode="drop")

    bitmap = jax.vmap(scat)(flat_idx.reshape((-1, p.omega))).reshape(
        batch + (K * N,)
    )
    return bitmap.reshape(batch + (K, N)), ok


# ---- key / signature containers ----

def pack_pk(rho: jnp.ndarray, t1: jnp.ndarray, p: DilithiumParams) -> jnp.ndarray:
    """rho uint8 [..., 32], t1 uint32 [..., K, 256] -> uint8 [..., pk_bytes]."""
    t1b = pack_t1(t1).reshape(t1.shape[:-2] + (p.K * POLYT1_PACKEDBYTES,))
    return jnp.concatenate([rho.astype(_U8), t1b], axis=-1)


def unpack_pk(pk: jnp.ndarray, p: DilithiumParams) -> Tuple[jnp.ndarray, jnp.ndarray]:
    rho = pk[..., :SEEDBYTES]
    t1b = pk[..., SEEDBYTES:].reshape(pk.shape[:-1] + (p.K, POLYT1_PACKEDBYTES))
    return rho, unpack_t1(t1b)


def pack_sk(rho, key, tr, s1, s2, t0, p: DilithiumParams) -> jnp.ndarray:
    """Components -> uint8 [..., sk_bytes]. s1/s2 canonical, t0 centered."""
    batch = rho.shape[:-1]
    s1b = pack_eta(s1, p).reshape(batch + (p.L * p.polyeta_packedbytes,))
    s2b = pack_eta(s2, p).reshape(batch + (p.K * p.polyeta_packedbytes,))
    t0b = pack_t0(t0).reshape(batch + (p.K * POLYT0_PACKEDBYTES,))
    return jnp.concatenate(
        [rho.astype(_U8), key.astype(_U8), tr.astype(_U8), s1b, s2b, t0b], axis=-1
    )


def unpack_sk(sk: jnp.ndarray, p: DilithiumParams):
    batch = sk.shape[:-1]
    o = 0
    rho = sk[..., o:o + SEEDBYTES]; o += SEEDBYTES
    key = sk[..., o:o + SEEDBYTES]; o += SEEDBYTES
    tr = sk[..., o:o + TRBYTES]; o += TRBYTES
    n1 = p.L * p.polyeta_packedbytes
    s1 = unpack_eta(sk[..., o:o + n1].reshape(batch + (p.L, p.polyeta_packedbytes)), p)
    o += n1
    n2 = p.K * p.polyeta_packedbytes
    s2 = unpack_eta(sk[..., o:o + n2].reshape(batch + (p.K, p.polyeta_packedbytes)), p)
    o += n2
    n0 = p.K * POLYT0_PACKEDBYTES
    t0 = unpack_t0(sk[..., o:o + n0].reshape(batch + (p.K, POLYT0_PACKEDBYTES)))
    return rho, key, tr, s1, s2, t0


def pack_sig(c_tilde, z, h, p: DilithiumParams) -> jnp.ndarray:
    """c_tilde uint8 [...,32], z canonical [...,L,256], h [...,K,256] 0/1."""
    batch = c_tilde.shape[:-1]
    zb = pack_z(z, p).reshape(batch + (p.L * p.polyz_packedbytes,))
    hb = pack_hints(h, p)
    return jnp.concatenate([c_tilde.astype(_U8), zb, hb], axis=-1)


def unpack_sig(sig: jnp.ndarray, p: DilithiumParams):
    batch = sig.shape[:-1]
    o = 0
    c_tilde = sig[..., :SEEDBYTES]; o = SEEDBYTES
    nz = p.L * p.polyz_packedbytes
    z = unpack_z(sig[..., o:o + nz].reshape(batch + (p.L, p.polyz_packedbytes)), p)
    o += nz
    h, ok = unpack_hints(sig[..., o:], p)
    return c_tilde, z, h, ok
