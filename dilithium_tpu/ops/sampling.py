"""ExpandA / ExpandS / ExpandMask / SampleInBall — masked batch sampling.

Batched replacement for the reference's sampler pipeline
(`rtl_src/gen_a_ext.v`, `sampler_a_ext.v`, `rejection_a.v`, `gen_s.v`,
`sampler_s.v`, `rejection_s.v`, `expandmask_ext.v`, `sampler_y_ext.v`,
`rejection_y.v`, `gen_c.v`). The RTL streams SHAKE output through 3-lane
rejection filters, stalling until 256 coefficients are accepted; here we
generate a fixed, provably sufficient number of XOF blocks for the whole
batch and compact accepted candidates with a cumulative-sum rank scatter —
the accepted sequence is identical to streaming semantics whenever the
budget suffices.

Fixed-budget failure bounds (per polynomial, Chernoff):
  ExpandA  : 5 SHAKE128 blocks = 280 candidates, p_accept = q/2^23 ≈ .99902
             P[<256 accepted] < 1e-40
  ExpandS  : eta=2: 2 SHAKE256 blocks = 544 cand, p=15/16 -> P[fail] < 1e-79
             eta=4: 3 blocks = 816 cand, p=9/16 -> P[fail] < 1e-53
  SampleInBall: 2 blocks = 272 bytes for 8 sign bytes + tau<=60 geometric
             draws at p >= 196/256 -> P[fail] < 1e-30
ExpandMask has no rejection (fixed 18/20-bit slices, `rejection_y.v:44-99`).
`*_ok` outputs report budget sufficiency so callers can assert/monitor; for
the sparse compactions the flag also covers the (>= 10-sigma rarer) skip
budget — see `_rank_compact_sparse`.
"""

from __future__ import annotations

import os
from typing import Tuple

import jax
import jax.numpy as jnp

from dilithium_tpu.params import (
    Q, N, SHAKE128_RATE, SHAKE256_RATE, DilithiumParams,
)
from dilithium_tpu.ops import keccak
from dilithium_tpu.ops.pack import unpack_bits_w
from dilithium_tpu.ops.reduce import uncenter

_U8 = jnp.uint8
_U32 = jnp.uint32
_I32 = jnp.int32


def debug_check_ok(ok: jnp.ndarray, what: str) -> None:
    """Debug-mode guard for expansion paths that DISCARD sampler ok flags.

    expand_sk / expand_pk / verify / mxu.build_*_operators run expand_a
    once per key and drop its budget flag (P[miss] < 1e-17 at the default
    budgets — see `expand_a` docstring); a miss there would yield silently
    wrong key material. With DILITHIUM_DEBUG_CHECKS=1 those
    sites surface any miss as a host-side RuntimeError via debug.callback
    (works under jit); unset, this traces to nothing and costs zero.
    """
    if not os.environ.get("DILITHIUM_DEBUG_CHECKS"):
        return

    def _raise(ok_host):
        import numpy as _np
        if not _np.all(ok_host):
            raise RuntimeError(
                f"sampler fixed-budget miss in {what} "
                f"({int((~_np.asarray(ok_host)).sum())} lanes) — "
                "result would be silently wrong; raise the block budget"
            )

    jax.debug.callback(_raise, ok)


def _le16(n: jnp.ndarray) -> jnp.ndarray:
    """uint32 [...] -> uint8 [..., 2] little-endian."""
    n = n.astype(_U32)
    return jnp.stack(
        [(n & 0xFF).astype(_U8), ((n >> 8) & 0xFF).astype(_U8)], axis=-1
    )


def _rank_compact_sparse(
    cand: jnp.ndarray, accept: jnp.ndarray, n_out: int, max_skips: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Compact accepted candidates when rejections are RARE — scatter-free.

    The accepted candidate landing in output slot i sits at input position
    i + s where s = (#rejects before it) <= max_skips, so out[i] is found
    by max_skips+1 statically-shifted compare-selects: out[i] = cand[i+s]
    for the unique s with accept[i+s] and rank[i+s] == i. Requires
    n_cand >= n_out + max_skips. ok goes False (budget-failure semantics)
    on the astronomically rare draw with more than max_skips rejects in
    the consumed window — detected exactly via slot coverage, never
    silently wrong.

    Thirteen shifted elementwise passes replace the batched scatter of
    `_rank_compact` at the ExpandA shape (reject rate 2^-13+eps).
    """
    acc = accept.astype(_I32)
    rank = jnp.cumsum(acc, axis=-1) - acc
    i = jnp.arange(n_out, dtype=_I32)
    out = jnp.zeros(cand.shape[:-1] + (n_out,), dtype=cand.dtype)
    covered = jnp.zeros(cand.shape[:-1] + (n_out,), dtype=bool)
    for s in range(max_skips + 1):
        c_s = cand[..., s:s + n_out]
        r_s = rank[..., s:s + n_out]
        a_s = accept[..., s:s + n_out]
        hit = a_s & (r_s == i)
        out = jnp.where(hit, c_s, out)
        covered = covered | hit
    return out, jnp.all(covered, axis=-1)


def _rank_compact_onehot(
    cand: jnp.ndarray, accept: jnp.ndarray, n_out: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Compact accepted candidates via a FULL-window one-hot compare-reduce.

    out[i] = the unique candidate with accept and rank == i — computed as
    a [..., n_out, n_cand] broadcast compare that XLA fuses into its
    reduction without materializing. The right shape class at DENSE
    rejection rates (eta sampling, 7/16 rejects), where
    `_rank_compact_sparse`'s skip budget would force ~400 shifted window
    passes.
    The PRODUCTION eta path now uses `_rank_compact_onehot_banded` (same
    semantics, 2.2x fewer compares); this full-window form is its exact
    differential oracle (tests/test_sampling.py) and the general-purpose
    fallback for rates/shapes without a derived band.
    """
    acc = accept.astype(_I32)
    rank = jnp.cumsum(acc, axis=-1) - acc
    idx = jnp.where(accept, rank, jnp.int32(-1))     # [..., n_cand]
    i = jnp.arange(n_out, dtype=_I32)                # [n_out]
    sel = idx[..., None, :] == i[:, None]            # [..., n_out, n_cand]
    out = jnp.sum(
        jnp.where(sel, cand[..., None, :], jnp.zeros((), dtype=cand.dtype)),
        axis=-1,
        dtype=cand.dtype,
    )
    ok = (rank[..., -1] + acc[..., -1]) >= n_out
    return out, ok


def _rank_compact_onehot_banded(
    cand: jnp.ndarray,
    accept: jnp.ndarray,
    n_out: int,
    p_accept: float,
    chunk: int = 64,
    sigmas: float = 8.0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One-hot compaction with per-output-chunk candidate bands.

    The source index of output i is i + r_i with r_i ~ NegBinomial(i+1,
    p_accept) rejects — concentrated in a +-sigmas band around its mean.
    Each `chunk` of outputs therefore compares only a sliced candidate
    window instead of the whole axis (eta=4 shape: 77k vs 168k compares,
    2.2x less reduce work than `_rank_compact_onehot`). Source index is
    monotone in output index, so a chunk is fully covered iff its FIRST
    and LAST outputs found their source inside the window — checked
    exactly; a >sigmas-sigma draw flags ok=False (budget-failure
    semantics), never a silently wrong value.
    """
    import math

    q_over_p = (1.0 - p_accept) / p_accept
    var_ratio = (1.0 - p_accept) / (p_accept * p_accept)
    n_cand = cand.shape[-1]
    acc = accept.astype(_I32)
    rank = jnp.cumsum(acc, axis=-1) - acc
    idx = jnp.where(accept, rank, jnp.int32(-1))     # [..., n_cand]

    outs, covs = [], []
    for k0 in range(0, n_out, chunk):
        k1 = min(k0 + chunk, n_out)
        r_lo = (k0 + 1) * q_over_p - sigmas * math.sqrt((k0 + 1) * var_ratio)
        r_hi = k1 * q_over_p + sigmas * math.sqrt(k1 * var_ratio)
        w0 = max(0, k0 + int(math.floor(max(0.0, r_lo))))
        w1 = min(n_cand, k1 - 1 + int(math.ceil(r_hi)) + 2)
        i = jnp.arange(k0, k1, dtype=_I32)
        sel = idx[..., None, w0:w1] == i[:, None]    # [..., k1-k0, w1-w0]
        outs.append(jnp.sum(
            jnp.where(sel, cand[..., None, w0:w1],
                      jnp.zeros((), dtype=cand.dtype)),
            axis=-1, dtype=cand.dtype,
        ))
        # chunk covered iff its first and last outputs hit (monotonicity)
        covs.append(jnp.any(sel[..., 0, :], axis=-1)
                    & jnp.any(sel[..., -1, :], axis=-1))
    out = jnp.concatenate(outs, axis=-1)
    ok = covs[0]
    for c in covs[1:]:
        ok = ok & c
    return out, ok


def _rank_compact_logshift(
    cand: jnp.ndarray,
    accept: jnp.ndarray,
    n_out: int,
    max_disp: int | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """EXACT stream compaction in ceil(log2(n_cand)) shift-select passes.

    Accepted element at position c must move left by its displacement
    d = c - rank(c) = #rejects before it. Decompose d in binary and move
    all elements simultaneously by 2^b at pass b (LSB->MSB), each pass a
    static minor-axis shift + two selects. Collision-free: d is
    non-decreasing in position, so current positions stay strictly
    increasing through every pass — for neighbors i < j with
    bit_b(d_j) = 1, bit_b(d_i) = 0, write d = H*2^(b+1) + bit_b*2^b + low
    (low = already-executed bits): d_j >= d_i forces H_j >= H_i, and the
    current gap q_j - q_i = (p_j - p_i) + low_i - low_j
    >= (d_j - d_i + 1) + low_i - low_j = (H_j - H_i)*2^(b+1) + 2^b + 1
    > 2^b, so j's move cannot cross or land on i.

    Per-pass work is O(n_cand) selects TOTAL (vs the one-hot forms'
    O(n_out * band) compare-select-accumulate area): at the eta=4 shape
    (816 cand -> 256, ~5 band entries/output) that is ~10 x 816 element
    ops vs ~82k x 3 — the compaction is compute-bound, so the op-count
    ratio is the speedup ceiling. ok is EXACT coverage (state zero at
    every output slot), not a sigma-band bound: False iff fewer than
    n_out accepts — same semantics as `_rank_compact`.

    max_disp: optional displacement budget. Truncates the candidate
    window to n_out + max_disp and runs only bit_length(max_disp)
    passes; an input needing more displacement (more than max_disp
    rejects before the n_out-th accept) reads ok False — the same
    budget-failure semantics as `_rank_compact_sparse(max_skips)`, at
    the same O(n_cand) pass cost but ~3x fewer passes for rare-reject
    streams (ExpandA: max_disp=15 is a >15-sigma budget at reject rate
    2^-13+eps and needs 4 passes vs 13 shifted windows).
    """
    n_cand = cand.shape[-1]
    if max_disp is not None and n_out + max_disp < n_cand:
        n_cand = n_out + max_disp
        cand = cand[..., :n_cand]
        accept = accept[..., :n_cand]
    acc_i = accept.astype(_I32)
    rank = jnp.cumsum(acc_i, axis=-1) - acc_i
    keep = accept & (rank < n_out)
    # state = remaining displacement; holes carry INVALID (a high bit no
    # displacement can reach, all shift bits clear -> holes never move)
    INVALID = jnp.int32(1) << 30
    pos = jnp.arange(n_cand, dtype=_I32)
    st = jnp.where(keep, pos - rank, INVALID)
    val = jnp.where(keep, cand, jnp.zeros((), dtype=cand.dtype))

    # d is non-decreasing over accepts, so max d over KEPT accepts is the
    # last one's: (pos of the n_out-th accept) - (n_out - 1)
    # <= n_cand - n_out whenever coverage succeeds; shortfalls flag ok
    # False regardless of how far uncovered elements moved.
    nbits = max(1, (n_cand - n_out).bit_length())
    fill_st = jnp.broadcast_to(INVALID, st.shape[:-1] + (1,))
    fill_val = jnp.zeros(val.shape[:-1] + (1,), dtype=val.dtype)
    for b in range(nbits):
        sh = 1 << b
        if sh >= n_cand:
            break
        st_s = jnp.concatenate(
            [st[..., sh:], jnp.broadcast_to(fill_st, st.shape[:-1] + (sh,))],
            axis=-1,
        )
        val_s = jnp.concatenate(
            [val[..., sh:],
             jnp.broadcast_to(fill_val, val.shape[:-1] + (sh,))],
            axis=-1,
        )
        move_in = (st_s & sh) != 0          # shifted-in elt consumes bit b
        stay = (st & sh) == 0               # incl. holes (stay as holes)
        st = jnp.where(move_in, st_s - sh, jnp.where(stay, st, INVALID))
        val = jnp.where(move_in, val_s,
                        jnp.where(stay, val, jnp.zeros((), dtype=val.dtype)))
    out = val[..., :n_out]
    ok = jnp.all(st[..., :n_out] == 0, axis=-1)
    return out, ok


def _rank_compact_logshift_packed(
    cand: jnp.ndarray,
    accept: jnp.ndarray,
    n_out: int,
    val_bits: int,
    p_accept: float | None = None,
    sigmas: float = 8.0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """`_rank_compact_logshift` with value and displacement PACKED into one
    int32 word (st = d << val_bits | val): one array per pass instead of
    two — half the per-pass traffic and selects. Requires every candidate
    < 2^val_bits and nbits(n_cand) + val_bits <= 30 (bit 30 is the hole
    marker). The eta nibbles (val_bits=4, d <= 1023) are the target shape.

    p_accept (optional): truncate the candidate window to the +sigmas-sigma
    sufficiency bound T = n_out/p + sigmas*sqrt(n_out*(1-p))/p before
    compacting — the n_out-th accept lies beyond T with probability
    ~Phi(-sigmas) (< 1e-15 at 8 sigma), in which case ok reads False
    (budget-failure semantics, never silently wrong — identical to
    running with a T-candidate budget). Max displacement shrinks to
    T - n_out, cutting both the pass count and the per-pass width (eta=2:
    544 x 10 passes -> 312 x 6).

    Returns (out int32 [..., n_out] in [0, 2^val_bits), ok exact-coverage).
    """
    import math

    n_cand = cand.shape[-1]
    if p_accept is not None:
        t = int(math.ceil(
            n_out / p_accept
            + sigmas * math.sqrt(n_out * (1.0 - p_accept)) / p_accept
        )) + 2
        if t < n_cand:
            cand = cand[..., :t]
            accept = accept[..., :t]
            n_cand = t
    # displacement of kept accepts <= n_cand - n_out after rank clamping
    nbits = max(1, (n_cand - n_out).bit_length())
    assert nbits + val_bits <= 30
    acc_i = accept.astype(_I32)
    rank = jnp.cumsum(acc_i, axis=-1) - acc_i
    keep = accept & (rank < n_out)
    INVALID = jnp.int32(1) << 30
    pos = jnp.arange(n_cand, dtype=_I32)
    st = jnp.where(
        keep, ((pos - rank) << val_bits) | cand.astype(_I32), INVALID
    )
    fill = jnp.broadcast_to(INVALID, st.shape[:-1] + (1,))
    for b in range(nbits):
        sh = 1 << b
        if sh >= n_cand:
            break
        shv = jnp.int32(sh << val_bits)
        st_s = jnp.concatenate(
            [st[..., sh:], jnp.broadcast_to(fill, st.shape[:-1] + (sh,))],
            axis=-1,
        )
        move_in = (st_s & shv) != 0
        stay = (st & shv) == 0  # holes: bit clear -> stay as holes
        st = jnp.where(move_in, st_s - shv, jnp.where(stay, st, INVALID))
    head = st[..., :n_out]
    out = head & jnp.int32((1 << val_bits) - 1)
    ok = jnp.all((head >> val_bits) == 0, axis=-1)
    return out, ok


def _rank_compact(cand: jnp.ndarray, accept: jnp.ndarray, n_out: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Compact accepted candidates (in order) to the first n_out slots.

    cand, accept: [..., n_cand]. Returns ([..., n_out], ok[...]) where ok is
    False if fewer than n_out candidates were accepted (budget exhausted).

    General-rate fallback; when rejections are rare use
    `_rank_compact_sparse`. (A top_k-based compaction degenerates to a
    sort here: k is close to n_cand.)
    """
    n_cand = cand.shape[-1]
    batch = cand.shape[:-1]
    acc = accept.astype(_U32)
    rank = jnp.cumsum(acc, axis=-1) - acc
    idx = jnp.where(accept, rank, jnp.uint32(n_out))  # overflow slot -> drop
    # vmap of a 1-D scatter: compiles to one batched scatter without
    # materializing batch-index constants (compile-time critical at B>1k)
    def scat(c, i):
        return jnp.zeros((n_out,), dtype=cand.dtype).at[i].set(c, mode="drop")
    flat = jax.vmap(scat)(cand.reshape((-1, n_cand)), idx.reshape((-1, n_cand)))
    out = flat.reshape(batch + (n_out,))
    ok = (rank[..., -1] + acc[..., -1]) >= n_out
    return out, ok


def expand_a(
    rho: jnp.ndarray, p: DilithiumParams, max_skips: int = 12
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """ExpandA: rho uint8 [..., 32] -> (A_hat uint32 [..., K, L, 256], ok).

    A_hat is NTT-domain by definition. Nonce = (i << 8) + j, SHAKE128 over
    the 34-byte message rho||nonce16le (matches the RTL's 272-bit header,
    `sampler_a_ext.v:107`); candidates are 3-byte little-endian & 0x7FFFFF,
    accepted if < q (`rejection_a.v:67-91`).

    max_skips: compaction passes. The default 12 keeps P[budget miss]
    < 1e-20/poly — right for the expansion paths (expand_sk,
    build_operators, verify) that run once per key and DISCARD the ok
    flag. Keygen, which checks ok on every call, passes 8 (P < 5e-13/poly
    — ~1 flagged key per 10^11, never silently wrong) to shave a third of
    the compaction passes on its hot path.
    """
    batch = rho.shape[:-1]
    K, L = p.K, p.L
    nonces = jnp.asarray(
        [(i << 8) + j for i in range(K) for j in range(L)], dtype=_U32
    )
    msgs = jnp.concatenate(
        [
            jnp.broadcast_to(rho[..., None, :], batch + (K * L, 32)).astype(_U8),
            jnp.broadcast_to(_le16(nonces), batch + (K * L, 2)),
        ],
        axis=-1,
    )
    nbytes = p.uniform_blocks * SHAKE128_RATE
    words = keccak.shake128_words(msgs, nbytes // 4)  # [..., K*L, nbytes/4]
    cand = unpack_bits_w(words, 24) & jnp.uint32(0x7FFFFF)
    accept = cand < jnp.uint32(Q)
    # reject rate 8191/2^23 ~ 1e-3 (16x faster than the scatter
    # compaction here; passes scale linearly with max_skips — see
    # docstring for the budget/caller contract)
    out, ok = _rank_compact_sparse(cand, accept, N, max_skips=max_skips)
    return out.reshape(batch + (K, L, N)), jnp.all(ok, axis=-1)


def expand_s(
    sigma: jnp.ndarray, nonce_base: int, count: int, p: DilithiumParams
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """ExpandS: sigma uint8 [..., 64] -> (polys uint32 [..., count, 256], ok).

    Samples `count` polynomials with nonces nonce_base..nonce_base+count-1
    (s1 uses 0..L-1, s2 uses L..L+K-1 — `gen_s.v:115-155`). Each byte gives
    two 4-bit candidates, low nibble first; eta=2 keeps t<15 -> 2-(t mod 5),
    eta=4 keeps t<9 -> 4-t (`rejection_s.v:85-133`). Output canonical [0,q).
    """
    batch = sigma.shape[:-1]
    nonces = jnp.arange(nonce_base, nonce_base + count, dtype=_U32)
    msgs = jnp.concatenate(
        [
            jnp.broadcast_to(sigma[..., None, :], batch + (count, 64)).astype(_U8),
            jnp.broadcast_to(_le16(nonces), batch + (count, 2)),
        ],
        axis=-1,
    )
    nbytes = p.eta_blocks * SHAKE256_RATE
    words = keccak.shake256_words(msgs, nbytes // 4)
    nib = unpack_bits_w(words, 4).astype(jnp.uint8)  # [..., count, nbytes*2]
    # Compact the RAW 4-bit nibbles (uint8) and apply the eta value map
    # after compaction — order-preserving elementwise, so bit-identical,
    # and the compaction reduce moves 1/4 the bytes of the old
    # compact-the-mapped-uint32 form.
    # Both eta rates use the packed log-shift compaction with an 8-sigma
    # truncated window (r05): displacement-walk in ~log2 passes with the
    # nibble packed into the displacement word. ok is exact coverage;
    # an 8-sigma truncation miss (P < 1e-14/poly) reads as a budget
    # failure, never a wrong value.
    if p.eta == 2:
        accept = nib < 15
        out8, ok = _rank_compact_logshift_packed(
            nib, accept, N, val_bits=4, p_accept=15 / 16
        )
        out = uncenter(jnp.int32(2) - (out8 % 5))
    else:
        accept = nib < 9
        out8, ok = _rank_compact_logshift_packed(
            nib, accept, N, val_bits=4, p_accept=9 / 16
        )
        out = uncenter(jnp.int32(4) - out8)
    return out, jnp.all(ok, axis=-1)


def expand_mask(
    rhoprime: jnp.ndarray, kappa: jnp.ndarray, p: DilithiumParams
) -> jnp.ndarray:
    """ExpandMask: rhoprime uint8 [..., 64], kappa uint32 [...] ->
    y uint32 [..., L, 256] canonical, coefficients in [-gamma1+1, gamma1].

    Poly l uses nonce kappa + l (`expandmask_ext.v:287-293` — OFFSET += L
    per attempt lives in the caller's rejection loop). No rejection: fixed
    18/20-bit little-endian slices mapped to gamma1 - x (`rejection_y.v`).
    """
    batch = rhoprime.shape[:-1]
    L = p.L
    nonces = kappa[..., None].astype(_U32) + jnp.arange(L, dtype=_U32)
    msgs = jnp.concatenate(
        [
            jnp.broadcast_to(rhoprime[..., None, :], batch + (L, 64)).astype(_U8),
            _le16(nonces),
        ],
        axis=-1,
    )
    words = keccak.shake256_words(msgs, p.polyz_packedbytes // 4)
    r = unpack_bits_w(words, p.gamma1_bits).astype(_I32)  # [..., L, 256]
    return uncenter(jnp.int32(p.gamma1) - r)


def sample_in_ball(
    c_tilde: jnp.ndarray, p: DilithiumParams
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """SampleInBall: c_tilde uint8 [..., 32] -> (c uint32 [..., 256], ok).

    Fisher–Yates with tau swaps driven by a SHAKE256(c_tilde) byte stream:
    first 8 bytes are sign bits, then one byte per candidate position with
    rejection j > i (`gen_c.v:215-222, 330-343`). Both phases are fully
    unrolled elementwise graphs (no lax.scan): the 264-byte acceptance walk
    runs as a two-level chunked state-map composition over the tau+1
    possible fill counts, and the tau swap steps are one-hot selects over
    the 256 axis — everything fuses into a handful of elementwise
    kernels instead of a 264-step sequential scan.
    Output coefficients are canonical {0, 1, q-1}.
    """
    batch = c_tilde.shape[:-1]
    tau = p.tau
    nbytes = p.ball_blocks * SHAKE256_RATE
    stream = keccak.shake256(c_tilde, nbytes)  # [..., nbytes]
    sign_bytes = stream[..., :8].astype(_U32)
    sign_bits = (
        (sign_bytes[..., :, None] >> jnp.arange(8, dtype=_U32)) & 1
    ).reshape(batch + (64,))  # [..., 64], bit k = k-th sign
    bs = stream[..., 8:].astype(_I32)  # candidate position bytes
    nsteps = bs.shape[-1]

    # Phase 1 — acceptance walk. Byte t is consumed by Fisher–Yates step
    # i = (N - tau) + c_t iff byte <= i, where c_t = #accepted so far.
    # Equivalently with x_t = byte - (N - tau): take_t = (x_t <= c_t),
    # with the count capped at tau (x_t <= tau always holds for real
    # bytes, so the capped walk accepts everything once full — the
    # rank-compact below keeps only the first tau accepts, identical to
    # the RTL stopping at i = N). The walk has only tau+1 <= 61 states,
    # so: (a) per 16-byte chunk, advance ALL states 16 steps (vectorized
    # over chunks); (b) compose the chunk maps in order (17 tiny gathers);
    # (c) re-walk each chunk from its now-known entry state.
    x = bs - jnp.int32(N - tau)  # [..., nsteps], values <= tau
    CH = 16
    padn = (-nsteps) % CH
    if padn:
        x = jnp.concatenate(
            [x, jnp.full(batch + (padn,), 127, dtype=_I32)], axis=-1
        )  # 127 > tau: padding never accepted
    M = x.shape[-1] // CH
    xc = x.reshape(batch + (M, CH))

    # (a) chunk maps over all tau+1 entry states
    states = jnp.broadcast_to(
        jnp.arange(tau + 1, dtype=_I32), batch + (M, tau + 1)
    )
    for s in range(CH):
        xt = xc[..., s][..., None]  # [..., M, 1]
        states = jnp.minimum(states + (xt <= states).astype(_I32), tau)
    # (b) entry state of each chunk: compose maps left to right
    entry = jnp.zeros(batch, dtype=_I32) + (bs[..., 0] & 0)  # varying zeros
    entries = []
    for m in range(M):
        entries.append(entry)
        entry = jnp.take_along_axis(
            states[..., m, :], entry[..., None], axis=-1
        )[..., 0]
    ok = entry >= tau
    # (c) exact take flags from the per-chunk entry states
    st = jnp.stack(entries, axis=-1)  # [..., M]
    takes_l = []
    for s in range(CH):
        xt = xc[..., s]
        take = xt <= st
        takes_l.append(take)
        st = jnp.minimum(st + take.astype(_I32), tau)
    takes = jnp.stack(takes_l, axis=-1).reshape(batch + (M * CH,))[..., :nsteps]
    j_bytes, _ = _rank_compact(
        bs.astype(_U32), takes, tau
    )  # [..., tau]: the accepted j for steps t = 0..tau-1

    # Phase 2 — tau swap steps, unrolled, gather-free: all position
    # updates are one-hot selects over the 256 axis, i_t = N-tau+t is a
    # static column per step.
    cols = jnp.arange(N, dtype=_I32)  # [256]
    sval_t = jnp.where(
        sign_bits[..., :tau] == 1, jnp.uint32(Q - 1), jnp.uint32(1)
    )  # [..., tau]: sign value for step t (signs are consumed in step order)

    c = jnp.zeros(batch + (N,), dtype=_U32) + (
        (stream[..., 0] & jnp.uint8(0)).astype(_U32)[..., None]
    )
    for t in range(tau):
        j = j_bytes[..., t].astype(_I32)
        sval = sval_t[..., t]
        onehot_j = cols == j[..., None]            # [..., 256]
        onehot_i = cols == (N - tau + t)           # [256] (static col)
        cj = jnp.sum(jnp.where(onehot_j, c, jnp.uint32(0)), axis=-1)  # c[j]
        c = jnp.where(onehot_i, cj[..., None], c)    # c[i] = c[j]
        c = jnp.where(onehot_j, sval[..., None], c)  # c[j] = +-1 (after c[i])
    return c, ok
