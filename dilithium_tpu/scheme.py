"""Batched keygen / sign / verify drivers — the scheme control layer.

Batched replacement for the reference's `combined_top.v` (2553 lines of
cooperating FSMs sharing 2 NTT engines, 3 Keccak cores and 7 BRAMs). Here
each operation is one pure, jittable function over a batch: the FPGA's
spatial pipelining (FSM1 generates candidate y while FSM2 checks the
previous one, `combined_top.v:1823-2230`) becomes attempt-level parallelism
inside a `lax.while_loop` — every unfinished signature evaluates
`attempts_per_round` candidate nonces at once and keeps the first
acceptable one, which preserves the serial kappa ordering exactly
(`expandmask_ext.v:287-293`: OFFSET += L per attempt).

All functions take `DilithiumParams` as a static argument and operate on a
leading batch shape. Messages enter as the 64-byte mu = CRH(tr || M)
digest; `api.py` provides bytes-in/bytes-out wrappers that compute mu
(host-side for ragged lengths, on-device for fixed-length batches).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from dilithium_tpu.params import (
    Q, N, D, SEEDBYTES, TRBYTES, CRHBYTES, DilithiumParams,
)
from dilithium_tpu.ops import keccak, ntt, pack, rounding, sampling
from dilithium_tpu.ops.reduce import add_mod, sub_mod, uncenter, center

_U8 = jnp.uint8
_U32 = jnp.uint32
_I32 = jnp.int32


class KeyPair(NamedTuple):
    pk: jnp.ndarray  # uint8 [..., pk_bytes]
    sk: jnp.ndarray  # uint8 [..., sk_bytes]
    # raw components, for KAT component tests and expanded-key caching
    rho: jnp.ndarray
    key: jnp.ndarray
    tr: jnp.ndarray
    s1: jnp.ndarray  # canonical uint32 [..., L, 256]
    s2: jnp.ndarray  # canonical uint32 [..., K, 256]
    t0: jnp.ndarray  # centered int32 [..., K, 256]
    t1: jnp.ndarray  # uint32 [..., K, 256]
    ok: jnp.ndarray  # bool [...]: sampler budgets sufficed (never False in practice)


@partial(jax.jit, static_argnames=("p",))
def keygen(seed: jnp.ndarray, p: DilithiumParams) -> KeyPair:
    """Dilithium KeyGen. seed: uint8 [..., 32] (the KAT zeta).

    Flow mirrors SURVEY.md §3.1 (KG_* states of `combined_top.v:754-1079`):
    SHAKE256(zeta, 128) -> rho || sigma || K; A = ExpandA(rho);
    s1, s2 = ExpandS(sigma); t = INTT(A_hat · NTT(s1)) + s2;
    (t1, t0) = Power2Round(t); tr = SHAKE256(pk, 32).
    """
    seedbuf = keccak.shake256(seed, 2 * SEEDBYTES + CRHBYTES)
    rho = seedbuf[..., :SEEDBYTES]
    sigma = seedbuf[..., SEEDBYTES:SEEDBYTES + CRHBYTES]
    key = seedbuf[..., SEEDBYTES + CRHBYTES:]

    # max_skips=8: keygen CHECKS the ok flag every call, so the tighter
    # budget is safe here (and a third fewer compaction passes); the
    # flag-discarding expansion paths keep expand_a's safer default
    a_hat, ok_a = sampling.expand_a(rho, p, max_skips=8)
    # one fused ExpandS over nonces 0..L+K-1 (s1 then s2 — identical to
    # the reference's sequential nonce walk, `gen_s.v:115-155`); a single
    # XOF kernel + compaction over L+K polys instead of two launches
    s12, ok_s = sampling.expand_s(sigma, 0, p.L + p.K, p)
    s1 = s12[..., :p.L, :]
    s2 = s12[..., p.L:, :]

    s1_hat = ntt.ntt(s1)
    t = ntt.invntt(ntt.matvec(a_hat, s1_hat), from_product=True)
    t = add_mod(t, s2)
    t1, t0 = rounding.power2round(t)

    pk = pack.pack_pk(rho, t1, p)
    tr = keccak.shake256(pk, TRBYTES)
    sk = pack.pack_sk(rho, key, tr, s1, s2, t0, p)
    return KeyPair(pk, sk, rho, key, tr, s1, s2, t0, t1, ok_a & ok_s)


class SignResult(NamedTuple):
    sig: jnp.ndarray        # uint8 [..., sig_bytes]
    attempts: jnp.ndarray   # int32 [...]: rejection attempts used (1 = first try)
    ok: jnp.ndarray         # bool [...]: signature found within max_attempts


def validate_rhoprime(rhoprime: jnp.ndarray, expected_shape: Tuple[int, ...]) -> None:
    """Reject a rhoprime that is not exactly per-message shaped.

    NEVER broadcast a shared rhoprime across messages: y depends only on
    (rhoprime, kappa), so two messages accepting at the same kappa under
    one rhoprime leak s1 = (z1 - z2)/(c1 - c2) — full key recovery from
    two published signatures (classic nonce reuse). Trace-time check,
    shared by every signer that accepts a rhoprime override.
    """
    if rhoprime.shape != expected_shape:
        raise ValueError(
            f"rhoprime must be per-message, shape {expected_shape}; "
            f"got {rhoprime.shape}"
        )
    if rhoprime.dtype != jnp.uint8:
        raise ValueError(
            f"rhoprime must be uint8 bytes; got dtype {rhoprime.dtype} "
            "(a wider dtype would be silently truncated downstream)"
        )


class ExpandedKey(NamedTuple):
    """NTT-domain secret-key expansion, cacheable across sign calls.

    The FPGA re-expands Â and re-NTTs s1/s2/t0 on every sign invocation
    (FSM0 LOAD/DECODE/NTT states, `combined_top.v:1535-1820`); here the
    expansion is computed once per key and reused (SURVEY.md §5).
    """
    a_hat: jnp.ndarray   # uint32 [..., K, L, 256]
    s1_hat: jnp.ndarray  # uint32 [..., L, 256]
    s2_hat: jnp.ndarray  # uint32 [..., K, 256]
    t0_hat: jnp.ndarray  # uint32 [..., K, 256]
    key: jnp.ndarray     # uint8 [..., 32]
    tr: jnp.ndarray      # uint8 [..., 32]


@partial(jax.jit, static_argnames=("p",))
def expand_sk(sk: jnp.ndarray, p: DilithiumParams) -> ExpandedKey:
    """Unpack sk and precompute all NTT-domain key material."""
    rho, key, tr, s1, s2, t0 = pack.unpack_sk(sk, p)
    a_hat, ok_a = sampling.expand_a(rho, p)
    sampling.debug_check_ok(ok_a, "expand_sk.expand_a")
    return ExpandedKey(
        a_hat=a_hat,
        s1_hat=ntt.ntt(s1),
        s2_hat=ntt.ntt(s2),
        t0_hat=ntt.ntt(uncenter(t0)),
        key=key,
        tr=tr,
    )


def _sign_attempt(rho_a_hat, s1_hat, s2_hat, t0_hat, mu, rhoprime, kappa, p):
    """One candidate signature for nonce kappa. Returns per-lane results.

    Mirrors the FSM1/FSM2 body (`combined_top.v:1823-2230`): y -> w ->
    c -> z with the four rejection tests of the round-3 spec.
    All inputs carry a leading batch shape; kappa is uint32 [...].
    """
    a_hat = rho_a_hat
    y = sampling.expand_mask(rhoprime, kappa, p)  # [..., L, 256]
    y_hat = ntt.ntt(y)
    w = ntt.invntt(ntt.matvec(a_hat, y_hat), from_product=True)  # [..., K, 256]
    w1, w0 = rounding.decompose(w, p)

    w1_packed = pack.pack_w1(w1, p).reshape(
        w1.shape[:-2] + (p.K * p.polyw1_packedbytes,)
    )
    c_tilde = keccak.shake256(
        jnp.concatenate([mu.astype(_U8), w1_packed], axis=-1), SEEDBYTES
    )
    c, ok_ball = sampling.sample_in_ball(c_tilde, p)
    c_hat = ntt.ntt(c)

    cs1 = ntt.invntt(ntt.pointwise(c_hat[..., None, :], s1_hat), from_product=True)
    z = add_mod(y, cs1)  # canonical [..., L, 256]
    rej_z = rounding.norm_exceeds(z, p.gamma1 - p.beta, axis=(-2, -1))

    cs2 = ntt.invntt(ntt.pointwise(c_hat[..., None, :], s2_hat), from_product=True)
    w0_cs2 = w0 - center(cs2)  # centered int32, |.| < q
    rej_w0 = rounding.norm_exceeds(w0_cs2, p.gamma2 - p.beta, axis=(-2, -1))

    ct0 = ntt.invntt(ntt.pointwise(c_hat[..., None, :], t0_hat), from_product=True)
    ct0_c = center(ct0)
    rej_t0 = rounding.norm_exceeds(ct0_c, p.gamma2, axis=(-2, -1))

    hint_a0 = w0_cs2 + ct0_c
    h = rounding.make_hint(hint_a0, w1, p)  # [..., K, 256]
    nhints = jnp.sum(h, axis=(-2, -1))
    rej_h = nhints > jnp.uint32(p.omega)

    accept = ~(rej_z | rej_w0 | rej_t0 | rej_h) & ok_ball
    return c_tilde, z, h, accept


@partial(jax.jit, static_argnames=("p", "attempts_per_round", "max_rounds"))
def sign(
    sk: jnp.ndarray,
    mu: jnp.ndarray,
    p: DilithiumParams,
    attempts_per_round: int = 4,
    max_rounds: int = 64,
    rhoprime: jnp.ndarray | None = None,
) -> SignResult:
    """Dilithium sign. sk uint8 [..., sk_bytes], mu [..., 64].

    Deterministic by default (rhoprime = CRH(K || mu), the reference's
    only mode — `expandmask_ext.v:160-165`); pass uniformly random
    `rhoprime` uint8 [..., 64] for the round-3 spec's RANDOMIZED variant
    (the standard fault-attack countermeasure, docs/SECURITY.md).

    The rejection loop runs `attempts_per_round` candidate nonces per lane
    per `lax.while_loop` iteration (vectorized as an extra batch axis) and
    selects the lowest-kappa acceptable candidate — bit-identical to the
    serial loop of the spec, but with the loop-carried latency amortized
    (the FPGA instead overlaps attempt i+1's y/w with attempt i's check,
    `combined_top.v` FSM1/FSM2 interlock).
    """
    ek = expand_sk(sk, p)
    return sign_expanded(ek, mu, p, attempts_per_round=attempts_per_round,
                         max_rounds=max_rounds, rhoprime=rhoprime)


@partial(jax.jit, static_argnames=("p", "attempts_per_round", "max_rounds"))
def sign_expanded(
    ek: ExpandedKey,
    mu: jnp.ndarray,
    p: DilithiumParams,
    attempts_per_round: int = 4,
    max_rounds: int = 64,
    rhoprime: jnp.ndarray | None = None,
) -> SignResult:
    """Sign with a precomputed ExpandedKey (see `expand_sk`/`sign`)."""
    a_hat, s1_hat, s2_hat, t0_hat, key = (
        ek.a_hat, ek.s1_hat, ek.s2_hat, ek.t0_hat, ek.key,
    )
    batch = mu.shape[:-1]
    A = attempts_per_round

    def bcast(x, core_ndim):
        """Broadcast key material to mu's batch (shared-key caching case)."""
        return jnp.broadcast_to(x, batch + x.shape[x.ndim - core_ndim:])

    a_hat = bcast(a_hat, 3)
    s1_hat = bcast(s1_hat, 2)
    s2_hat = bcast(s2_hat, 2)
    t0_hat = bcast(t0_hat, 2)
    key = bcast(key, 1)

    if rhoprime is None:
        rhoprime = keccak.shake256(
            jnp.concatenate([key.astype(_U8), mu.astype(_U8)], axis=-1), CRHBYTES
        )
    else:
        validate_rhoprime(rhoprime, batch + (CRHBYTES,))

    # broadcast per-key data over the attempts axis: [..., A, ...]
    def rep(x):
        return jnp.broadcast_to(
            jnp.expand_dims(x, axis=len(batch)),
            batch + (A,) + x.shape[len(batch):],
        )

    a_hat_r = rep(a_hat)
    s1_hat_r = rep(s1_hat)
    s2_hat_r = rep(s2_hat)
    t0_hat_r = rep(t0_hat)
    mu_r = rep(mu)
    rhoprime_r = rep(rhoprime)

    def cond(state):
        done, *_ = state
        return ~jnp.all(done)

    def body(state):
        done, kappa, ct_out, z_out, h_out, attempts = state
        kappas = kappa[..., None] + jnp.arange(A, dtype=_U32) * jnp.uint32(p.L)
        c_tilde, z, h, accept = _sign_attempt(
            a_hat_r, s1_hat_r, s2_hat_r, t0_hat_r, mu_r, rhoprime_r, kappas, p
        )
        # first accepted attempt per lane (all-False -> A, clipped)
        first = jnp.argmax(accept, axis=-1).astype(_I32)
        any_acc = jnp.any(accept, axis=-1)
        sel = jnp.clip(first, 0, A - 1)

        def take(x):  # x: [..., A, ...] -> [...]
            return jnp.take_along_axis(
                x, sel.reshape(sel.shape + (1,) * (x.ndim - sel.ndim)), axis=len(batch)
            ).squeeze(axis=len(batch))

        # keep RAW accepted components; byte packing happens ONCE after the
        # loop — pack_sig (hint codec especially) costs more than a whole
        # attempt and must stay off the rejection loop's critical path
        newly = any_acc & ~done
        ct_out = jnp.where(newly[..., None], take(c_tilde), ct_out)
        z_out = jnp.where(newly[..., None, None], take(z), z_out)
        h_out = jnp.where(newly[..., None, None], take(h).astype(_U8), h_out)
        attempts = jnp.where(
            newly, attempts + first + 1,
            jnp.where(done, attempts, attempts + A),
        )
        kappa = jnp.where(done | newly, kappa, kappa + jnp.uint32(A * p.L))
        done = done | any_acc
        return done, kappa, ct_out, z_out, h_out, attempts

    # derive the zero state from mu so it inherits mu's varying manual axes
    # under shard_map (while_loop requires carry-in/out type equality)
    zero = mu[..., 0] & jnp.uint8(0)  # [...], all zeros
    state0 = (
        zero.astype(jnp.bool_),
        zero.astype(_U32),
        jnp.zeros(batch + (SEEDBYTES,), dtype=_U8) + zero[..., None],
        jnp.zeros(batch + (p.L, N), dtype=_U32) + zero[..., None, None].astype(_U32),
        jnp.zeros(batch + (p.K, N), dtype=_U8) + zero[..., None, None],
        zero.astype(_I32),
    )
    # bounded while loop: stop after max_rounds regardless (ok=False lanes)
    def cond_bounded(state_i):
        state, i = state_i
        return cond(state) & (i < max_rounds)

    def body_bounded(state_i):
        state, i = state_i
        return body(state), i + 1

    (done, kappa, ct_out, z_out, h_out, attempts), _ = jax.lax.while_loop(
        cond_bounded, body_bounded, (state0, jnp.int32(0))
    )
    sig_out = pack.pack_sig(ct_out, z_out, h_out.astype(_U32), p)
    return SignResult(sig_out, attempts, done)


@partial(jax.jit, static_argnames=("p", "window", "max_rounds"))
def sign_stream(
    ek: ExpandedKey,
    mu: jnp.ndarray,
    p: DilithiumParams,
    window: int = 768,
    max_rounds: int = 4096,
    rhoprime: jnp.ndarray | None = None,
) -> SignResult:
    """Throughput-optimal signing of a queue of messages under ONE key.

    `sign` runs its whole batch in lockstep until every lane accepts, so a
    batch of B pays ~max-of-B geometric attempts per lane (~8x waste at
    B=8k). Here W attempt SLOTS are distributed over the active messages
    each round by an elastic scheduler: in steady state every message gets
    one slot (one candidate nonce per round, refilled from the queue on
    accept); as the queue drains, idle slots speculatively evaluate the
    REMAINING messages' next kappa attempts in parallel (message i gets
    slots s with s mod n_active == i, evaluating kappa, kappa+L, ... in
    one round), so all W slots do useful work until the queue is truly
    empty and the drain tail costs ~1 round instead of ~max-of-W
    geometrics. This is the batched analog of the FPGA hiding attempt i+1's
    y/w generation behind attempt i's check (`combined_top.v` FSM1/FSM2
    interlock) — W-wide and attempt-speculative instead of 1 deep.

    Per-message results are bit-identical to `sign`/the serial spec: each
    message's kappa sequence starts at 0 and advances by L per attempt,
    and the FIRST accepted kappa is committed, regardless of how attempts
    are packed into slots (`expandmask_ext.v:287-293`).

    ek: unbatched ExpandedKey. mu: uint8 [Q, 64]. Returns SignResult [Q].
    """
    Q = mu.shape[0]
    W = min(window, Q)

    if rhoprime is None:  # deterministic mode; see `sign` for randomized
        key_b = jnp.broadcast_to(ek.key, (Q,) + ek.key.shape)
        rhoprime = keccak.shake256(
            jnp.concatenate([key_b.astype(_U8), mu.astype(_U8)], axis=-1), CRHBYTES
        )  # [Q, 64]
    else:
        validate_rhoprime(rhoprime, mu.shape)

    def bcast(x):
        return jnp.broadcast_to(x, (W,) + x.shape)

    a_hat = bcast(ek.a_hat)
    s1_hat = bcast(ek.s1_hat)
    s2_hat = bcast(ek.s2_hat)
    t0_hat = bcast(ek.t0_hat)

    def attempt(mu_s, rp_s, kappa_s, q_s):
        del q_s  # one key: material is slot-invariant
        return _sign_attempt(
            a_hat, s1_hat, s2_hat, t0_hat, mu_s, rp_s, kappa_s, p
        )

    return _stream_loop(attempt, mu, rhoprime, p, W, max_rounds)


@partial(jax.jit, static_argnames=("p", "window", "max_rounds", "sort_by_key"))
def sign_stream_keys(
    eks: ExpandedKey,
    key_idx: jnp.ndarray,
    mu: jnp.ndarray,
    p: DilithiumParams,
    window: int = 768,
    max_rounds: int = 8192,
    rhoprime: jnp.ndarray | None = None,
    sort_by_key: bool = False,
) -> SignResult:
    """Elastic stream signing of a message queue under MANY keys.

    The independent-keys counterpart of `sign_stream`: batched many-keys
    signing previously had only the lockstep `sign`, which pays ~max-of-B
    geometric attempts per batch; here each attempt slot gathers ITS
    message's key material by row, so distinct keys mix freely in one
    elastic window and per-message results stay bit-identical to
    `scheme.sign` (the reference analog: `combined_top.v` accepts a
    freshly streamed key on every sign invocation, `tb_sign_top.v:171-283`).

    eks: ExpandedKey with a leading key axis [Nk, ...] (stack `expand_sk`
    outputs, or call `expand_sk` on a batched sk). key_idx: int32 [Q]
    mapping each message to its key row. mu: uint8 [Q, 64].

    The per-round cost over `sign_stream` is the W-row gather of key
    material (~47 KB/slot at level 3) — HBM-bandwidth bound, small against
    the attempt compute.

    sort_by_key: pre-sort the QUEUE by key index (stable) before streaming
    and un-permute the results after, so the steady-state window holds
    runs of same-key slots and per-round `eks` row gathers hit coalesced
    indices. Per-message results are bit-identical either way (each
    message's kappa schedule is its own). A/B lever for the key-gather
    tax.
    """
    Q = mu.shape[0]
    W = min(window, Q)
    if key_idx.shape != (Q,):
        raise ValueError(f"key_idx must have shape ({Q},); got {key_idx.shape}")

    if rhoprime is None:  # deterministic mode; see `sign` for randomized
        key_b = jnp.take(eks.key, key_idx, axis=0)  # [Q, 32]
        rhoprime = keccak.shake256(
            jnp.concatenate([key_b.astype(_U8), mu.astype(_U8)], axis=-1), CRHBYTES
        )  # [Q, 64]
    else:
        validate_rhoprime(rhoprime, mu.shape)

    order = None
    if sort_by_key:
        order = jnp.argsort(key_idx, stable=True)  # queue order within key
        mu = jnp.take(mu, order, axis=0)
        rhoprime = jnp.take(rhoprime, order, axis=0)
        key_idx = jnp.take(key_idx, order)

    def attempt(mu_s, rp_s, kappa_s, q_s):
        kidx = jnp.take(key_idx, q_s)  # [W]
        a_hat = jnp.take(eks.a_hat, kidx, axis=0)
        s1_hat = jnp.take(eks.s1_hat, kidx, axis=0)
        s2_hat = jnp.take(eks.s2_hat, kidx, axis=0)
        t0_hat = jnp.take(eks.t0_hat, kidx, axis=0)
        return _sign_attempt(
            a_hat, s1_hat, s2_hat, t0_hat, mu_s, rp_s, kappa_s, p
        )

    res = _stream_loop(attempt, mu, rhoprime, p, W, max_rounds)
    if order is None:
        return res
    inv = jnp.zeros_like(order).at[order].set(jnp.arange(Q, dtype=order.dtype))
    return SignResult(
        jnp.take(res.sig, inv, axis=0),
        jnp.take(res.attempts, inv),
        jnp.take(res.ok, inv),
    )


def _stream_loop(attempt_fn, mu, rhoprime, p, W, max_rounds) -> SignResult:
    """Elastic attempt-slot loop shared by the generic and MXU signers.

    attempt_fn(mu_s uint8 [W,64], rp_s uint8 [W,64], kappa_s uint32 [W],
    q_s int32 [W] clamped queue index per slot — the hook the
    independent-keys signer uses to gather per-slot key material)
    -> (c_tilde, z, h, accept) per slot.

    Committed payloads are APPENDED to a log, not scattered to queue rows:
    each round compacts its committed items to the front (one-hot
    compare-reduce on the [W] index vectors — the same shape pack_hints and
    expand_s use), gathers those W payload rows once, and writes them with
    a single contiguous dynamic_update_slice at a running cursor — which
    XLA updates in place on the while carry. One Q-row gather after the
    loop restores queue order. (The log replaced per-row scatters on the
    previous accelerator, where row scatters were slow; whether a plain
    scatter commit is as fast on the GPU is not measured yet.)
    """
    Q = mu.shape[0]
    BIG = jnp.int32(1 << 20)
    LOGN = Q + W + 1  # payload log: <= Q commits + one W-block of slack
                      # + a never-written all-zero row (unsigned lanes)

    zero_w = (mu[:W, 0] & jnp.uint8(0)).astype(_I32)  # varying zeros [W]
    slots = jnp.arange(W, dtype=_I32)                 # static slot ids

    def cond(state):
        n_active, nxt, qidx, kappa, log_ptr, *_ = state
        return (n_active > 0) & (state[-1] < max_rounds)

    def body(state):
        (n_active, nxt, qidx, kappa, log_ptr,
         tgt_log, ct_log, z_log, h_log, att_log, rounds) = state

        # While every slot serves its own item (n_active == W, the whole
        # queue-consuming phase), the elastic slot map is the identity:
        # skip its runtime divisions/gathers via a scalar-predicate cond.
        # The elastic map only does real work during the drain tail.
        steady = n_active == jnp.int32(W)

        def slot_map_steady(qidx_, kappa_):
            # + zero_w: match the elastic branch's device-varying output
            # types under shard_map (cond requires identical vma)
            return qidx_, kappa_, slots + zero_w, zero_w  # q_s, kap_s, item, t

        def slot_map_elastic(qidx_, kappa_):
            na = jnp.maximum(n_active, 1)
            # slot s serves item s % na with attempt index t = s // na
            item = slots % na             # [W]
            t = slots // na               # [W]
            q_s = jnp.take(qidx_, item)   # queue index per slot
            kap_s = jnp.take(kappa_, item) + t * jnp.int32(p.L)
            return q_s, kap_s, item, t

        q_s, kap_s, item, t = jax.lax.cond(
            steady, slot_map_steady, slot_map_elastic, qidx, kappa
        )
        safe = jnp.minimum(q_s, Q - 1)
        mu_s = jnp.take(mu, safe, axis=0)
        rp_s = jnp.take(rhoprime, safe, axis=0)

        c_tilde, z, h, accept = attempt_fn(mu_s, rp_s, kap_s.astype(_U32), safe)
        accept = accept & (q_s < Q)

        # Steady commit also requires the queue to cover every refill this
        # round; otherwise fall through to the elastic commit, which
        # handles partial refill + front-compaction (the transition round
        # and the drain). With n_active == W the elastic commit computes
        # the same function, so gating on the cheaper path is safe.
        n_acc = jnp.sum(accept.astype(_I32))
        use_steady = steady & (nxt + n_acc <= Q)

        # Branches return only [W] index/metadata vectors — the heavy
        # z/h/c_tilde payloads never cross the cond boundary.
        def commit_steady(qidx_, kappa_):
            committed = accept            # slot == item
            tgt = jnp.where(committed, qidx_, Q)
            win_slot = slots + zero_w
            att_val = kappa_ // p.L + 1
            acc_i = committed.astype(_I32)
            rank = jnp.cumsum(acc_i) - acc_i
            qidx_new = jnp.where(committed, nxt + rank, qidx_)
            kappa_new = jnp.where(committed, 0, kappa_ + jnp.int32(p.L))
            return (
                committed, win_slot, tgt, att_val,
                jnp.int32(W) + zero_w[0], nxt + n_acc, qidx_new, kappa_new,
            )

        def commit_elastic(qidx_, kappa_):
            na = jnp.maximum(n_active, 1)
            # per item: smallest accepted attempt index among its slots
            win_t = jnp.full((W,), BIG, dtype=_I32) + zero_w
            win_t = win_t.at[item].min(jnp.where(accept, t, BIG), mode="drop")
            committed = win_t < BIG       # [W] (item-indexed)
            # winning slot of item i is i + na * win_t[i]
            win_slot = jnp.minimum(
                slots + na * jnp.where(committed, win_t, 0), W - 1
            )
            tgt = jnp.where(committed, qidx_, Q)  # only committed items
            att_val = kappa_ // p.L + jnp.where(committed, win_t, 0) + 1

            # advance kappa of surviving items by their slot count
            n_slots = W // na + (slots < W % na).astype(_I32)
            kappa_adv = kappa_ + n_slots * jnp.int32(p.L)

            # compact survivors to the front, refill the tail
            alive = (slots < n_active) & ~committed
            rank = jnp.cumsum(alive.astype(_I32)) - alive.astype(_I32)
            n_surv = jnp.sum(alive.astype(_I32))
            pos = jnp.where(alive, rank, W)  # W = dropped
            qidx_new = jnp.full((W,), Q, dtype=_I32) + zero_w
            kappa_new = zero_w
            qidx_new = qidx_new.at[pos].set(qidx_, mode="drop")
            kappa_new = kappa_new.at[pos].set(kappa_adv, mode="drop")
            fresh = nxt + (slots - n_surv)
            take_fresh = (slots >= n_surv) & (fresh < Q)
            qidx_new = jnp.where(take_fresh, fresh, qidx_new)
            kappa_new = jnp.where(take_fresh, 0, kappa_new)
            n_fresh = jnp.sum(take_fresh.astype(_I32))
            return (
                committed, win_slot, tgt, att_val,
                n_surv + n_fresh, nxt + n_fresh, qidx_new, kappa_new,
            )

        (committed, win_slot, tgt, att_val,
         n_active_new, nxt_new, qidx_new, kappa_new) = jax.lax.cond(
            use_steady, commit_steady, commit_elastic, qidx, kappa
        )

        # Append committed payloads to the log. Compact the committed
        # items' winning slots / queue targets / attempt counts to the
        # front with a one-hot compare-reduce over [W, W] (a 1-D index
        # scatter here would cost as much as the row scatters this design
        # removes), gather the W payload rows once, and write them as one
        # contiguous block at the cursor.
        #
        # The cutoff and the cursor advance are the COMMITTED-ITEM count,
        # not the accepting-slot count n_acc: in elastic drain rounds two
        # slots of one item can both accept (speculative kappas), and rows
        # in [n_commit, n_acc) would have all-false `sel`, appending bogus
        # entries that target queue item 0 with attempts 0. n_acc stays
        # only in the use_steady gate / commit_steady's nxt advance, where
        # slot == item makes the two counts equal.
        n_commit = jnp.sum(committed.astype(_I32))
        acc_i = committed.astype(_I32)
        rank = jnp.cumsum(acc_i) - acc_i
        out_i = jnp.arange(W, dtype=_I32)[:, None]          # [W, 1]
        sel = committed[None, :] & (rank[None, :] == out_i)  # [W, W]
        src = jnp.sum(jnp.where(sel, win_slot[None, :], 0), axis=-1)
        tgt_c = jnp.where(
            out_i[:, 0] < n_commit,
            jnp.sum(jnp.where(sel, tgt[None, :], 0), axis=-1),
            Q,  # rows past this round's commits: drop at the final gather
        )
        att_c = jnp.sum(jnp.where(sel, att_val[None, :], 0), axis=-1)

        ct_sel = jnp.take(c_tilde, src, axis=0)
        z_sel = jnp.take(z, src, axis=0)
        h_sel = jnp.take(h, src, axis=0).astype(_U8)
        zero3 = (log_ptr & 0,) * 2
        ct_log = jax.lax.dynamic_update_slice(ct_log, ct_sel, (log_ptr,) + zero3[:1])
        z_log = jax.lax.dynamic_update_slice(z_log, z_sel, (log_ptr,) + zero3)
        h_log = jax.lax.dynamic_update_slice(h_log, h_sel, (log_ptr,) + zero3)
        tgt_log = jax.lax.dynamic_update_slice(tgt_log, tgt_c, (log_ptr,))
        att_log = jax.lax.dynamic_update_slice(att_log, att_c, (log_ptr,))
        return (
            n_active_new, nxt_new, qidx_new, kappa_new, log_ptr + n_commit,
            tgt_log, ct_log, z_log, h_log, att_log, rounds + 1,
        )

    z8 = (zero_w[0] & 0).astype(_U8)
    state0 = (
        jnp.int32(W) + zero_w[0],                        # n_active
        jnp.int32(W) + zero_w[0],                        # next unassigned
        jnp.arange(W, dtype=_I32) + zero_w,              # qidx (item -> queue)
        zero_w,                                          # kappa per item
        zero_w[0],                                       # log cursor
        jnp.full((LOGN,), Q, dtype=_I32) + zero_w[0],    # tgt_log (Q = unused)
        jnp.zeros((LOGN, SEEDBYTES), dtype=_U8) + z8,    # c_tilde log
        jnp.zeros((LOGN, p.L, N), dtype=_U32) + z8.astype(_U32),  # z log
        jnp.zeros((LOGN, p.K, N), dtype=_U8) + z8,       # hint bitmap log
        zero_w[0] + jnp.zeros((LOGN,), dtype=_I32),      # attempts log
        zero_w[0],                                       # round counter
    )
    (n_active, nxt, qidx, kappa, log_ptr,
     tgt_log, ct_log, z_log, h_log, att_log, rounds) = (
        jax.lax.while_loop(cond, body, state0)
    )
    # restore queue order: log row of queue item q, defaulting to the
    # never-written all-zero last row (unsigned lanes -> attempts 0)
    inv = jnp.full((Q,), LOGN - 1, dtype=_I32) + zero_w[0]
    inv = inv.at[tgt_log].set(jnp.arange(LOGN, dtype=_I32), mode="drop")
    ct_q = jnp.take(ct_log, inv, axis=0)
    z_q = jnp.take(z_log, inv, axis=0)
    h_q = jnp.take(h_log, inv, axis=0)
    att_out = jnp.take(att_log, inv, axis=0)
    sig_out = pack.pack_sig(ct_q, z_q, h_q.astype(_U32), p)
    ok = att_out > 0
    return SignResult(sig_out, att_out, ok)


def _verify_tail(w, h, c_tilde, mu, pre_ok, p: DilithiumParams) -> jnp.ndarray:
    """Shared verify epilogue: w' -> UseHint -> H(mu || w1') compare.

    w: uint32 [..., K, 256] canonical (= INTT(A_hat·z_hat - c_hat·t1_hat),
    however computed — NTT pipeline or dense MXU operators). Mirrors the
    VY_GENW1/VY_COMPARE states (`combined_top.v:1470-1534, 2450-2457`).
    """
    w1 = rounding.use_hint(h, w, p)
    w1_packed = pack.pack_w1(w1, p).reshape(
        w1.shape[:-2] + (p.K * p.polyw1_packedbytes,)
    )
    c_tilde2 = keccak.shake256(
        jnp.concatenate([mu.astype(_U8), w1_packed], axis=-1), SEEDBYTES
    )
    return pre_ok & jnp.all(c_tilde == c_tilde2, axis=-1)


def _verify_core(a_hat, t1_hat, sig, mu, p: DilithiumParams) -> jnp.ndarray:
    """Verify against NTT-domain key material (already batch-shaped)."""
    c_tilde, z, h, h_ok = pack.unpack_sig(sig, p)
    z_ok = ~rounding.norm_exceeds(z, p.gamma1 - p.beta, axis=(-2, -1))

    c, _ = sampling.sample_in_ball(c_tilde, p)
    c_hat = ntt.ntt(c)
    z_hat = ntt.ntt(z)

    az = ntt.matvec(a_hat, z_hat)                       # carries R^-1
    ct1 = ntt.pointwise(c_hat[..., None, :], t1_hat)    # carries R^-1
    w = ntt.invntt(sub_mod(az, ct1), from_product=True)  # [..., K, 256]
    return _verify_tail(w, h, c_tilde, mu, z_ok & h_ok, p)


@partial(jax.jit, static_argnames=("p",))
def verify(pk: jnp.ndarray, sig: jnp.ndarray, mu: jnp.ndarray, p: DilithiumParams) -> jnp.ndarray:
    """Dilithium verify. pk [..., pk_bytes], sig [..., sig_bytes], mu [..., 64].

    Returns bool [...]. Flow mirrors SURVEY.md §3.3 (VY_* states,
    `combined_top.v:1100-1534`): w' = INTT(A_hat·NTT(z) - NTT(c)·NTT(t1·2^d));
    w1' = UseHint(h, w'); accept iff c_tilde == H(mu || w1') and encodings
    are canonical and ||z|| is in range.

    Expands A per batch lane — right for independent keys. A one-key
    verify service should use `expand_pk` + `verify_expanded` (or the MXU
    path, `mxu.verify_mxu`) so ExpandA runs once, not once per lane.
    """
    rho, t1 = pack.unpack_pk(pk, p)
    a_hat, ok_a = sampling.expand_a(rho, p)
    sampling.debug_check_ok(ok_a, "verify.expand_a")
    t1_hat = ntt.ntt(t1.astype(_U32) << D)  # t1*2^13 <= q-1: stays canonical
    return _verify_core(a_hat, t1_hat, sig, mu, p)


class ExpandedPk(NamedTuple):
    """NTT-domain public-key expansion, cacheable across verify calls.

    The verify analog of `ExpandedKey`: the FPGA re-expands Â from rho on
    every verify invocation (VY_LOAD_RHO, `combined_top.v:1100-1206`); a
    one-key verify service computes it once.
    """
    a_hat: jnp.ndarray   # uint32 [..., K, L, 256]
    t1_hat: jnp.ndarray  # uint32 [..., K, 256] = NTT(t1 << d)
    tr: jnp.ndarray      # uint8 [..., 32] (mu = CRH(tr || M) precursor)


@partial(jax.jit, static_argnames=("p",))
def expand_pk(pk: jnp.ndarray, p: DilithiumParams) -> ExpandedPk:
    """Unpack pk and precompute all NTT-domain verification material."""
    rho, t1 = pack.unpack_pk(pk, p)
    a_hat, ok_a = sampling.expand_a(rho, p)
    sampling.debug_check_ok(ok_a, "expand_pk.expand_a")
    t1_hat = ntt.ntt(t1.astype(_U32) << D)
    tr = keccak.shake256(pk, TRBYTES)
    return ExpandedPk(a_hat=a_hat, t1_hat=t1_hat, tr=tr)


@partial(jax.jit, static_argnames=("p",))
def verify_expanded(
    epk: ExpandedPk, sig: jnp.ndarray, mu: jnp.ndarray, p: DilithiumParams
) -> jnp.ndarray:
    """Verify a batch of signatures under ONE precomputed ExpandedPk.

    epk: unbatched. sig uint8 [..., sig_bytes], mu uint8 [..., 64].
    """
    batch = mu.shape[:-1]
    a_hat = jnp.broadcast_to(epk.a_hat, batch + epk.a_hat.shape)
    t1_hat = jnp.broadcast_to(epk.t1_hat, batch + epk.t1_hat.shape)
    return _verify_core(a_hat, t1_hat, sig, mu, p)
