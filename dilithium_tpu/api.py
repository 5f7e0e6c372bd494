"""Bytes-in / bytes-out user API — the host-bus layer.

The reference exposes one streaming top (`combined_top.v:26-42`): mode
(0=keygen, 1=verify, 2=sign) + sec_lvl (2/3/5) selected at runtime, keys
and signatures streamed as bytes. This module is that surface for the
library: NumPy bytes in, NumPy bytes out, arbitrary-length messages (the
mu = CRH(tr || M) digest is computed host-side with hashlib — messages
are ragged and hashing them is not device work; fixed 64-byte mu batches
feed the jitted device drivers).

For throughput-critical callers, `Signer` caches the expanded key
(A_hat / s1_hat / s2_hat / t0_hat NTTs) across calls — the library analog
of the FPGA keeping Â resident in BRAM0 across sign invocations.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import warnings
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import jax
import jax.numpy as jnp

_CRH_FALLBACK_WARNED = False

from dilithium_tpu import scheme
from dilithium_tpu.params import TRBYTES, CRHBYTES, SEEDBYTES, DilithiumParams, get_params

Bytes = Union[bytes, bytearray, memoryview]


def _as_rows(rows: Sequence[Bytes], length: int, name: str) -> np.ndarray:
    out = np.zeros((len(rows), length), dtype=np.uint8)
    for i, r in enumerate(rows):
        b = bytes(r)
        if len(b) != length:
            raise ValueError(f"{name}[{i}] has {len(b)} bytes, expected {length}")
        out[i] = np.frombuffer(b, dtype=np.uint8)
    return out


def compute_mu(tr: Bytes, message: Bytes) -> bytes:
    """mu = CRH(tr || M) — SHAKE256, 64 bytes (`expandmask_ext.v:131-136`)."""
    h = hashlib.shake_256()
    h.update(bytes(tr))
    h.update(bytes(message))
    return h.digest(CRHBYTES)


def compute_mu_many(trs, messages: Sequence[Bytes]) -> np.ndarray:
    """mu rows for a ragged message batch — native thread pool when available.

    trs: one 32-byte tr (bytes) shared by all messages, or a list of n
    32-byte trs. Uses the C++ oracle's multithreaded SHAKE256 batch
    (`cpp/oracle_api.cpp oracle_crh_batch`) when the library is buildable;
    falls back to the per-message hashlib loop otherwise. Returns uint8
    [n, 64]. ~3 us/message single-threaded hashlib vs ~the device's
    per-sign time at large batches — the host half of the serving path.
    """
    n = len(messages)
    if n == 0:
        return np.zeros((0, CRHBYTES), dtype=np.uint8)
    if isinstance(trs, (bytes, bytearray, memoryview)):
        trs_arr = np.frombuffer(bytes(trs), dtype=np.uint8)
        tr_list = [bytes(trs)] * n
    else:
        tr_list = [bytes(t) for t in trs]
        if len(tr_list) != n:
            raise ValueError(f"{len(tr_list)} trs for {n} messages")
        trs_arr = np.stack([np.frombuffer(t, dtype=np.uint8) for t in tr_list])
    if any(len(t) != TRBYTES for t in tr_list):
        raise ValueError(f"every tr must be {TRBYTES} bytes")
    if n >= 64:
        try:
            from dilithium_tpu import oracle
            return oracle.crh_batch(trs_arr, messages)
        except (OSError, subprocess.CalledProcessError, AttributeError) as e:
            # Only expected-unavailability errors reach the fallback (no
            # toolchain / failed build / stale .so missing the symbol);
            # genuine crh_batch failures must propagate, not be silently
            # papered over by hashlib. Warn once per process.
            global _CRH_FALLBACK_WARNED
            if not _CRH_FALLBACK_WARNED:
                _CRH_FALLBACK_WARNED = True
                warnings.warn(
                    f"native crh_batch unavailable ({e!r}); falling back to "
                    "per-message hashlib (slower serving path)",
                    RuntimeWarning,
                    stacklevel=2,
                )
    return np.stack([
        np.frombuffer(compute_mu(t, m), dtype=np.uint8)
        for t, m in zip(tr_list, messages)
    ])


def compute_mu_batch(tr: jnp.ndarray, messages: jnp.ndarray) -> jnp.ndarray:
    """Batched on-device mu = CRH(tr || M) for FIXED-length messages.

    tr uint8 [..., 32] (or [32], broadcast), messages uint8 [..., mlen] —
    the device analog of the reference streaming tr then M into its SHAKE
    core (`expandmask_ext.v:126-153`); use when a batch of equal-length
    messages should be hashed on-chip instead of per-row hashlib calls
    (ragged batches go through `compute_mu`). Returns uint8 [..., 64].
    """
    from dilithium_tpu.ops import keccak

    tr = jnp.asarray(tr, dtype=jnp.uint8)
    messages = jnp.asarray(messages, dtype=jnp.uint8)
    batch = messages.shape[:-1]
    tr_b = jnp.broadcast_to(tr, batch + (TRBYTES,))
    return keccak.shake256(
        jnp.concatenate([tr_b, messages], axis=-1), CRHBYTES
    )


# ---------------------------------------------------------------------------
# Persisted key expansions — the checkpoint/resume analog (SURVEY.md §5):
# the scheme itself is stateless, so the only state worth persisting is the
# per-key expansion (NTT-domain key material or dense MXU operators). The
# cache is validated against a digest of the key bytes, so a stale or
# foreign file silently falls back to recomputation.
# ---------------------------------------------------------------------------


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _save_expansion(path: str, obj, meta: dict) -> None:
    arrs = {f: np.asarray(getattr(obj, f)) for f in type(obj)._fields}
    meta_b = np.frombuffer(_json().dumps(meta).encode(), dtype=np.uint8)
    np.savez(_npz(path), __meta__=meta_b, **arrs)


def _load_expansion(path: str, cls, meta: dict):
    """Returns cls(...) on a valid cache hit, else None."""
    try:
        z = np.load(_npz(path))
        stored = _json().loads(bytes(z["__meta__"]).decode())
        if stored != meta:
            return None
        return cls(**{f: jnp.asarray(z[f]) for f in cls._fields})
    except (OSError, KeyError, ValueError):
        return None


def _json():
    import json
    return json


def _expansion_meta(kind: str, level: int, key_bytes: bytes) -> dict:
    return {
        "kind": kind,
        "level": level,
        "key_sha256": hashlib.sha256(key_bytes).hexdigest(),
    }


def resolve_mode(mode: str, platform: Optional[str] = None) -> str:
    """The service path `Signer` / `Verifier` use for `mode`.

    "auto" resolves by the platform of JAX's default device (or
    `platform`): "gpu" gets "mxu" (int8 operators + elastic stream
    scheduler), "cpu" gets "batch" (the NTT pipeline, cheap to compile).
    Any other platform raises: it has no measured default.
    """
    if mode == "auto":
        platform = platform or jax.devices()[0].platform
        if platform == "gpu":
            return "mxu"
        if platform == "cpu":
            return "batch"
        raise ValueError(f"no default service mode for platform {platform!r}; "
                         "pass mode='mxu' or mode='batch'")
    if mode not in ("mxu", "batch"):
        raise ValueError(f"unknown mode {mode!r}")
    return mode


def keygen(level: int, seeds: Sequence[Bytes]) -> Tuple[list, list]:
    """Batch keygen. seeds: 32-byte each. Returns (pks, sks) as bytes lists."""
    p = get_params(level)
    arr = _as_rows(seeds, SEEDBYTES, "seed")
    kp = scheme.keygen(jnp.asarray(arr), p)
    if not bool(np.asarray(kp.ok).all()):
        raise RuntimeError("sampler block budget exceeded (p < 1e-50; re-seed)")
    pk = np.asarray(kp.pk)
    sk = np.asarray(kp.sk)
    return [bytes(r) for r in pk], [bytes(r) for r in sk]


def _fresh_rhoprime(n: int):
    """n uniformly random 64-byte rhoprime rows (randomized signing)."""
    buf = os.urandom(n * CRHBYTES)
    return jnp.asarray(
        np.frombuffer(buf, dtype=np.uint8).reshape(n, CRHBYTES)
    )


def sign(level: int, sk: Bytes, messages: Sequence[Bytes],
         randomized: bool = False) -> list:
    """Sign a batch of messages under one secret key. Returns signatures.

    randomized=True uses the round-3 spec's randomized variant (rhoprime
    drawn from os.urandom instead of CRH(K || mu)) — the standard
    fault-attack countermeasure; signatures still verify identically but
    are no longer a deterministic function of (sk, message).
    """
    p = get_params(level)
    sk_b = bytes(sk)
    if len(sk_b) != p.sk_bytes:
        raise ValueError(f"sk has {len(sk_b)} bytes, expected {p.sk_bytes}")
    tr = sk_b[2 * SEEDBYTES: 2 * SEEDBYTES + TRBYTES]
    mus = compute_mu_many(tr, messages)
    sk_arr = jnp.asarray(np.frombuffer(sk_b, dtype=np.uint8))
    sk_rep = jnp.broadcast_to(sk_arr, (len(messages), p.sk_bytes))
    rp = _fresh_rhoprime(len(messages)) if randomized else None
    res = scheme.sign(sk_rep, jnp.asarray(mus), p, rhoprime=rp)
    if not bool(np.asarray(res.ok).all()):
        raise RuntimeError("sign did not converge within max_rounds")
    return [bytes(r) for r in np.asarray(res.sig)]


def _coerce_pairs(p: DilithiumParams, tr: bytes, message_sig_pairs) -> Tuple[np.ndarray, np.ndarray]:
    sigs = []
    for _, s in message_sig_pairs:
        s = bytes(s)
        if len(s) != p.sig_bytes:
            # malformed length: definitionally invalid, mark via junk sig
            s = b"\x01" * p.sig_bytes
        sigs.append(np.frombuffer(s, dtype=np.uint8))
    mus = compute_mu_many(tr, [m for m, _ in message_sig_pairs])
    return mus, np.stack(sigs)


def verify(level: int, pk: Bytes, message_sig_pairs: Sequence[Tuple[Bytes, Bytes]]) -> list:
    """Verify a batch of (message, signature) pairs under one public key.

    Expands the key once (`scheme.expand_pk`) and verifies the batch
    against it; for a persistent service caching the expansion across
    calls, use `Verifier`.
    """
    p = get_params(level)
    pk_b = bytes(pk)
    if len(pk_b) != p.pk_bytes:
        raise ValueError(f"pk has {len(pk_b)} bytes, expected {p.pk_bytes}")
    tr = hashlib.shake_256(pk_b).digest(TRBYTES)
    mus, sigs = _coerce_pairs(p, tr, message_sig_pairs)
    epk = scheme.expand_pk(
        jnp.asarray(np.frombuffer(pk_b, dtype=np.uint8)), p
    )
    ok = scheme.verify_expanded(epk, jnp.asarray(sigs), jnp.asarray(mus), p)
    return [bool(x) for x in np.asarray(ok)]


class Signer:
    """Persistent signing service for one key — caches the expanded key.

    The FPGA re-streams the full sk and re-expands Â on every sign call
    (`tb_sign_top.v:171-283`); here the per-key expansion stays resident
    in device memory (SURVEY.md §5 checkpoint/resume: "persisted expanded
    keys (Â cache) as an optimization toggle").

    mode:
      "mxu"    — dense per-key int8 operators on the tensor cores +
                 elastic stream scheduler (`mxu.sign_stream_mxu`): the
                 serving path, but each distinct batch length compiles
                 its own stream graph.
      "batch"  — lockstep `scheme.sign_expanded`: compile-cheap; right for
                 the CPU and small/ragged batches.
      "auto"   — by platform (`resolve_mode`): "mxu" on a GPU, "batch" on
                 the CPU; any other platform raises.

    cache_path: optional .npz path persisting the per-key expansion across
    processes (the checkpoint/resume analog, SURVEY.md §5). On a valid hit
    (same key digest / level / mode) the expansion is loaded instead of
    recomputed; otherwise it is computed and written.
    """

    def __init__(self, level: int, sk: Bytes, mode: str = "auto",
                 window: int = 768, cache_path: Optional[str] = None):
        self.p = get_params(level)
        self.level = level
        sk_b = bytes(sk)
        if len(sk_b) != self.p.sk_bytes:
            raise ValueError(f"sk has {len(sk_b)} bytes, expected {self.p.sk_bytes}")
        self.sk = jnp.asarray(np.frombuffer(sk_b, dtype=np.uint8))
        self.tr = sk_b[2 * SEEDBYTES: 2 * SEEDBYTES + TRBYTES]
        mode = resolve_mode(mode)
        self.mode = mode
        self.window = window
        if mode == "mxu":
            from dilithium_tpu import mxu as _mxu
            self._mxu = _mxu
            # .v3: operators stored as wy_cat/c_cat concatenations only —
            # older cache files must miss cleanly and recompute
            meta = _expansion_meta("KeyOperators.v3", level, sk_b)
            self.operators = (
                _load_expansion(cache_path, _mxu.KeyOperators, meta)
                if cache_path else None
            )
            if self.operators is None:
                # dense operators once per key; every sign() reuses them
                self.operators = _mxu.build_operators(self.sk, self.p)
                jax.block_until_ready(self.operators)
                if cache_path:
                    _save_expansion(cache_path, self.operators, meta)
        else:
            meta = _expansion_meta("ExpandedKey", level, sk_b)
            self.expanded = (
                _load_expansion(cache_path, scheme.ExpandedKey, meta)
                if cache_path else None
            )
            if self.expanded is None:
                # expand once; every sign() reuses the NTT-domain material
                self.expanded = scheme.expand_sk(self.sk, self.p)
                jax.block_until_ready(self.expanded)
                if cache_path:
                    _save_expansion(cache_path, self.expanded, meta)

    def sign(self, messages: Sequence[Bytes], randomized: bool = False) -> list:
        """randomized=True: spec randomized variant (see api.sign)."""
        mus = compute_mu_many(self.tr, messages)
        rp = _fresh_rhoprime(len(messages)) if randomized else None
        if self.mode == "mxu":
            res = self._mxu.sign_stream_mxu(
                self.operators, jnp.asarray(mus), self.p, window=self.window,
                rhoprime=rp,
            )
        else:
            res = scheme.sign_expanded(
                self.expanded, jnp.asarray(mus), self.p, rhoprime=rp
            )
        if not bool(np.asarray(res.ok).all()):
            raise RuntimeError("sign did not converge within max_rounds")
        return [bytes(r) for r in np.asarray(res.sig)]


class MultiSigner:
    """Persistent signing service for MANY keys in one elastic window.

    The independent-keys counterpart of `Signer`: all keys' NTT-domain
    expansions are held as one batched `ExpandedKey`, and each sign call
    routes a mixed-key message queue through `scheme.sign_stream_keys`,
    whose attempt slots gather their own key's material by row — no
    lockstep max-of-batch rejection waste, one compiled graph for any key
    mix. It runs the NTT pipeline on every platform: the int8 operators
    are per key (~5.9 MB at level 3), so `mode` does not apply here.
    The reference analog is `combined_top.v` accepting a freshly streamed
    key every sign invocation (`tb_sign_top.v:171-283`).
    """

    def __init__(self, level: int, sks: Sequence[Bytes], window: int = 768):
        self.p = get_params(level)
        self.level = level
        arr = _as_rows(sks, self.p.sk_bytes, "sk")
        self.trs = [
            bytes(r[2 * SEEDBYTES: 2 * SEEDBYTES + TRBYTES]) for r in arr
        ]
        self.window = window
        # one batched expansion over the key axis, computed once
        self.expanded = scheme.expand_sk(jnp.asarray(arr), self.p)
        jax.block_until_ready(self.expanded)

    def sign(self, key_message_pairs: Sequence[Tuple[int, Bytes]],
             randomized: bool = False) -> list:
        """Sign [(key_index, message), ...] -> signatures in order.

        randomized=True: spec randomized variant (see api.sign).
        """
        if not key_message_pairs:
            return []
        idx = np.asarray([i for i, _ in key_message_pairs], dtype=np.int32)
        if idx.size and (idx.min() < 0 or idx.max() >= len(self.trs)):
            raise IndexError(
                f"key index out of range 0..{len(self.trs) - 1}"
            )
        mus = compute_mu_many(
            [self.trs[i] for i, _ in key_message_pairs],
            [m for _, m in key_message_pairs],
        )
        rp = _fresh_rhoprime(len(key_message_pairs)) if randomized else None
        res = scheme.sign_stream_keys(
            self.expanded, jnp.asarray(idx), jnp.asarray(mus), self.p,
            window=self.window, rhoprime=rp,
        )
        if not bool(np.asarray(res.ok).all()):
            raise RuntimeError("sign did not converge within max_rounds")
        return [bytes(r) for r in np.asarray(res.sig)]


class Verifier:
    """Persistent verify service for one public key.

    The FPGA re-streams the pk and re-expands Â on every verify call
    (VY_LOAD_RHO, `combined_top.v:1100-1206`); here the per-key expansion
    is computed once and every `verify()` call reuses it.

    mode:
      "mxu"    — dense z->Az / c->c.t1 int8 operators on the tensor cores
                 (`mxu.verify_mxu`).
      "batch"  — NTT-pipeline `scheme.verify_expanded`: compile-cheap.
      "auto"   — by platform (`resolve_mode`): "mxu" on a GPU, "batch" on
                 the CPU; any other platform raises.

    cache_path: optional .npz persisting the expansion (see `Signer`).
    """

    def __init__(self, level: int, pk: Bytes, mode: str = "auto",
                 cache_path: Optional[str] = None):
        self.p = get_params(level)
        self.level = level
        pk_b = bytes(pk)
        if len(pk_b) != self.p.pk_bytes:
            raise ValueError(f"pk has {len(pk_b)} bytes, expected {self.p.pk_bytes}")
        self.pk = jnp.asarray(np.frombuffer(pk_b, dtype=np.uint8))
        self.tr = hashlib.shake_256(pk_b).digest(TRBYTES)
        mode = resolve_mode(mode)
        self.mode = mode
        if mode == "mxu":
            from dilithium_tpu import mxu as _mxu
            self._mxu = _mxu
            meta = _expansion_meta("VerifyOperators", level, pk_b)
            self.operators = (
                _load_expansion(cache_path, _mxu.VerifyOperators, meta)
                if cache_path else None
            )
            if self.operators is None:
                self.operators = _mxu.build_verify_operators(self.pk, self.p)
                jax.block_until_ready(self.operators)
                if cache_path:
                    _save_expansion(cache_path, self.operators, meta)
        else:
            meta = _expansion_meta("ExpandedPk", level, pk_b)
            self.expanded = (
                _load_expansion(cache_path, scheme.ExpandedPk, meta)
                if cache_path else None
            )
            if self.expanded is None:
                self.expanded = scheme.expand_pk(self.pk, self.p)
                jax.block_until_ready(self.expanded)
                if cache_path:
                    _save_expansion(cache_path, self.expanded, meta)

    def verify(self, message_sig_pairs: Sequence[Tuple[Bytes, Bytes]]) -> list:
        mus, sigs = _coerce_pairs(self.p, self.tr, message_sig_pairs)
        if self.mode == "mxu":
            ok = self._mxu.verify_mxu(
                self.operators, jnp.asarray(sigs), jnp.asarray(mus), self.p
            )
        else:
            ok = scheme.verify_expanded(
                self.expanded, jnp.asarray(sigs), jnp.asarray(mus), self.p
            )
        return [bool(x) for x in np.asarray(ok)]
