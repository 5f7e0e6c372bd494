"""ctypes binding to the C++ host oracle (cpp/liboracle.so).

The reference keeps a C++ model layer for host-side validation of its
RTL (`dilithium-256/` — NTT only); our oracle covers the full scheme so
every device path can be differentially tested on arbitrary inputs, not
just the shipped KATs. Build: `make -C cpp` (done lazily here).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from functools import lru_cache

import numpy as np

_CPP_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "cpp")
_LIB_PATH = os.path.join(_CPP_DIR, "liboracle.so")

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)


@lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    # Always invoke make (incremental no-op when current): a stale .so
    # from before a C-ABI addition would otherwise fail symbol resolution
    # below for EVERY oracle entry point. If the toolchain is unavailable
    # but a built library exists, fall through and try it. The build is
    # serialized with an flock: `pytest -n 4` workers each call _lib() on
    # first use, and concurrent `make` runs can link over each other's
    # half-written .so. Lock lives outside cpp/ so `make
    # clean` can't remove it mid-hold.
    try:
        import fcntl
        lock_path = os.path.join(_CPP_DIR, os.pardir, ".oracle_build.lock")
        with open(lock_path, "w") as lock_f:
            fcntl.flock(lock_f, fcntl.LOCK_EX)
            try:
                subprocess.run(
                    ["make", "-s", "-C", _CPP_DIR, "liboracle.so"], check=True
                )
            finally:
                fcntl.flock(lock_f, fcntl.LOCK_UN)
    except (OSError, subprocess.CalledProcessError):
        if not os.path.exists(_LIB_PATH):
            raise
    lib = ctypes.CDLL(_LIB_PATH)
    for name in ("oracle_pk_bytes", "oracle_sk_bytes", "oracle_sig_bytes"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = [ctypes.c_int]
    lib.oracle_keygen_batch.argtypes = [ctypes.c_int, ctypes.c_int, _u8p, _u8p, _u8p]
    lib.oracle_sign_batch.argtypes = [ctypes.c_int, ctypes.c_int, _u8p, _u8p, _u8p, _i32p]
    lib.oracle_verify_batch.argtypes = [ctypes.c_int, ctypes.c_int, _u8p, _u8p, _u8p, _i32p]
    lib.oracle_ntt.argtypes = [_i32p]
    lib.oracle_invntt.argtypes = [_i32p]
    lib.oracle_pointwise.argtypes = [_i32p, _i32p, _i32p]
    lib.oracle_shake128.argtypes = [_u8p, ctypes.c_int, _u8p, ctypes.c_int]
    lib.oracle_shake256.argtypes = [_u8p, ctypes.c_int, _u8p, ctypes.c_int]
    lib.oracle_crh_batch.argtypes = [
        ctypes.c_int, _u8p, ctypes.c_int, _u8p,
        ctypes.POINTER(ctypes.c_int64), _u8p, ctypes.c_int,
    ]
    return lib


def _p8(a: np.ndarray):
    return a.ctypes.data_as(_u8p)


def _p32(a: np.ndarray):
    return a.ctypes.data_as(_i32p)


def sizes(level: int):
    lib = _lib()
    return (
        lib.oracle_pk_bytes(level),
        lib.oracle_sk_bytes(level),
        lib.oracle_sig_bytes(level),
    )


def keygen(level: int, seeds: np.ndarray):
    """seeds uint8 [B, 32] -> (pk [B, pk_bytes], sk [B, sk_bytes])."""
    lib = _lib()
    seeds = np.ascontiguousarray(seeds, dtype=np.uint8)
    n = seeds.shape[0]
    pkb, skb, _ = sizes(level)
    pk = np.zeros((n, pkb), dtype=np.uint8)
    sk = np.zeros((n, skb), dtype=np.uint8)
    lib.oracle_keygen_batch(level, n, _p8(seeds), _p8(pk), _p8(sk))
    return pk, sk


def sign(level: int, sk: np.ndarray, mu: np.ndarray):
    """sk [B, sk_bytes], mu [B, 64] -> (sig [B, sig_bytes], attempts [B])."""
    lib = _lib()
    sk = np.ascontiguousarray(sk, dtype=np.uint8)
    mu = np.ascontiguousarray(mu, dtype=np.uint8)
    n = sk.shape[0]
    _, _, sigb = sizes(level)
    sig = np.zeros((n, sigb), dtype=np.uint8)
    att = np.zeros(n, dtype=np.int32)
    lib.oracle_sign_batch(level, n, _p8(sk), _p8(mu), _p8(sig), _p32(att))
    return sig, att


def verify(level: int, pk: np.ndarray, mu: np.ndarray, sig: np.ndarray):
    """-> bool [B]."""
    lib = _lib()
    pk = np.ascontiguousarray(pk, dtype=np.uint8)
    mu = np.ascontiguousarray(mu, dtype=np.uint8)
    sig = np.ascontiguousarray(sig, dtype=np.uint8)
    n = pk.shape[0]
    res = np.zeros(n, dtype=np.int32)
    lib.oracle_verify_batch(level, n, _p8(pk), _p8(mu), _p8(sig), _p32(res))
    return res.astype(bool)


def crh_batch(trs: np.ndarray, messages, nthreads: int = 0) -> np.ndarray:
    """Multithreaded mu = SHAKE256(tr || M, 64) over a ragged batch.

    trs: uint8 [n, 32] (per-message) or [32] (one shared tr). messages:
    sequence of bytes-like, arbitrary lengths. Returns uint8 [n, 64].
    The native thread pool replaces the per-message Python hashlib loop
    on the serving path (api.sign / Signer / MultiSigner), which costs
    ~3 us/message single-threaded — comparable to the device's per-sign
    time at large batches.
    """
    lib = _lib()
    n = len(messages)
    trs = np.ascontiguousarray(trs, dtype=np.uint8)
    if trs.shape[-1] != 32 or trs.ndim not in (1, 2):
        # native code reads exactly 32 bytes per row — reject anything
        # else here rather than read out of bounds
        raise ValueError(f"trs must be [32] or [n, 32] bytes; got {trs.shape}")
    tr_stride = 0 if trs.ndim == 1 else 32
    if tr_stride and trs.shape[0] != n:
        raise ValueError(f"trs rows {trs.shape[0]} != {n} messages")
    # Convert each message to bytes ONCE and derive BOTH lengths and the
    # joined blob from the converted form: for a memoryview/ndarray with
    # itemsize > 1 (legal per the public Bytes type), len(m) counts
    # elements while bytes(m) yields itemsize*len(m) bytes — mixing the
    # two would misalign every subsequent offset.
    bs = [m if type(m) is bytes else bytes(m) for m in messages]
    lens = np.fromiter(map(len, bs), dtype=np.int64, count=n)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    # b"".join packs at C speed — a bytearray slice-assignment loop here
    # costs more than the hashing itself at 16k messages
    blob = b"".join(bs)
    msgs = np.frombuffer(blob, dtype=np.uint8) if blob else np.zeros(1, dtype=np.uint8)
    mus = np.zeros((n, 64), dtype=np.uint8)
    lib.oracle_crh_batch(
        n, _p8(trs), tr_stride, _p8(msgs),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), _p8(mus),
        nthreads,
    )
    return mus


def ntt(a: np.ndarray) -> np.ndarray:
    """Forward NTT of [..., 256] int32 canonical polys (per-poly loop)."""
    lib = _lib()
    out = np.ascontiguousarray(a, dtype=np.int32).copy()
    flat = out.reshape(-1, 256)
    for row in flat:
        lib.oracle_ntt(_p32(row))
    return out


def invntt(a: np.ndarray) -> np.ndarray:
    lib = _lib()
    out = np.ascontiguousarray(a, dtype=np.int32).copy()
    flat = out.reshape(-1, 256)
    for row in flat:
        lib.oracle_invntt(_p32(row))
    return out


def pointwise(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lib = _lib()
    a = np.ascontiguousarray(a, dtype=np.int32)
    b = np.ascontiguousarray(b, dtype=np.int32)
    out = np.zeros_like(a)
    fa, fb, fo = a.reshape(-1, 256), b.reshape(-1, 256), out.reshape(-1, 256)
    for ra, rb, ro in zip(fa, fb, fo):
        lib.oracle_pointwise(_p32(ro), _p32(ra), _p32(rb))
    return out
