"""Smoke test on NVIDIA GPUs: the library's main paths, byte-exact against
the C++ oracle (cpp/, built by `make -C cpp`).

    python chip_smoke.py             # one card: every phase below
    python chip_smoke.py --chips 4   # four cards: the sharded services only

Each phase prints one line with its compile seconds and its run seconds
(the run timed to `block_until_ready`) and compares bytes:

  device   platform, device_kind, count, card name and power limit
  oracle   build and load the C++ oracle
  level N  N = 2, 3, 5: `scheme.keygen`, lockstep `scheme.sign` and
           `scheme.verify` on 256 seeded keys against the oracle's bytes;
           verify also rejects every signature with one byte flipped
  main     level 3, one key: `mxu.build_operators`, `mxu.sign_stream_mxu`
           over 16,384 seeded messages (window 768), every signature
           equal to the oracle's; `mxu.verify_mxu` and `scheme.verify`
           accept them all
  served   `api.Signer` and `api.Verifier` in auto mode (the int8 path on a
           GPU) on ragged messages, and `api.MultiSigner` over 4 keys
  keccak   the main sign with each Keccak implementation in turns, with
           compile seconds and steady signs/s
  xof      one ExpandMask-shaped and one c~-shaped XOF call alone per
           implementation, against hashlib, with microseconds per call

`--chips 4` runs `parallel.sharded_*` on a 4-card mesh at 4x the one-card
batch and compares every output with the same inputs run on device 0, and
the psum counters with the totals.

The last line of stdout is {"ok": true, "device": {...}}. A failed check
raises, so the script exits non-zero without that line; it also exits
non-zero when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

MAIN_LEVEL = 3
MAIN_QUEUE = 16384
MAIN_WINDOW = 768
MAX_ROUNDS = 8192
KEYS = 256


class SmokeFailure(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(line: str) -> None:
    print(line, flush=True)


def card_info() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().replace("\n", "; ")


def compile_timed(fn, *args, **static):
    """(compiled, seconds) for jitted fn at these arguments."""
    t0 = time.perf_counter()
    compiled = fn.lower(*args, **static).compile()
    return compiled, time.perf_counter() - t0


def run_timed(compiled, *args):
    """(output, seconds), the output waited for with block_until_ready."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(compiled(*args))
    return out, time.perf_counter() - t0


def oracle_sign(level: int, sk: np.ndarray, mu: np.ndarray) -> np.ndarray:
    """Oracle signatures, chunks on host threads (ctypes drops the GIL)."""
    from dilithium_tpu import oracle

    sk = np.broadcast_to(sk, (len(mu), sk.shape[-1]))
    chunks = np.array_split(np.arange(len(mu)), min(os.cpu_count() or 1, max(1, len(mu) // 64)))
    with ThreadPoolExecutor(len(chunks)) as ex:
        parts = list(ex.map(lambda i: oracle.sign(level, sk[i], mu[i])[0], chunks))
    return np.concatenate(parts)


def flip_one_byte(sig: np.ndarray) -> np.ndarray:
    """Each row with one byte flipped, at a position that walks the row."""
    bad = sig.copy()
    rows = np.arange(len(bad))
    bad[rows, (rows * 131) % bad.shape[1]] ^= 0x01
    return bad


# ---------------------------------------------------------------------------
# one card
# ---------------------------------------------------------------------------


def phase_oracle() -> None:
    from dilithium_tpu import oracle

    t0 = time.perf_counter()
    sizes = oracle.sizes(MAIN_LEVEL)
    say(f"phase oracle: build+load {time.perf_counter() - t0:.2f} s, "
        f"level-3 pk/sk/sig bytes {sizes}")


def phase_level(level: int):
    """keygen / lockstep sign / verify of KEYS seeded keys; returns (pk, sk)."""
    import jax.numpy as jnp
    from dilithium_tpu import oracle, params, scheme

    p = params.get_params(level)
    rng = np.random.default_rng(level)
    seeds = rng.integers(0, 256, size=(KEYS, 32), dtype=np.uint8)
    mu = rng.integers(0, 256, size=(KEYS, 64), dtype=np.uint8)
    pk_ref, sk_ref = oracle.keygen(level, seeds)

    kg, kg_c = compile_timed(scheme.keygen, jnp.asarray(seeds), p=p)
    kp, kg_r = run_timed(kg, jnp.asarray(seeds))
    check(np.asarray(kp.ok).all(), f"level {level}: keygen budget flag")
    check(np.array_equal(np.asarray(kp.pk), pk_ref), f"level {level}: pk != oracle")
    check(np.array_equal(np.asarray(kp.sk), sk_ref), f"level {level}: sk != oracle")

    sg, sg_c = compile_timed(scheme.sign, kp.sk, jnp.asarray(mu), p=p)
    res, sg_r = run_timed(sg, kp.sk, jnp.asarray(mu))
    sig = np.asarray(res.sig)
    check(np.asarray(res.ok).all(), f"level {level}: lockstep sign did not converge")
    check(np.array_equal(sig, oracle_sign(level, sk_ref, mu)),
          f"level {level}: signatures != oracle")

    vy, vy_c = compile_timed(scheme.verify, kp.pk, jnp.asarray(sig), jnp.asarray(mu), p=p)
    ok, vy_r = run_timed(vy, kp.pk, jnp.asarray(sig), jnp.asarray(mu))
    check(np.asarray(ok).all(), f"level {level}: verify rejected a valid signature")
    bad = flip_one_byte(sig)
    ok_bad, _ = run_timed(vy, kp.pk, jnp.asarray(bad), jnp.asarray(mu))
    check(not np.asarray(ok_bad).any(), f"level {level}: verify accepted a flipped byte")
    check(not oracle.verify(level, pk_ref, mu, bad).any(),
          f"level {level}: oracle accepted a flipped byte")

    say(f"phase level {level}: {KEYS} keys, bytes == oracle; "
        f"keygen compile {kg_c:.2f} s run {kg_r:.3f} s; "
        f"sign compile {sg_c:.2f} s run {sg_r:.3f} s; "
        f"verify compile {vy_c:.2f} s run {vy_r:.3f} s; {KEYS}/{KEYS} flipped rejected")
    return pk_ref, sk_ref


def phase_main(pk: np.ndarray, sk: np.ndarray, device):
    """Level-3 one-key int8 path; returns (ops, mu, reference signatures)."""
    import jax.numpy as jnp
    from dilithium_tpu import mxu, params, scheme

    p = params.get_params(MAIN_LEVEL)
    rng = np.random.default_rng(16384)
    mu_h = rng.integers(0, 256, size=(MAIN_QUEUE, 64), dtype=np.uint8)
    mu = jnp.asarray(mu_h)

    bo, bo_c = compile_timed(mxu.build_operators, jnp.asarray(sk), p=p)
    ops, bo_r = run_timed(bo, jnp.asarray(sk))
    t0 = time.perf_counter()
    ref = oracle_sign(MAIN_LEVEL, sk, mu_h)
    oracle_s = time.perf_counter() - t0

    static = dict(p=p, window=MAIN_WINDOW, max_rounds=MAX_ROUNDS)
    signer, sg_c = compile_timed(mxu.sign_stream_mxu, ops, mu, **static)
    res, first = run_timed(signer, ops, mu)
    check(np.asarray(res.ok).all(), "main: queue not signed")
    check(np.array_equal(np.asarray(res.sig), ref), "main: signatures != oracle")
    steady = [run_timed(signer, ops, mu)[1] for _ in range(3)]
    sig = res.sig

    vo, vo_c = compile_timed(mxu.build_verify_operators, jnp.asarray(pk), p=p)
    vops, vo_r = run_timed(vo, jnp.asarray(pk))
    vm, vm_c = compile_timed(mxu.verify_mxu, vops, sig, mu, p=p)
    ok, vm_r = run_timed(vm, vops, sig, mu)
    check(np.asarray(ok).all(), "main: verify_mxu rejected a valid signature")
    pk_rows = jnp.broadcast_to(jnp.asarray(pk), (MAIN_QUEUE, pk.shape[-1]))
    vs, vs_c = compile_timed(scheme.verify, pk_rows, sig, mu, p=p)
    ok, vs_r = run_timed(vs, pk_rows, sig, mu)
    check(np.asarray(ok).all(), "main: scheme.verify rejected a valid signature")

    mem = signer.memory_analysis()
    peak = (device.memory_stats() or {}).get("peak_bytes_in_use")
    med = statistics.median(steady)
    parts = [f"phase main: level {MAIN_LEVEL}, one key, {MAIN_QUEUE} messages, "
             f"window {MAIN_WINDOW}; {MAIN_QUEUE}/{MAIN_QUEUE} signatures == oracle "
             f"(oracle {oracle_s:.1f} s on host); "
             f"build_operators compile {bo_c:.2f} s run {bo_r:.3f} s",
             f"sign_stream_mxu: compile {sg_c:.2f} s, first run {first:.3f} s, "
             f"steady {med:.4f} s = {MAIN_QUEUE / med:.1f} signs/s "
             f"(runs {', '.join(f'{t:.4f}' for t in steady)})",
             f"verify_mxu: build compile {vo_c:.2f} s run {vo_r:.3f} s, verify "
             f"compile {vm_c:.2f} s run {vm_r:.4f} s; scheme.verify compile "
             f"{vs_c:.2f} s run {vs_r:.4f} s; all {MAIN_QUEUE} accepted by both",
             f"sign step memory: argument {mem.argument_size_in_bytes} B, "
             f"output {mem.output_size_in_bytes} B, temp {mem.temp_size_in_bytes} B, "
             f"code {mem.generated_code_size_in_bytes} B; "
             f"peak_bytes_in_use {peak}"]
    say("; ".join(parts))
    return ops, mu, ref, signer


def phase_served(pks: np.ndarray, sks: np.ndarray) -> None:
    from dilithium_tpu import api, oracle
    from dilithium_tpu.params import SEEDBYTES, TRBYTES

    rng = np.random.default_rng(5)
    msgs = [rng.bytes(n) for n in (0, 1, 33, 200, 1000, 4097)]
    sk, pk = sks[0], pks[0]
    tr = bytes(sk[2 * SEEDBYTES: 2 * SEEDBYTES + TRBYTES])
    mus = np.stack([np.frombuffer(api.compute_mu(tr, m), dtype=np.uint8) for m in msgs])
    ref = oracle_sign(MAIN_LEVEL, sk, mus)

    t0 = time.perf_counter()
    signer = api.Signer(MAIN_LEVEL, bytes(sk))
    check(signer.mode == "mxu", f"Signer auto mode resolved to {signer.mode!r}")
    sigs = signer.sign(msgs)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    sigs2 = signer.sign(msgs)
    again = time.perf_counter() - t0
    check(np.array_equal(np.frombuffer(b"".join(sigs), np.uint8).reshape(ref.shape), ref),
          "Signer signatures != oracle")
    check(sigs2 == sigs, "Signer is not deterministic")

    t0 = time.perf_counter()
    verifier = api.Verifier(MAIN_LEVEL, bytes(pk))
    check(verifier.mode == "mxu", f"Verifier auto mode resolved to {verifier.mode!r}")
    oks = verifier.verify(list(zip(msgs, sigs)))
    v_first = time.perf_counter() - t0
    check(all(oks), "Verifier rejected a valid signature")
    bad = flip_one_byte(ref)
    check(not any(verifier.verify([(m, bytes(b)) for m, b in zip(msgs, bad)])),
          "Verifier accepted a flipped byte")

    nk = 4
    pairs = [(i % nk, rng.bytes(int(n))) for i, n in enumerate(rng.integers(0, 300, 14))]
    t0 = time.perf_counter()
    multi = api.MultiSigner(MAIN_LEVEL, [bytes(s) for s in sks[:nk]])
    msigs = multi.sign(pairs)
    m_first = time.perf_counter() - t0
    idx = np.array([k for k, _ in pairs])
    mmus = np.stack([
        np.frombuffer(api.compute_mu(bytes(sks[k][2 * SEEDBYTES: 2 * SEEDBYTES + TRBYTES]), m),
                      dtype=np.uint8)
        for k, m in pairs
    ])
    mref, _ = oracle.sign(MAIN_LEVEL, sks[idx], mmus)
    check(np.array_equal(np.frombuffer(b"".join(msigs), np.uint8).reshape(mref.shape), mref),
          "MultiSigner signatures != oracle")
    say(f"phase served: Signer mode {signer.mode}, {len(msgs)} ragged messages == oracle, "
        f"first call (compile+run) {first:.2f} s, again {again:.3f} s; Verifier mode "
        f"{verifier.mode}, first call {v_first:.2f} s, all accepted, flipped all rejected; "
        f"MultiSigner {nk} keys x {len(pairs)} messages == oracle, first call {m_first:.2f} s")


def phase_keccak(ops, mu, ref, default_signer, card: str) -> None:
    """The main sign with each Keccak implementation, in turns."""
    from dilithium_tpu import mxu, params
    from dilithium_tpu.ops import keccak

    p = params.get_params(MAIN_LEVEL)
    static = dict(p=p, window=MAIN_WINDOW, max_rounds=MAX_ROUNDS)
    names = [keccak.impl()] + [n for n in keccak.IMPLS if n != keccak.impl()]
    compiled, compile_s, runs = {names[0]: default_signer}, {names[0]: None}, {}
    for name in names[1:]:
        with keccak.use_impl(name):
            compiled[name], compile_s[name] = compile_timed(
                mxu.sign_stream_mxu, ops, mu, **static)
    for name in names:  # warm each once and check its bytes
        res, _ = run_timed(compiled[name], ops, mu)
        check(np.array_equal(np.asarray(res.sig), ref), f"keccak {name}: signatures != oracle")
        runs[name] = []
    for _ in range(3):
        for name in names:
            runs[name].append(run_timed(compiled[name], ops, mu)[1])
    for name in names:
        med = statistics.median(runs[name])
        c = "see main" if compile_s[name] is None else f"{compile_s[name]:.2f} s"
        say(f"phase keccak impl={name}: compile {c}, steady {med:.4f} s = "
            f"{MAIN_QUEUE / med:.1f} signs/s (runs {', '.join(f'{t:.4f}' for t in runs[name])}), "
            f"bytes == oracle; card {card}")
    for shape in XOF_SHAPES:
        phase_xof(*shape, names, card)


# (name, states, message bytes, output words, rate): the ExpandMask and
# c~ calls of one level-3 sign round at window 768
XOF_SHAPES = (("ExpandMask", 5 * MAIN_WINDOW, 66, 160, 136),
              ("c_tilde", MAIN_WINDOW, 832, 8, 136))
XOF_CALLS = 20


def phase_xof(what, states, msg_len, out_words, rate, names, card: str) -> None:
    """One XOF call alone per Keccak implementation, against hashlib."""
    import hashlib
    import jax
    import jax.numpy as jnp
    from dilithium_tpu.ops import keccak

    msgs = np.random.default_rng(states).integers(0, 256, size=(states, msg_len), dtype=np.uint8)
    m = jnp.asarray(msgs)
    h = hashlib.shake_128 if rate == 168 else hashlib.shake_256
    exp = [np.frombuffer(h(msgs[i].tobytes()).digest(4 * out_words), np.uint32)
           for i in (0, states - 1)]
    parts = []
    for name in names:
        with keccak.use_impl(name):
            fn, c = compile_timed(jax.jit(
                lambda x: keccak.shake_words(x, out_words, rate)), m)
        out, _ = run_timed(fn, m)
        check(all(np.array_equal(np.asarray(out[i]), e) for i, e in zip((0, -1), exp)),
              f"xof {what} impl={name}: words != hashlib")
        blocks = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(XOF_CALLS):
                out = fn(m)
            jax.block_until_ready(out)
            blocks.append((time.perf_counter() - t0) / XOF_CALLS)
        parts.append(f"impl={name} compile {c:.2f} s, {statistics.median(blocks) * 1e6:.1f} us "
                     f"per call (blocks {', '.join(f'{t * 1e6:.1f}' for t in blocks)})")
    say(f"phase xof {what} ({states} states x {msg_len} B -> {out_words} words): "
        + "; ".join(parts) + f"; == hashlib; card {card}")


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def phase_multichip(devices) -> None:
    """Every sharded service at 4x the one-card batch vs device 0.

    All inputs come from the host (seeds, oracle keys and signatures), so
    the six sharded calls and their six device-0 references are
    independent and run on threads at once: their compiles overlap. Each
    reference runs one shard's worth at a time, at the one-card shapes,
    so where the compilation cache holds the one-card programs it hits.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from dilithium_tpu import mxu, oracle, params, scheme
    from dilithium_tpu.parallel import (
        make_mesh, sharded_keygen, sharded_sign, sharded_sign_stream,
        sharded_sign_stream_keys, sharded_verify, sharded_verify_stream,
    )

    n = len(devices)
    mesh = make_mesh(devices)
    p = params.get_params(MAIN_LEVEL)
    rng = np.random.default_rng(4)
    B, Q, nk = n * KEYS, n * MAIN_QUEUE, 4

    def shard(x):
        x = np.asarray(x)
        return jax.device_put(x, NamedSharding(mesh, P("batch", *([None] * (x.ndim - 1)))))

    def on0(x):
        return jax.device_put(x, devices[0])

    def replicate(tree):
        return jax.device_put(tree, NamedSharding(mesh, P()))

    def per_shard(fn, *arrays):
        """fn over each shard-sized slice on device 0, concatenated."""
        parts = [np.array_split(a, n) for a in arrays]
        outs = [jax.device_get(fn(*[on0(part[i]) for part in parts])) for i in range(n)]
        return jax.tree.map(lambda *xs: np.concatenate(xs), *outs)

    t0 = time.perf_counter()
    seeds = rng.integers(0, 256, size=(B, 32), dtype=np.uint8)
    mu = rng.integers(0, 256, size=(B, 64), dtype=np.uint8)
    pk, sk = oracle.keygen(MAIN_LEVEL, seeds)
    sig = oracle_sign(MAIN_LEVEL, sk, mu)
    mu_q = rng.integers(0, 256, size=(Q, 64), dtype=np.uint8)
    sig_q = oracle_sign(MAIN_LEVEL, sk[0], mu_q)
    key_idx = rng.integers(0, nk, size=(Q,)).astype(np.int32)
    host_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    ex = ThreadPoolExecutor(16)
    builds = [  # key material on device 0, built beside the first calls
        ex.submit(lambda: mxu.build_operators(on0(sk[0]), p)),
        ex.submit(lambda: mxu.build_verify_operators(on0(pk[0]), p)),
        ex.submit(lambda: scheme.expand_sk(on0(sk[:nk]), p)),
    ]

    def ops():
        return builds[0].result()

    def vops():
        return builds[1].result()

    def eks():
        return builds[2].result()

    W = MAIN_WINDOW
    calls = {  # name: (sharded call, device-0 reference)
        "keygen": (lambda: sharded_keygen(mesh, p)(shard(seeds)),
                   lambda: per_shard(lambda s_: scheme.keygen(s_, p), seeds)),
        "sign": (lambda: sharded_sign(mesh, p)(shard(sk), shard(mu)),
                 lambda: per_shard(lambda k, m: scheme.sign(k, m, p), sk, mu)),
        "verify": (lambda: sharded_verify(mesh, p)(shard(pk), shard(sig), shard(mu)),
                   lambda: per_shard(lambda k, s_, m: scheme.verify(k, s_, m, p), pk, sig, mu)),
        "sign_stream": (
            lambda: sharded_sign_stream(mesh, p, window=W)(replicate(ops()), shard(mu_q)),
            lambda: per_shard(lambda m: mxu.sign_stream_mxu(
                ops(), m, p, window=W, max_rounds=MAX_ROUNDS), mu_q)),
        "verify_stream": (
            lambda: sharded_verify_stream(mesh, p)(replicate(vops()), shard(sig_q), shard(mu_q)),
            lambda: per_shard(lambda s_, m: mxu.verify_mxu(vops(), s_, m, p), sig_q, mu_q)),
        "sign_stream_keys": (
            lambda: sharded_sign_stream_keys(mesh, p, window=W)(
                replicate(eks()), shard(key_idx), shard(mu_q)),
            lambda: per_shard(lambda k, m: scheme.sign_stream_keys(
                eks(), k, m, p, window=W), key_idx, mu_q)),
    }
    with ex:
        futs = {(name, i): ex.submit(lambda f=f: jax.device_get(f()))
                for name, pair in calls.items() for i, f in enumerate(pair)}
        out = {key: f.result() for key, f in futs.items()}
    dev_s = time.perf_counter() - t0

    def same(name, got, ref, what):
        check(np.array_equal(np.asarray(got), np.asarray(ref)),
              f"sharded {name} {what} != device 0")

    (pk_s, sk_s, ok_s), kp0 = out["keygen", 0], out["keygen", 1]
    same("keygen", pk_s, kp0.pk, "pk")
    same("keygen", sk_s, kp0.sk, "sk")
    check(np.array_equal(pk_s, pk) and np.array_equal(sk_s, sk) and ok_s.all(),
          "sharded keygen != oracle")
    for name, n_total in (("sign", B), ("sign_stream", Q), ("sign_stream_keys", Q)):
        got, ref = out[name, 0], out[name, 1]
        same(name, got.sig, ref.sig, "signatures")
        check(ref.ok.all() and int(got.total_signed) == n_total,
              f"sharded {name}: psum total_signed {int(got.total_signed)} != {n_total}")
        check(int(got.total_attempts) == int(ref.attempts.sum()),
              f"sharded {name}: psum total_attempts != sum over device 0")
    check(np.array_equal(out["sign", 0].sig, sig), "sharded sign != oracle")
    check(np.array_equal(out["sign_stream", 0].sig, sig_q), "sharded sign_stream != oracle")
    for name, n_total in (("verify", B), ("verify_stream", Q)):
        (ok, total), ref = out[name, 0], out[name, 1]
        same(name, ok, ref, "accept flags")
        check(ok.all() and int(total) == n_total,
              f"sharded {name}: psum total {int(total)} != {n_total}")
    say(f"phase multichip: {n} devices, level {MAIN_LEVEL}; keygen/sign/verify at {B}, "
        f"sign_stream/verify_stream/sign_stream_keys at {Q} ({nk} keys); every output == "
        f"device 0 (and keygen/sign/sign_stream == oracle), psum counters == totals; "
        f"host inputs {host_s:.1f} s, device calls with compiles {dev_s:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded services on a 4-card mesh")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {dev.platform!r}", file=sys.stderr)
        return 1
    if len(devices) < args.chips:
        print(f"chip_smoke: --chips {args.chips} needs {args.chips} GPUs; "
              f"JAX found {len(devices)}", file=sys.stderr)
        return 1

    from dilithium_tpu.ops import keccak
    from dilithium_tpu.utils import compile_cache

    cache = compile_cache.enable()
    card = card_info()
    say(f"phase device: platform {dev.platform}, kind {dev.device_kind}, count "
        f"{len(devices)}, jax {jax.__version__}, keccak {keccak.impl()}, "
        f"compile cache {cache}")
    say(f"card: {card}")

    if args.chips == 4:
        phase_multichip(devices[:4])
    else:
        phase_oracle()
        keys = {level: phase_level(level) for level in (2, 3, 5)}
        pks, sks = keys[MAIN_LEVEL]
        ops, mu, ref, signer = phase_main(pks[0], sks[0], dev)
        phase_served(pks, sks)
        phase_keccak(ops, mu, ref, signer, card)

    say(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(devices),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
