"""Headline benchmark: batched Dilithium signs/sec on one NVIDIA GPU.

Prints ONE JSON line on stdout:
  {"metric": "dilithium3_sign_throughput", "value": N, "unit": "signs/sec",
   "vs_baseline": R, "blocks": [...], "device": {...}}

Baseline (BASELINE.md): the reference FPGA publishes no numbers in-repo;
the structurally derived estimate is ~10^4 cycles/sign at the 100 MHz
testbench clock -> ~1e4 signs/sec/chip serial, up to ~1e5 at the paper's
higher clocks. We take BASELINE = 2.0e4 signs/sec (a reference-favorable
~10^4 cycles at 200 MHz) so vs_baseline = value / 2e4.

Needs a GPU: without one it exits non-zero and prints no result. The
device (platform, device_kind, count) and the card's name and power
limit go into the result; other diagnostics go to stderr.

Modes (DILITHIUM_BENCH_MODE): "mxu" (default; one key, dense int8
operators + elastic attempt scheduler), "stream" (one key, NTT pipeline),
"keys" (independent-keys elastic signer over DILITHIUM_BENCH_NKEYS keys),
"batch" (lockstep signer), "verify" (one-key int8 verify service),
"serve" (bytes -> mu on the host -> int8 signer).
Timed: DILITHIUM_BENCH_ITERS iterations in 3 blocks, median block
reported, every block waited for with block_until_ready.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

BASELINE_SIGNS_PER_SEC = 2.0e4


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def device_info() -> dict:
    """The GPU this run measures; exits non-zero if JAX finds none."""
    import jax

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        log(f"bench: needs a GPU; JAX found {dev.platform!r}")
        sys.exit(1)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(devices), "card": card}


def main():
    import jax
    import jax.numpy as jnp

    from dilithium_tpu import params, scheme
    from dilithium_tpu.utils import compile_cache

    device = device_info()
    compile_cache.enable()
    log(f"device: {device}")
    level = int(os.environ.get("DILITHIUM_BENCH_LEVEL", "3"))
    p = params.get_params(level)

    batch = int(os.environ.get("DILITHIUM_BENCH_BATCH", "16384"))
    iters = int(os.environ.get("DILITHIUM_BENCH_ITERS", "21"))
    mode = os.environ.get("DILITHIUM_BENCH_MODE", "mxu")
    # per-level windows carried over from the previous accelerator's
    # sweeps; not yet re-swept on the GPU
    window = int(os.environ.get(
        "DILITHIUM_BENCH_WINDOW", {2: "1536", 3: "768", 5: "768"}[level]
    ))

    rng = np.random.default_rng(0)
    if mode == "verify":
        # one-key verify service: dense MXU operators, batch of signatures
        from dilithium_tpu import mxu as mxu_mod
        seed = jnp.asarray(rng.integers(0, 256, size=(32,), dtype=np.uint8))
        t0 = time.time()
        kp = scheme.keygen(seed, p)
        ops_ = mxu_mod.build_operators(kp.sk, p)
        vops = mxu_mod.build_verify_operators(kp.pk, p)
        jax.block_until_ready(vops.wz_limbs)
        log(f"keygen+build ops compile+run: {time.time() - t0:.1f}s")
        mu_s = jnp.asarray(rng.integers(0, 256, size=(batch, 64), dtype=np.uint8))
        t0 = time.time()
        res0 = mxu_mod.sign_stream_mxu(ops_, mu_s, p, window=window, max_rounds=8192)
        jax.block_until_ready(res0.sig)
        log(f"sign({batch}) for verify corpus: {time.time() - t0:.1f}s")
        sig0 = res0.sig

        def run(mu):
            # the verified corpus (sig0, mu_s) is fixed and all-accept;
            # jit does not memoize executions, so identical inputs re-run
            # the full computation each call (`mu` is unused — the timed
            # loop passes a fixed device array to avoid charging host RNG
            # + transfer of inputs this mode never reads)
            ok = mxu_mod.verify_mxu(vops, sig0, mu_s, p)
            return ok, ok, ok
    elif mode == "mxu":
        # one key, dense MXU operators (composite y->w matrix + conv mats)
        from dilithium_tpu import mxu as mxu_mod
        seed = jnp.asarray(rng.integers(0, 256, size=(32,), dtype=np.uint8))
        t0 = time.time()
        kp = scheme.keygen(seed, p)
        ops_ = mxu_mod.build_operators(kp.sk, p)
        jax.block_until_ready(ops_.wy_cat)
        log(f"keygen+build_operators compile+run: {time.time() - t0:.1f}s")

        def run(mu):
            res = mxu_mod.sign_stream_mxu(ops_, mu, p, window=window,
                                          max_rounds=8192)
            return res.sig, res.ok, res.attempts
    elif mode == "serve":
        # end-to-end serving: raw message bytes -> mu (native thread pool)
        # -> MXU stream signer; measures the full host+device pipeline
        from dilithium_tpu import api, mxu as mxu_mod
        msg_len = int(os.environ.get("DILITHIUM_BENCH_MSGLEN", "200"))
        seed = jnp.asarray(rng.integers(0, 256, size=(32,), dtype=np.uint8))
        t0 = time.time()
        kp = scheme.keygen(seed, p)
        ops_ = mxu_mod.build_operators(kp.sk, p)
        jax.block_until_ready(ops_.wy_cat)
        tr_host = bytes(np.asarray(kp.tr))
        log(f"keygen+build_operators compile+run: {time.time() - t0:.1f}s")
        # fixed message corpus (like verify mode): the timed loop measures
        # mu hashing + signing, not host RNG; jit does not memoize, so the
        # full pipeline re-runs every iteration
        msgs_fixed = rng.integers(
            0, 256, size=(batch, msg_len), dtype=np.uint8
        )
        msgs_list = [m.tobytes() for m in msgs_fixed]

        def run(mu_ignored):
            mus = jnp.asarray(api.compute_mu_many(tr_host, msgs_list))
            res = mxu_mod.sign_stream_mxu(ops_, mus, p, window=window,
                                          max_rounds=8192)
            return res.sig, res.ok, res.attempts
    elif mode == "keys":
        # independent-keys elastic signer: N distinct keys x `batch`
        # messages, per-slot key-material gather (scheme.sign_stream_keys)
        nkeys = int(os.environ.get("DILITHIUM_BENCH_NKEYS", "256"))
        seeds = jnp.asarray(rng.integers(0, 256, size=(nkeys, 32), dtype=np.uint8))
        t0 = time.time()
        kp = scheme.keygen(seeds, p)
        eks = scheme.expand_sk(kp.sk, p)
        jax.block_until_ready(eks.a_hat)
        log(f"keygen+expand({nkeys} keys) compile+run: {time.time() - t0:.1f}s")
        key_idx = jnp.asarray(rng.integers(0, nkeys, size=(batch,)).astype(np.int32))
        # A/B lever for the key-gather tax: sort the queue by key so
        # steady-state gather indices coalesce
        sort_keys = os.environ.get("DILITHIUM_BENCH_KEYS_SORT", "0") == "1"

        def run(mu):
            res = scheme.sign_stream_keys(
                eks, key_idx, mu, p, window=window, max_rounds=8192,
                sort_by_key=sort_keys,
            )
            return res.sig, res.ok, res.attempts
    elif mode == "stream":
        # one key signing a queue of `batch` messages (service workload):
        # refill window keeps every lane busy — no lockstep waste
        seed = jnp.asarray(rng.integers(0, 256, size=(32,), dtype=np.uint8))
        t0 = time.time()
        kp = scheme.keygen(seed, p)
        ek = scheme.expand_sk(kp.sk, p)
        jax.block_until_ready(ek.a_hat)
        log(f"keygen+expand compile+run: {time.time() - t0:.1f}s")

        def run(mu):
            res = scheme.sign_stream(ek, mu, p, window=window, max_rounds=8192)
            return res.sig, res.ok, res.attempts
    else:
        seed = jnp.asarray(rng.integers(0, 256, size=(batch, 32), dtype=np.uint8))
        t0 = time.time()
        kp = scheme.keygen(seed, p)
        jax.block_until_ready(kp.sk)
        log(f"keygen({batch}) compile+run: {time.time() - t0:.1f}s")

        def run(mu):
            res = scheme.sign(kp.sk, mu, p, attempts_per_round=4, max_rounds=96)
            return res.sig, res.ok, res.attempts

    mu0 = jnp.asarray(rng.integers(0, 256, size=(batch, 64), dtype=np.uint8))
    t0 = time.time()
    sig, ok, att = run(mu0)
    jax.block_until_ready(sig)
    log(f"sign({batch}) compile+first run: {time.time() - t0:.1f}s, "
        f"ok={int(np.asarray(ok).sum())}/{batch}, "
        f"mean_attempts={float(np.asarray(att).mean()):.2f}")

    # optional profiler trace of one steady-state run (view with
    # tensorboard / xprof; SURVEY.md §5 tracing obligation)
    profile_dir = os.environ.get("DILITHIUM_BENCH_PROFILE")
    if profile_dir:
        mu_p = jnp.asarray(rng.integers(0, 256, size=(batch, 64), dtype=np.uint8))
        with jax.profiler.trace(profile_dir):
            sig, ok, att = run(mu_p)
            jax.block_until_ready(sig)
        log(f"profiler trace written to {profile_dir}")

    # timed: fresh mu each iteration, 3 blocks, median block reported
    blocks = 3
    per_block = max(1, -(-iters // blocks))
    # verify/serve time a fixed corpus; their run() ignores mu, so fresh
    # host RNG + transfer each iteration would only deflate the rate
    fresh_input = mode not in ("verify", "serve")
    sig, ok, att = run(mu0)  # one untimed steady run after the compile run
    jax.block_until_ready(sig)

    def timed_block():
        if fresh_input:
            mus = [
                jnp.asarray(rng.integers(0, 256, size=(batch, 64), dtype=np.uint8))
                for _ in range(per_block)
            ]
        else:
            mus = [mu0] * per_block
        t0 = time.perf_counter()
        for mu in mus:
            s, _, _ = run(mu)
        jax.block_until_ready(s)
        elapsed = time.perf_counter() - t0
        r = batch * per_block / elapsed
        log(f"block: {per_block} iters x {batch} in {elapsed:.3f}s ({r:.1f}/sec)")
        return r

    rates = [timed_block() for _ in range(blocks)]
    value = statistics.median(rates)

    op = "verify" if mode == "verify" else "sign"
    print(json.dumps({
        "metric": f"dilithium{level}_{op}_throughput",
        "value": value,
        "unit": f"{op}s/sec" if op == "sign" else "verifies/sec",
        "vs_baseline": value / BASELINE_SIGNS_PER_SEC,
        "blocks": rates,
        "device": device,
    }))


if __name__ == "__main__":
    main()
