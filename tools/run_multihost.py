"""Multi-host data-parallel signing launcher.

The missing execution entry for SURVEY.md §2.7's distributed-backend row
("DCN for multi-host dispatch; per-host input sharding via
`jax.make_array_from_process_local_data`"): every participating host runs
this script; `jax.distributed.initialize` wires the JAX distributed
runtime (NCCL/gloo collectives), the 1-D
batch mesh spans ALL devices of ALL processes, each host feeds only its
local shard of the message queue, and the global psum counters come back
identical on every host.

Usage — one invocation per host, each told the coordinator, the process
count and its own id:

  python tools/run_multihost.py \
      --coordinator=host0:8476 --num-processes=4 --process-id=$i \
      [--level 3] [--global-batch 16384] [--window 768]
      [--signer mxu|stream|lockstep] [--out shard_sigs.npy]

CPU smoke test (what tests/test_multihost.py spawns): set
JAX_PLATFORMS=cpu and XLA_FLAGS=--xla_force_host_platform_device_count=N
per process; collectives ride gloo over localhost.

Prints one JSON line on stdout per host:
  {"process_id": i, "signed": <global psum>, "attempts": <global psum>,
   "local_batch": n, "elapsed_s": t, "signs_per_sec": r}
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--coordinator", default=None,
                    help="coordinator address host:port")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--level", type=int, default=3, choices=(2, 3, 5))
    ap.add_argument("--global-batch", type=int, default=16384,
                    help="total message queue size across all hosts")
    ap.add_argument("--window", type=int, default=768)
    ap.add_argument("--max-rounds", type=int, default=8192)
    ap.add_argument("--signer", default="mxu",
                    choices=("mxu", "stream", "lockstep", "keys"),
                    help="mxu: dense-operator elastic signer; stream: "
                         "generic-NTT elastic signer; lockstep: scheme.sign; "
                         "keys: independent-keys elastic signer "
                         "(sharded_sign_stream_keys, --nkeys distinct keys)")
    ap.add_argument("--nkeys", type=int, default=4,
                    help="distinct keys for --signer=keys")
    ap.add_argument("--verify", action="store_true",
                    help="after signing, run the sharded one-key verify "
                         "service (sharded_verify_stream) on the produced "
                         "signatures and report the global verified count "
                         "(only meaningful for one-key signers)")
    ap.add_argument("--seed", type=int, default=0,
                    help="deterministic key + message seed (same on all hosts)")
    ap.add_argument("--out", default=None,
                    help="write this host's local signature shard (npy)")
    args = ap.parse_args(argv)

    import jax

    # Wire the distributed runtime BEFORE any backend touch; on CPU/GPU
    # all three args must be passed.
    init_kwargs = {}
    if args.coordinator is not None:
        init_kwargs["coordinator_address"] = args.coordinator
    if args.num_processes is not None:
        init_kwargs["num_processes"] = args.num_processes
    if args.process_id is not None:
        init_kwargs["process_id"] = args.process_id
    jax.distributed.initialize(**init_kwargs)

    import numpy as np
    import jax.numpy as jnp

    from dilithium_tpu import params, scheme
    from dilithium_tpu.parallel import (
        make_mesh, local_batch_to_global, sharded_sign, sharded_sign_stream,
        sharded_sign_stream_keys, sharded_verify_stream, throughput_counters,
    )

    pid = jax.process_index()
    nproc = jax.process_count()
    p = params.get_params(args.level)
    mesh = make_mesh()  # spans ALL devices of ALL processes
    ndev = jax.device_count()

    def log(*a):
        print(f"[host {pid}/{nproc}]", *a, file=sys.stderr, flush=True)

    log(f"devices: {ndev} global / {jax.local_device_count()} local; "
        f"mesh {mesh.shape}")

    # Keys derived from --seed on every host identically: one key for the
    # one-key signers (replicated expansion), --nkeys for the
    # independent-keys service (batched ExpandedKey replicated, key_idx
    # sharded with the queue).
    rng = np.random.default_rng(args.seed)
    n_keys = args.nkeys if args.signer == "keys" else 1
    seed = jnp.asarray(rng.integers(0, 256, size=(n_keys, 32), dtype=np.uint8))
    kp = scheme.keygen(seed[0] if n_keys == 1 else seed, p)

    # The GLOBAL message queue is derived from the same rng on every host;
    # each host materializes only its contiguous shard. batch must divide
    # evenly across devices (pad the tail in a real service).
    B = args.global_batch - args.global_batch % ndev
    mu_global = rng.integers(0, 256, size=(B, 64), dtype=np.uint8)
    per = B // nproc
    mu_local = mu_global[pid * per: (pid + 1) * per]
    mu = local_batch_to_global(mesh, mu_local)

    t0 = time.time()
    if args.signer == "lockstep":
        fn = sharded_sign(mesh, p, replicate_key=True)
        res = fn(kp.sk, mu)
    elif args.signer == "keys":
        # global key_idx derived from the shared rng; shard like mu
        key_idx_global = rng.integers(0, n_keys, size=(B,)).astype(np.int32)
        key_idx = local_batch_to_global(
            mesh, key_idx_global[pid * per: (pid + 1) * per]
        )
        eks = scheme.expand_sk(kp.sk, p)
        fn = sharded_sign_stream_keys(mesh, p, window=args.window,
                                      max_rounds=args.max_rounds)
        res = fn(eks, key_idx, mu)
    else:
        use_mxu = args.signer == "mxu"
        if use_mxu:
            from dilithium_tpu import mxu
            km = mxu.build_operators(kp.sk, p)
        else:
            km = scheme.expand_sk(kp.sk, p)
        fn = sharded_sign_stream(mesh, p, window=args.window,
                                 max_rounds=args.max_rounds, use_mxu=use_mxu)
        res = fn(km, mu)
    counters = throughput_counters(res)
    elapsed = time.time() - t0
    log(f"signed {counters['signed']}/{B} globally, "
        f"mean attempts {counters['mean_attempts']:.2f}, "
        f"{elapsed:.1f}s (incl. compile)")

    verified = None
    if args.verify:
        if args.signer == "keys":
            # per-row pk matching the sharded key_idx
            from dilithium_tpu.parallel import sharded_verify
            pk_rows = local_batch_to_global(
                mesh,
                np.asarray(kp.pk)[key_idx_global[pid * per: (pid + 1) * per]],
            )
            _, total_v = sharded_verify(mesh, p)(pk_rows, res.sig, mu)
        else:
            # one-key verify service: dense MXU operators replicated
            from dilithium_tpu import mxu
            vops = mxu.build_verify_operators(kp.pk, p)
            _, total_v = sharded_verify_stream(mesh, p)(vops, res.sig, mu)
        verified = int(total_v)
        log(f"verified {verified}/{B} globally")

    # this host's local output shard, in queue order (addressable_shards
    # carries no ordering guarantee — sort by global batch offset)
    shards = sorted(res.sig.addressable_shards, key=lambda s: s.index[0].start or 0)
    local_sig = np.concatenate([np.asarray(s.data) for s in shards], axis=0)
    if args.out:
        np.save(args.out, local_sig)
        log(f"local shard [{local_sig.shape}] -> {args.out}")

    print(json.dumps({
        "process_id": pid,
        "num_processes": nproc,
        "signed": counters["signed"],
        "attempts": counters["attempts"],
        "verified": verified,
        "local_batch": int(mu_local.shape[0]),
        "global_batch": int(B),
        "elapsed_s": round(elapsed, 2),
        "signs_per_sec": round(B / elapsed, 1),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
