"""Multi-host execution entry: 2-process CPU test of tools/run_multihost.py.

Spawns two OS processes that each call `jax.distributed.initialize` (gloo
collectives over localhost), form one 4-device global mesh (2 virtual CPU
devices per process), feed per-host shards of a deterministic global
message queue, and run the sharded one-key signing service. Asserts:

  * both hosts report the GLOBAL psum counter = full queue size;
  * the concatenated per-host signature shards are byte-identical to the
    single-process `scheme.sign` reference on the same derivation.

This is the framework-side obligation of SURVEY.md §2.7 ("DCN for
multi-host dispatch", `jax.make_array_from_process_local_data`) — the
reference is single-chip and has no analog.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCHER = os.path.join(REPO, "tools", "run_multihost.py")

GLOBAL_BATCH = 8
LEVEL = 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_cpu_multihost(tmp_path):
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env.pop("JAX_COMPILATION_CACHE_DIR", None)  # CPU AOT cache segfaults

    procs = []
    for pid in range(2):
        out = tmp_path / f"shard_{pid}.npy"
        procs.append((subprocess.Popen(
            [sys.executable, LAUNCHER,
             f"--coordinator=127.0.0.1:{port}",
             "--num-processes=2", f"--process-id={pid}",
             f"--level={LEVEL}", f"--global-batch={GLOBAL_BATCH}",
             "--window=4", "--max-rounds=1024", "--signer=stream",
             f"--out={out}"],
            env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ), out))

    reports = []
    for proc, _ in procs:
        stdout, stderr = proc.communicate(timeout=900)
        assert proc.returncode == 0, (
            f"launcher rc={proc.returncode}\nstdout:\n{stdout}\nstderr:\n{stderr}"
        )
        reports.append(json.loads(stdout.strip().splitlines()[-1]))

    # global psum counters identical on every host and equal to the queue
    for r in reports:
        assert r["signed"] == GLOBAL_BATCH
        assert r["global_batch"] == GLOBAL_BATCH
        assert r["local_batch"] == GLOBAL_BATCH // 2
    assert reports[0]["attempts"] == reports[1]["attempts"]

    # per-host shard bytes == the single-process reference on the same
    # derivation (run_multihost: rng(seed=0) -> key seed, then mu queue)
    import jax.numpy as jnp
    from dilithium_tpu import params, scheme

    p = params.get_params(LEVEL)
    rng = np.random.default_rng(0)
    seed = jnp.asarray(rng.integers(0, 256, size=(32,), dtype=np.uint8))
    kp = scheme.keygen(seed, p)
    mus = jnp.asarray(rng.integers(0, 256, size=(GLOBAL_BATCH, 64), dtype=np.uint8))
    sk_b = jnp.broadcast_to(kp.sk, (GLOBAL_BATCH,) + kp.sk.shape)
    ref = scheme.sign(sk_b, mus, p, max_rounds=256)
    assert np.asarray(ref.ok).all()

    got = np.concatenate([np.load(out) for _, out in procs], axis=0)
    np.testing.assert_array_equal(got, np.asarray(ref.sig))


def test_two_process_keys_and_verify(tmp_path):
    """Independent-keys signing service + per-row verify across 2
    processes. 3 distinct keys, key_idx sharded with the
    queue, shard bytes byte-identical to the single-process lockstep
    signer on the same derivation."""
    nkeys = 3
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env.pop("JAX_COMPILATION_CACHE_DIR", None)

    procs = []
    for pid in range(2):
        out = tmp_path / f"kshard_{pid}.npy"
        procs.append((subprocess.Popen(
            [sys.executable, LAUNCHER,
             f"--coordinator=127.0.0.1:{port}",
             "--num-processes=2", f"--process-id={pid}",
             f"--level={LEVEL}", f"--global-batch={GLOBAL_BATCH}",
             "--window=2", "--max-rounds=1024", "--signer=keys",
             f"--nkeys={nkeys}", "--verify", f"--out={out}"],
            env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ), out))

    reports = []
    for proc, _ in procs:
        stdout, stderr = proc.communicate(timeout=900)
        assert proc.returncode == 0, (
            f"launcher rc={proc.returncode}\nstdout:\n{stdout}\nstderr:\n{stderr}"
        )
        reports.append(json.loads(stdout.strip().splitlines()[-1]))

    for r in reports:
        assert r["signed"] == GLOBAL_BATCH
        assert r["verified"] == GLOBAL_BATCH  # every shard's sigs verify
    assert reports[0]["attempts"] == reports[1]["attempts"]

    # byte-identical to the single-process lockstep signer on the same
    # derivation (run_multihost keys mode: rng(0) -> seeds [nkeys, 32]
    # -> mu queue -> key_idx)
    import jax.numpy as jnp
    from dilithium_tpu import params, scheme

    p = params.get_params(LEVEL)
    rng = np.random.default_rng(0)
    seeds = jnp.asarray(rng.integers(0, 256, size=(nkeys, 32), dtype=np.uint8))
    kp = scheme.keygen(seeds, p)
    mus = jnp.asarray(rng.integers(0, 256, size=(GLOBAL_BATCH, 64), dtype=np.uint8))
    key_idx = rng.integers(0, nkeys, size=(GLOBAL_BATCH,)).astype(np.int32)
    ref = scheme.sign(jnp.asarray(np.asarray(kp.sk)[key_idx]), mus, p,
                      max_rounds=256)
    assert np.asarray(ref.ok).all()

    got = np.concatenate([np.load(out) for _, out in procs], axis=0)
    np.testing.assert_array_equal(got, np.asarray(ref.sig))
