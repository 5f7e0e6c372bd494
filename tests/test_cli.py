"""CLI round-trip: keygen -> sign -> verify -> corrupted verify fails.

Drives `python -m dilithium_tpu` as a subprocess — the file-level host-bus
surface (`combined_top.v:26-42` analog).
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {
    **os.environ,
    "JAX_PLATFORMS": "cpu",
    "PYTHONPATH": REPO,
}


def run(*args):
    return subprocess.run(
        [sys.executable, "-m", "dilithium_tpu", *args],
        cwd=REPO, env=ENV, capture_output=True, text=True,
    )


def test_cli_roundtrip(tmp_path):
    pk, sk = str(tmp_path / "key.pk"), str(tmp_path / "key.sk")
    seed = tmp_path / "seed.bin"
    seed.write_bytes(bytes(range(32)))
    r = run("--level", "2", "keygen", "--seed", str(seed), "--pk", pk, "--sk", sk)
    assert r.returncode == 0, r.stderr

    m1 = tmp_path / "a.txt"
    m2 = tmp_path / "b.txt"
    m1.write_bytes(b"message one")
    m2.write_bytes(b"message two")
    r = run("--level", "2", "sign", "--sk", sk, str(m1), str(m2))
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "a.txt.sig").exists()

    r = run("--level", "2", "verify", "--pk", pk, str(m1), str(m2))
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("OK") == 2

    # corrupt one message: exit code 1, per-file FAIL
    m2.write_bytes(b"message two!")
    r = run("--level", "2", "verify", "--pk", pk, str(m1), str(m2))
    assert r.returncode == 1
    assert "FAIL" in r.stdout and "OK" in r.stdout

    # bad seed length: usage error
    seed.write_bytes(b"short")
    r = run("--level", "2", "keygen", "--seed", str(seed), "--pk", pk, "--sk", sk)
    assert r.returncode == 2


def test_cli_randomized_sign(tmp_path):
    pk, sk = str(tmp_path / "key.pk"), str(tmp_path / "key.sk")
    seed = tmp_path / "seed.bin"
    seed.write_bytes(bytes(range(32)))
    r = run("--level", "2", "keygen", "--seed", str(seed), "--pk", pk, "--sk", sk)
    assert r.returncode == 0, r.stderr

    m = tmp_path / "msg.txt"
    m.write_bytes(b"randomize me")
    r = run("--level", "2", "sign", "--sk", sk, "--randomized", str(m))
    assert r.returncode == 0, r.stderr
    sig1 = (tmp_path / "msg.txt.sig").read_bytes()
    r = run("--level", "2", "sign", "--sk", sk, "--randomized", str(m))
    assert r.returncode == 0, r.stderr
    sig2 = (tmp_path / "msg.txt.sig").read_bytes()
    assert sig1 != sig2  # fresh coins per invocation

    r = run("--level", "2", "verify", "--pk", pk, str(m))
    assert r.returncode == 0, r.stdout + r.stderr
