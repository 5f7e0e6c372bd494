"""dilithium_tpu — a CRYSTALS-Dilithium (round-3, v3.1) library for NVIDIA GPUs.

Re-implements the capabilities of the GMUCERG/Dilithium FPGA design
(reference: /root/reference, `combined_top.v`) as an idiomatic JAX/Pallas
framework: batched int32 NTT kernels, lane-parallel Keccak-f[1600], masked
rejection sampling, and `shard_map` data parallelism over device meshes —
keygen / sign / verify at security levels 2, 3 and 5, bit-exact against the
reference's KAT vectors (KAT/*.txt, 100 vectors per level).

Public API
----------
- ``get_params(level)`` -> frozen ``DilithiumParams`` (static jit arg)
- ``scheme.keygen / sign / sign_stream / verify`` — batched, jittable core
- ``api.keygen / sign / verify / Signer`` — bytes-in/bytes-out wrappers
- ``parallel.make_mesh / sharded_sign / ...`` — multi-chip batch services
- ``oracle`` — ctypes binding to the differential-test C++ oracle (cpp/)
"""

from dilithium_tpu.params import DilithiumParams, get_params, LEVELS

__version__ = "0.3.0"

__all__ = ["DilithiumParams", "get_params", "LEVELS", "__version__"]
