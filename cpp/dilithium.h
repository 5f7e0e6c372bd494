// CRYSTALS-Dilithium round-3 host oracle (levels 2/3/5, deterministic).
//
// Role parity: the reference repo's C++ model layer (`dilithium-256/`)
// models only the NTT engine; the full scheme there exists only in RTL
// (`rtl_src/combined_top.v`). This oracle implements the complete scheme
// in portable C++ from the round-3 specification semantics so the JAX
// library can be differentially tested host-side (SURVEY.md §2.6: a C++
// reference implementation for host-side verification).
//
// Conventions match the KAT corpus: tr = 32 bytes (`combined_top.v:980`),
// mu = CRH(tr || M) = 64 bytes, deterministic signing (rhoprime from K).
#pragma once

#include <cstddef>
#include <cstdint>

namespace oracle {

constexpr int32_t kQ = 8380417;  // 2^23 - 2^13 + 1
constexpr int kN = 256;
constexpr int kD = 13;
constexpr int kSeedBytes = 32;
constexpr int kCrhBytes = 64;
constexpr int kTrBytes = 32;

struct Params {
  int level, K, L, eta, tau, beta, omega;
  int32_t gamma1, gamma2;
  int gamma1_bits, eta_bits, w1_bits;
  int polyz_bytes, polyeta_bytes, polyw1_bytes;
  int pk_bytes, sk_bytes, sig_bytes;
};

const Params& params(int level);  // level in {2, 3, 5}

using Poly = int32_t[kN];  // coefficients; domain noted per function

// Scheme API. mu is the 64-byte CRH(tr||M) digest (message hashing is the
// caller's concern, matching the JAX API layering).
void keygen(int level, const uint8_t seed[kSeedBytes], uint8_t* pk, uint8_t* sk);
// Returns the number of rejection attempts used (>= 1).
int sign(int level, const uint8_t* sk, const uint8_t mu[kCrhBytes], uint8_t* sig);
// Returns true iff the signature verifies.
bool verify(int level, const uint8_t* pk, const uint8_t mu[kCrhBytes],
            const uint8_t* sig);

// Exposed primitives for differential kernel tests.
void ntt(Poly a);                       // in-place forward NTT, canonical in/out
void invntt(Poly a);                    // in-place inverse (plain 1/256 fold)
void pointwise(Poly c, const Poly a, const Poly b);  // c = a*b*R^-1 mod q

}  // namespace oracle
