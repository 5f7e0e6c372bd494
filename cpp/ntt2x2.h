// Algorithmic model of the reference's 2x2 NTT engine semantics.
//
// Role parity with the reference model layer (SURVEY.md §2.6):
//   * `ntt2x2` / `invntt2x2`  — the fused two-stage transform of
//     `reference_code/ref_ntt2x2.cpp:37-145`: four passes of two NTT levels
//     each, plain mod-q ("Barrett") arithmetic on the natural-order zeta
//     table, and the inverse folding 1/256 as a per-level divide-by-2
//     (`ref_ntt2x2.cpp:91`, `butterfly.v:214-222`).
//   * `resolve_address` + `LineRam` ops — the in-place layout-permutation
//     contract of the hardware model (`hardware_code/address_encoder_
//     decoder.cpp:34-55`, `ntt2x2_fwdntt/invntt/mul.cpp`): polynomials live
//     as 64 lines x 4 coefficients, each operation reads through the
//     previous operation's line permutation and leaves its output under its
//     own, so chained ops never move data (NATURAL -> AFTER_NTT ->
//     NATURAL/AFTER_INVNTT exactly as `hardware_code/ntt2x2_test.cpp:
//     41-137` exercises).
//
// This is a behavioral model, not a cycle model: the reference's staggered
// FIFO/PIPO pipeline (`fifo.h`) exists to meet BRAM timing and has no
// observable effect on values or layouts, so it is not modeled. The JAX
// compute path uses none of this file (see ops/ntt.py); it exists so the
// reference's differential
// test strategy (SURVEY.md §4.3) can be replayed against this codebase.
#pragma once

#include <cstdint>

#include "dilithium.h"

namespace oracle {

// Plain ("Barrett-domain") mod-q arithmetic shared by the 2x2 models: they
// deliberately avoid the Montgomery helpers the main oracle uses so the
// differential tests compare two independent arithmetic stacks (as the
// reference pits `ref_ntt2x2.cpp`'s %-arithmetic against `ref_ntt.cpp`).
inline int32_t plain_mul(int32_t a, int32_t b) {
  return int32_t((int64_t(a) * b) % kQ);
}
inline int32_t plain_add(int32_t a, int32_t b) {
  int32_t t = a + b;
  return t >= kQ ? t - kQ : t;
}
inline int32_t plain_sub(int32_t a, int32_t b) {
  int32_t t = a - b;
  return t < 0 ? t + kQ : t;
}
// Exact halving mod q (q odd): the per-level fold the RTL uses instead of a
// final 1/256 multiply (`ref_ntt2x2.cpp:91`, `butterfly.v:214-222`).
inline int32_t plain_div2(int32_t a) {
  return (a >> 1) + ((a & 1) ? (kQ + 1) / 2 : 0);
}

// Natural-order plain zeta table entry: zeta^bitrev8(k) mod q (zeta = 1753),
// matching `zetas.txt` / `consts.cpp:64-97` exactly for k >= 1 (entry 0 is
// unused; the file stores 0 there).
int32_t plain_zeta(int k);

// In-place fused 2x2 forward/inverse NTT on a flat polynomial, canonical
// [0, q) in and out. `invntt2x2(ntt2x2(a)) == a` (the div2 folding absorbs
// the 1/256 scale); outputs are bit-identical to `ntt`/`invntt`.
void ntt2x2(Poly a);
void invntt2x2(Poly a);

// ---- line-layout (BRAM) model ----

enum class Mapping { kNatural, kAfterNtt, kAfterInvntt };

// Logical line address -> physical line, per `address_encoder_decoder.cpp:
// 34-55` (AFTER_NTT = rotate the 6 address bits left by 2, AFTER_INVNTT =
// left by 4; their composition is the identity, which is why a forward NTT
// chained into an inverse lands back on NATURAL).
unsigned resolve_address(Mapping mapping, unsigned addr);

struct LineRam {
  int32_t lines[kN / 4][4];
};

// Natural load/readback: line i holds coefficients 4i..4i+3 ("reshape",
// `hardware_code/util.cpp:61-72`); `extract` reads back through a mapping.
void reshape(LineRam* ram, const Poly in);
void extract(const LineRam& ram, Mapping mapping, Poly out);

// One polynomial op per call on the line layout, mirroring the engine's
// invocation contract (`operation_module.v:50-55`): `mapping` names the
// layout the input currently sits under. The forward NTT leaves its output
// rotated two address bits further (NATURAL -> AFTER_NTT), the inverse four
// (NATURAL -> AFTER_INVNTT, AFTER_NTT -> NATURAL); `mul` multiplies
// slotwise against `other` (same layout assumed when mapping == kNatural)
// and keeps the layout unchanged (`ntt2x2_mul.cpp:33-59`).
void lineram_fwdntt(LineRam* ram, Mapping mapping);
void lineram_invntt(LineRam* ram, Mapping mapping);
void lineram_mul(LineRam* ram, const LineRam& other, Mapping mapping);

// Layout produced by an op given its input layout (exposed for tests).
Mapping after_fwdntt(Mapping in);
Mapping after_invntt(Mapping in);

// Pipeline-ordered model of the engine's FIFO dataflow (ntt2x2_staged.cpp):
// same contract as lineram_fwdntt/lineram_invntt but computed in the
// reference hardware model's touch order — stride walk, 4-line corner-turn
// groups, one-group-delayed writeback (`hardware_code/ntt2x2_fwdntt.cpp`,
// `fifo.h`). Aborts if any butterfly's operands fail to form a clean NTT
// group or the final layout deviates from the permutation contract; must
// produce bit-identical LineRam contents to the behavioral ops.
void staged_fwdntt(LineRam* ram, Mapping mapping);
void staged_invntt(LineRam* ram, Mapping mapping);

}  // namespace oracle
