// How the small-M logmac kernel and paged decode decode a word into its
// (val, rem) ILM planes; every path gives euler::decode_planes' planes bit
// for bit.
//
// FMT_TABLE8 reads 8-bit words from a 256-entry (val, rem) table.
// FMT_TABLE16 reads 16-bit words of a format whose regime bound, exponent
// bits and kept fraction bits add up to at most 12 (P16 L-21b: 3 + 1 + 8):
// a nonzero word's planes are then those of its sign and the top 12 of its
// 15 body bits, read from a 4096-entry table of the positive bodies
// (i << 3) | 1 that euler::decode_planes builds on the card
// (logmac_table16); the sign flips both planes exactly.  Which formats
// qualify is decided once, by the wrapper (kernels/logmac.py:
// table16_key), which passes a table exactly then.  FMT_P32 (P32 L-21b)
// passes its knobs as constants so the decoder's masks, shifts and stage
// loop fold away; FMT_ANY takes them at run time.
#pragma once
#include "posit_common.cuh"

enum { FMT_ANY = 0, FMT_TABLE8 = 1, FMT_TABLE16 = 2, FMT_P32 = 3 };
constexpr int TABLE16 = 4096;
// P32 L-21b: es 2, regime bound 5, stages 12, truncation 16
constexpr int P32_ES = 2, P32_R = 5, P32_STAGES = 12, P32_M = 16;

// The decode path for words of (pc, pl); table16: the caller passed a
// 16-bit table for this format.
static inline int pick_format(const euler::Posit& pc, const euler::Planes& pl,
                              bool table16) {
  if (table16) return FMT_TABLE16;
  if (pc.N == 8) return FMT_TABLE8;
  if (pc.N == 32 && pc.es == P32_ES && pc.R == P32_R &&
      pl.stages == P32_STAGES && pl.m == P32_M)
    return FMT_P32;
  return FMT_ANY;
}

template <int FMT>
__device__ __forceinline__ void decode_word(uint32_t w, const euler::Posit& pc,
                                            const euler::Planes& pl,
                                            const float2* tab, float& v,
                                            float& r) {
  if constexpr (FMT == FMT_TABLE8) {
    float2 t = tab[w & 0xFFu];
    v = t.x;
    r = t.y;
  } else if constexpr (FMT == FMT_TABLE16) {
    const uint32_t p = w & 0xFFFFu, sign = p >> 15;
    const uint32_t body = (sign ? 0u - p : p) & 0x7FFFu;
    const float2 t = tab[body >> 3];
    const uint32_t sb = sign << 31;
    v = body ? __uint_as_float(__float_as_uint(t.x) ^ sb) : 0.0f;
    r = body ? __uint_as_float(__float_as_uint(t.y) ^ sb) : 0.0f;
  } else if constexpr (FMT == FMT_P32) {
    euler::decode_planes(w, euler::Posit{32, P32_ES, P32_R},
                         euler::Planes{P32_STAGES, P32_M}, &v, &r);
  } else {
    euler::decode_planes(w, pc, pl, &v, &r);
  }
}
