// Device-side posit arithmetic shared by the EULER-ADAS CUDA kernels.
//
// Line-for-line counterparts of the JAX kernel bodies:
//   encode_f32     <- repro/kernels/posit_codec.py  encode_body
//                     (and encode_entry + encode_by_entry, its table form)
//   decode_planes  <- repro/kernels/logmac.py       decode_planes_raw
//
// Every shift is kept inside [0, 31] (a 32-bit shift by >= 32 is undefined
// in C++; the JAX code clips the same way), negative numbers are never
// shifted, and powers of two are built as two exponent-field factors so
// results below 2^-126 agree with the reference.  Build without
// --use_fast_math: expf/tanhf/division/denormals must stay IEEE.
#pragma once
#include <stdint.h>

namespace euler {

// A posit format: N-bit words, es exponent bits, regime bound R (0 = none).
struct Posit {
  int N, es, R;
  __device__ __forceinline__ int rcap() const { return R ? R : N - 1; }
  __device__ __forceinline__ int kmax() const { return R ? R - 1 : N - 2; }
  __device__ __forceinline__ int kmin() const { return R ? -R : -(N - 2); }
  __device__ __forceinline__ int max_scale() const {
    return R ? kmax() * (1 << es) + (1 << es) - 1 : kmax() * (1 << es);
  }
  __device__ __forceinline__ int min_scale() const { return kmin() * (1 << es); }
  __device__ __forceinline__ int W() const { return N - 1 - es; }
};

// ILM plane knobs: stages n, effective truncation m (-1 = none; the SIMD
// sub-lane cap is folded in on the host).
struct Planes {
  int stages, m;
};

__device__ __forceinline__ uint32_t mask32(int n) {
  return n >= 32 ? 0xFFFFFFFFu : ((1u << n) - 1u);
}

__device__ __forceinline__ int floor_div_pow2(int x, int sh) {
  // floor(x / 2^sh) without shifting a negative number
  int d = 1 << sh;
  int q = x / d;
  return (x % d != 0 && x < 0) ? q - 1 : q;
}

// XLA's flush of an f32 value: a subnormal becomes a (signed) 0.
__device__ __forceinline__ float flush_subnormal(float v) {
  return fabsf(v) < 0x1p-126f ? copysignf(0.0f, v) : v;
}

__device__ __forceinline__ float exp2i(int e) {
  e = e < -126 ? -126 : (e > 127 ? 127 : e);
  return __uint_as_float((uint32_t)(e + 127) << 23);
}

__device__ __forceinline__ float pow2(int e) {
  // a normal 2^e is its exponent field alone, the same value as the
  // two-factor product below (both factors then lie in [-63, 64])
  if (e >= -126 && e <= 127) return __uint_as_float((uint32_t)(e + 127) << 23);
  int h1 = floor_div_pow2(e, 1);
  return exp2i(h1) * exp2i(e - h1);
}

// f32 -> posit pattern (low N bits), pattern-domain RNE with 26 guard bits.
__device__ __forceinline__ uint32_t encode_f32(float x, Posit pc) {
  const int G = 26;
  const int N = pc.N, es = pc.es;
  uint32_t bits = __float_as_uint(x);
  uint32_t sign = bits >> 31;
  int expf_ = (int)((bits >> 23) & 0xFFu);
  uint32_t frac23 = bits & mask32(23);
  bool is_zero = expf_ == 0;      // zero and subnormals (DAZ)
  bool is_nar = expf_ == 255;     // Inf/NaN -> NaR
  int scale = expf_ - 127;

  bool over = scale > pc.max_scale();
  bool under = scale < pc.min_scale();
  int scale_c = scale < pc.min_scale() ? pc.min_scale()
              : (scale > pc.max_scale() ? pc.max_scale() : scale);
  uint32_t frac_g = (over || under) ? 0u : (frac23 << (G - 23));

  int k = floor_div_pow2(scale_c, es);
  int e = scale_c - k * (1 << es);
  int kmax = pc.kmax(), kmin = pc.kmin(), rcap = pc.rcap();
  bool pos = k >= 0, at_hi = k == kmax, at_lo = k == kmin;
  int w;
  uint32_t rb;
  if (pc.R) {
    w = pos ? (at_hi ? rcap : k + 2) : (at_lo ? rcap : -k + 1);
    rb = pos ? (at_hi ? mask32(rcap) : ((1u << (k + 1)) - 1u) << 1)
             : (at_lo ? 0u : 1u);
  } else {
    w = pos ? (at_hi ? N - 1 : k + 2) : -k + 1;
    rb = pos ? (at_hi ? mask32(N - 1) : ((1u << (k + 1)) - 1u) << 1) : 1u;
  }
  uint32_t T = ((uint32_t)e << G) | frac_g;
  int t = (N - 1) - w;
  int sh = es + G - t;
  uint32_t T_r;
  if (sh > 0) {
    int s = sh > 31 ? 31 : sh;
    uint32_t half = (1u << (s - 1)) - 1u;
    uint32_t lsb = (T >> s) & 1u;
    T_r = (T + half + lsb) >> s;
  } else {
    int s = -sh > 31 ? 31 : -sh;
    T_r = T << s;
  }
  uint32_t body = (rb << (t > 0 ? t : 0)) + T_r;
  uint32_t maxbody = mask32(N - 1);
  body = body < 1u ? 1u : (body > maxbody ? maxbody : body);
  if (over) body = maxbody;
  if (under) body = 1u;
  uint32_t pat = sign ? ((0u - body) & mask32(N)) : body;
  if (is_zero) pat = 0u;
  if (is_nar) pat = 1u << (N - 1);
  return pat;
}

// encode_f32 split at the f32 exponent field.  Everything encode_f32 does
// but the fraction's rounding and the sign depends on the biased exponent
// e8 alone, so a format's 256 entries, built once per block by
// encode_entry, leave about twenty integer instructions a value
// (encode_by_entry), with the same pattern as encode_f32:
//   T    = (ehi | frac23 << (G - 23)) << L   (ehi = e << G, 0 where the
//                                             scale is clamped)
//   T_r  = (T + half + lsb) >> S             (the RNE shift right by
//                                             S = sh, or the exact shift
//                                             left by L = -sh; lsb = bit S
//                                             of T where S > 0)
//   body = clamp(base + T_r, 1, maxbody)     (base = rb << t, or the
//                                             clamped body itself, with
//                                             S = 31 so that T_r = 0:
//                                             T < 2^26)
// then the sign, zero (e8 == 0, subnormals included) and NaR (e8 == 255).
struct __align__(16) EncodeEntry {
  uint32_t base, ehi, half;
  uint32_t shifts;  // S | L << 8 | lsb_mask << 16
};

__device__ __forceinline__ EncodeEntry encode_entry(int e8, Posit pc) {
  const int G = 26;
  const int N = pc.N, es = pc.es;
  int scale = e8 - 127;
  bool over = scale > pc.max_scale();
  bool under = scale < pc.min_scale();
  EncodeEntry en;
  if (over || under) {
    en.base = over ? mask32(N - 1) : 1u;
    en.ehi = 0u;
    en.half = 0u;
    en.shifts = 31u;
    return en;
  }
  int k = floor_div_pow2(scale, es);
  int e = scale - k * (1 << es);
  int kmax = pc.kmax(), kmin = pc.kmin(), rcap = pc.rcap();
  bool pos = k >= 0, at_hi = k == kmax, at_lo = k == kmin;
  int w;
  uint32_t rb;
  if (pc.R) {
    w = pos ? (at_hi ? rcap : k + 2) : (at_lo ? rcap : -k + 1);
    rb = pos ? (at_hi ? mask32(rcap) : ((1u << (k + 1)) - 1u) << 1)
             : (at_lo ? 0u : 1u);
  } else {
    w = pos ? (at_hi ? N - 1 : k + 2) : -k + 1;
    rb = pos ? (at_hi ? mask32(N - 1) : ((1u << (k + 1)) - 1u) << 1) : 1u;
  }
  int t = (N - 1) - w;
  int sh = es + G - t;
  en.base = rb << (t > 0 ? t : 0);
  en.ehi = (uint32_t)e << G;
  if (sh > 0) {
    int s = sh > 31 ? 31 : sh;
    en.half = (1u << (s - 1)) - 1u;
    en.shifts = (uint32_t)s | (1u << 16);
  } else {
    int s = -sh > 31 ? 31 : -sh;
    en.half = 0u;
    en.shifts = (uint32_t)s << 8;
  }
  return en;
}

// The magnitude's (N-1)-bit body, before the sign, zero and NaR.
__device__ __forceinline__ uint32_t body_by_entry(uint32_t bits,
                                                  const EncodeEntry& en,
                                                  Posit pc) {
  const uint32_t S = en.shifts & 0xFFu, L = (en.shifts >> 8) & 0xFFu;
  const uint32_t T = (en.ehi | ((bits & mask32(23)) << 3)) << L;
  const uint32_t lsb = (T >> S) & (en.shifts >> 16);
  const uint32_t body = en.base + ((T + en.half + lsb) >> S);
  const uint32_t maxbody = mask32(pc.N - 1);
  return body < 1u ? 1u : (body > maxbody ? maxbody : body);
}

__device__ __forceinline__ uint32_t encode_by_entry(uint32_t bits,
                                                    const EncodeEntry& en,
                                                    Posit pc) {
  const int N = pc.N;
  const uint32_t e8 = (bits >> 23) & 0xFFu;
  const uint32_t body = body_by_entry(bits, en, pc);
  uint32_t pat = (bits >> 31) ? ((0u - body) & mask32(N)) : body;
  if (e8 == 0u) pat = 0u;
  if (e8 == 0xFFu) pat = 1u << (N - 1);
  return pat;
}

// posit pattern -> (val, rem) f32 ILM planes.
//
// The same function as the fixed-depth scan of decode_planes_raw, in fewer
// integer instructions (it is the inner loop of logmac and paged decode):
// zero and NaR are the only words whose (N-1)-bit body is 0; the regime run
// is a count of leading zeros of the body with r0-runs inverted, capped at
// rcap; the top `stages` set bits of the mantissa are the lowest set bits
// of its bit reversal, each cleared by x & (x - 1).
__device__ __forceinline__ void decode_planes(uint32_t pat, Posit pc, Planes pl,
                                              float* val, float* rem) {
  const int N = pc.N, es = pc.es, W = pc.W(), rcap = pc.rcap();
  uint32_t p = pat & mask32(N);
  uint32_t sign = (p >> (N - 1)) & 1u;
  uint32_t body = sign ? ((0u - p) & mask32(N - 1)) : (p & mask32(N - 1));
  bool special = body == 0u;

  uint32_t r0 = (body >> (N - 2)) & 1u;
  // the body's top bit moved to bit 31; bits equal to r0 become zeros
  int run = __clz((body ^ (0u - r0)) << (33 - N));
  run = run < rcap ? run : rcap;
  int rw = run < rcap ? run + 1 : rcap;
  int k = r0 ? run - 1 : -run;

  uint32_t rem_bits = (body << rw) & mask32(N - 1);
  int e = 0;
  uint32_t frac = rem_bits;
  if (es > 0) {
    e = (int)(rem_bits >> (N - 1 - es));
    frac = rem_bits & mask32(N - 1 - es);
  }
  int scale = k * (1 << es) + e;

  if (pl.m >= 0 && pl.m < W) {
    int drop = W - pl.m;
    frac = (frac >> drop) << drop;
  }
  uint32_t mant = (1u << W) | frac;
  uint32_t low = __brev(mant);
  for (int s = 0; s < pl.stages; ++s) low &= low - 1u;
  uint32_t rmant = __brev(low);
  // a decoded scale lies in [-rcap*2^es, rcap*2^es - 1]; where all of
  // that range less W gives normal powers of two (every bounded format),
  // 2^(scale - W) is its exponent field alone, without a branch
  const bool normal = -rcap * (1 << es) - W >= -126 &&
                      rcap * (1 << es) - 1 - W <= 127;
  float sgn = sign ? -1.0f : 1.0f;
  float p2 = normal ? __uint_as_float((uint32_t)(scale - W + 127) << 23)
                    : pow2(scale - W);
  float unit = sgn * p2;
  float v = unit * (float)mant;
  float r = unit * (float)rmant;
  *val = special ? 0.0f : v;
  *rem = special ? 0.0f : r;
}

}  // namespace euler
