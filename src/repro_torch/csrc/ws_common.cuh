// The warm-start Euler draw of one row, shared by ws_step.cu and ws_fused.cu.
//
// For one row of logits (V columns), the current token x and the mixing
// weight a, with Gumbel noise g[v] from a Noise functor:
//
//   lg          = logits / temperature
//   (m, s)      = online max and sum of exp(lg - m)
//   best, bidx  = max and first argmax of lg + g over v != x
//   score_other = log(max(a, 1e-30)) + best - m - log s
//   score_x     = log(max((1 - a) + a * exp(lg[x] - m) / s, 1e-30)) + g[x]
//   next        = score_x >= score_other ? x : bidx
//
// which is the argmax over v of log((1 - a) onehot(x) + a softmax(lg)) + g
// (the TPU kernels _ws_step_streamed_kernel and _ws_fused_kernel, per step).
// One warp per row: lane l visits columns l, l + 32, ... and a butterfly of
// __shfl_xor_sync merges the lanes. Ties follow the TPU kernels exactly:
// column x is left out of the candidates, a lane's earlier column wins with
// a strict >, the merge prefers the lower column, and score_x >= score_other
// keeps x. a = 0 freezes the row: score_x = g_x >= -4.5 while score_other
// <= log(1e-30) + max g ~ -52.5 (the noise is finite, see CounterNoise).
//
// Every rounding is pinned with __f*_rn intrinsics, so the compiler cannot
// contract a product and a sum into an FMA differently in the two kernels
// that inline this function, and every lane merges its partner's values in
// the same order as the partner merges its own. The result is lane 0's,
// broadcast to the warp. So K launches of ws_step and one ws_fused launch of
// K steps give the same tokens, bit for bit.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace wsfm {

constexpr float kMinProb = 1e-30f;
constexpr float kNeg = -1e30f;
constexpr int kWarpsPerBlock = 8;
// jax.random.uniform(key, shape, minval=tiny, maxval=1) in float32:
// span = float32(1) - float32(tiny) rounds to 1
constexpr float kTiny = 1.17549435e-38f;
constexpr float kSpan = 1.0f;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

struct Words {
  uint32_t x0, x1;
};

#define WSFM_ROUND(r)  \
  x0 += x1;            \
  x1 = rotl32(x1, r);  \
  x1 ^= x0;

// threefry-2x32, 20 rounds, JAX's parameterisation; both output words.
__device__ __forceinline__ Words threefry2x32(uint32_t k0, uint32_t k1, uint32_t c0,
                                              uint32_t c1) {
  const uint32_t ks2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c0 + k0;
  uint32_t x1 = c1 + k1;
  WSFM_ROUND(13) WSFM_ROUND(15) WSFM_ROUND(26) WSFM_ROUND(6)
  x0 += k1; x1 += ks2 + 1u;
  WSFM_ROUND(17) WSFM_ROUND(29) WSFM_ROUND(16) WSFM_ROUND(24)
  x0 += ks2; x1 += k0 + 2u;
  WSFM_ROUND(13) WSFM_ROUND(15) WSFM_ROUND(26) WSFM_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  WSFM_ROUND(17) WSFM_ROUND(29) WSFM_ROUND(16) WSFM_ROUND(24)
  x0 += k1; x1 += ks2 + 4u;
  WSFM_ROUND(13) WSFM_ROUND(15) WSFM_ROUND(26) WSFM_ROUND(6)
  x0 += ks2; x1 += k0 + 5u;
  return {x0, x1};
}

#undef WSFM_ROUND

// The TPU kernels' counter-based noise: Gumbel of word 0 of
// threefry(key, (c0, col)). (bits >> 8) + 0.5 rounds to 2^24 in float32 when
// bits >> 8 = 0xFFFFFF, so u would be 1 and the noise +inf (the JAX
// package's gumbel_from_bits does that, once in 2^24 elements, and such a
// column wins every draw, a = 0 or not); u is clamped at the largest float
// below 1, which changes that element only (g = 16.6).
constexpr float kBelowOne = 0.99999994f;   // 1 - 2^-24

struct CounterNoise {
  uint32_t k0, k1, c0;
  __device__ __forceinline__ float operator()(int col) const {
    const uint32_t bits = threefry2x32(k0, k1, c0, static_cast<uint32_t>(col)).x0;
    const float u = fminf((static_cast<float>(bits >> 8) + 0.5f) * (1.0f / 16777216.0f),
                          kBelowOne);
    return -logf(-logf(u));
  }
};

// jax.random.gumbel(key, (N, V))[n, col] in float32: the bits are x0 ^ x1 of
// threefry(key, (0, n * V + col)), the uniform takes 23 mantissa bits and is
// one FMA with JAX's span and lower end, clamped there, as XLA fuses it.
struct JaxNoise {
  uint32_t k0, k1, base;   // base = n * V
  __device__ __forceinline__ float operator()(int col) const {
    const Words w = threefry2x32(k0, k1, 0u, base + static_cast<uint32_t>(col));
    const uint32_t bits = w.x0 ^ w.x1;
    const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
    const float u = fmaxf(__fmaf_rn(f, kSpan, kTiny), kTiny);
    return -logf(-logf(u));
  }
};

// One draw for the row at lrow; every lane of the warp calls it and gets
// the same token.
template <class Noise>
__device__ __forceinline__ int draw_row(const float* __restrict__ lrow, int vocab, int xr,
                                        float ar, float temperature, const Noise& noise,
                                        int lane) {
  float m = kNeg, s = 0.0f, best = kNeg, lg_x = 0.0f, g_x = 0.0f;
  int bidx = 0;
  for (int col = lane; col < vocab; col += 32) {
    const float lg = __fdiv_rn(lrow[col], temperature);
    const float g = noise(col);
    const float m_new = fmaxf(m, lg);
    s = __fadd_rn(__fmul_rn(s, expf(m - m_new)), expf(lg - m_new));
    m = m_new;
    if (col == xr) {
      lg_x = lg;
      g_x = g;
    } else {
      const float cand = __fadd_rn(lg, g);
      if (cand > best) {  // strict: a lane's earlier column wins a tie
        best = cand;
        bidx = col;
      }
    }
  }

  for (int off = 16; off > 0; off >>= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m, off);
    const float s_o = __shfl_xor_sync(0xffffffffu, s, off);
    const float b_o = __shfl_xor_sync(0xffffffffu, best, off);
    const int i_o = __shfl_xor_sync(0xffffffffu, bidx, off);
    const float m_new = fmaxf(m, m_o);
    s = __fadd_rn(__fmul_rn(s, expf(m - m_new)), __fmul_rn(s_o, expf(m_o - m_new)));
    m = m_new;
    if (b_o > best || (b_o == best && i_o < bidx)) {
      best = b_o;
      bidx = i_o;
    }
    // exactly one lane saw column x; the others hold zeros
    lg_x = __fadd_rn(lg_x, __shfl_xor_sync(0xffffffffu, lg_x, off));
    g_x = __fadd_rn(g_x, __shfl_xor_sync(0xffffffffu, g_x, off));
  }

  const float score_other =
      __fsub_rn(__fsub_rn(__fadd_rn(logf(fmaxf(ar, kMinProb)), best), m), logf(s));
  const float p1x = __fdiv_rn(expf(lg_x - m), s);
  const float px = __fadd_rn(1.0f - ar, __fmul_rn(ar, p1x));
  const float score_x = __fadd_rn(logf(fmaxf(px, kMinProb)), g_x);
  const int next = score_x >= score_other ? xr : bidx;
  return __shfl_sync(0xffffffffu, next, 0);
}

}  // namespace wsfm
