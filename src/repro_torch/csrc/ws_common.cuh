// The warm-start Euler draw of one row, shared by ws_step.cu and ws_fused.cu.
// draw_row below is the reference: its leaves and merge tree fix the bits, and
// the kernels run it regrouped (draw_row_grouped<G>, G lanes a row) or taken
// apart for K draws on one row (the pieces after draw_row_grouped), with the
// same bits.
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
// K steps give the same tokens, bit for bit, at every G.
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

// draw_row's draw with G lanes a row (G a power of two, 2 <= G <= 32), so a
// warp draws 32 / G rows; the tokens equal draw_row's bit for bit.
//
// draw_row gives lane l a leaf, the online (m, s, best, bidx, lg_x, g_x) over
// columns l, l + 32, ..., and merges leaf i with leaf i ^ off at off = 16, 8,
// 4, 2, 1. Its merge is symmetric (the products and sums are pinned, fadd
// commutes, ties go to the lower column), so the result depends on the
// tree's shape alone, not on which lane computes which node. Here lane j of a
// group holds leaves j, j + G, ..., j + 32 - G (leaf t of the lane is leaf
// j + G t) and walks their columns in rounds, one column of every leaf a
// round, so the leaves' hashes and logs run side by side. It merges the
// levels off = 16 .. G in registers (leaf i with leaf i ^ off is leaf t with
// leaf t ^ (off / G); only the chain that ends in leaf 0 is kept), then the
// levels off = G / 2 .. 1 by __shfl_xor_sync inside the group. At G = 32 this
// is draw_row's own layout. Every lane of the warp must call it (the shuffles
// take the full mask); each lane of a group gets its row's token.
template <int G, class Noise>
__device__ __forceinline__ int draw_row_grouped(const float* __restrict__ lrow, int vocab,
                                                int xr, float ar, float temperature,
                                                const Noise& noise, int j) {
  static_assert(G >= 2 && G <= 32 && (G & (G - 1)) == 0, "G lanes a row, a power of two");
  constexpr int L = 32 / G;   // leaves a lane holds
  float m[L], s[L], best[L], lg_x[L], g_x[L];
  int bidx[L];
#pragma unroll
  for (int t = 0; t < L; ++t) {
    m[t] = kNeg;
    s[t] = 0.0f;
    best[t] = kNeg;
    lg_x[t] = 0.0f;
    g_x[t] = 0.0f;
    bidx[t] = 0;
  }
  for (int base = j; base < vocab; base += 32) {
#pragma unroll
    for (int t = 0; t < L; ++t) {
      // draw_row's update of leaf j + G t with column col, as selects: a column
      // past the row reads the last one and leaves the leaf as it was, so the
      // L updates are straight-line code the compiler can interleave
      const int col = base + G * t;
      const bool ok = col < vocab;
      const int c = ok ? col : vocab - 1;
      const float lg = __fdiv_rn(lrow[c], temperature);
      const float g = noise(c);
      const float m_new = ok ? fmaxf(m[t], lg) : m[t];
      const float s_new = __fadd_rn(__fmul_rn(s[t], expf(m[t] - m_new)), expf(lg - m_new));
      s[t] = ok ? s_new : s[t];
      m[t] = m_new;
      const bool is_x = ok && col == xr;
      lg_x[t] = is_x ? lg : lg_x[t];
      g_x[t] = is_x ? g : g_x[t];
      const float cand = __fadd_rn(lg, g);
      const bool take = ok && col != xr && cand > best[t];  // strict, as draw_row
      best[t] = take ? cand : best[t];
      bidx[t] = take ? col : bidx[t];
    }
  }

  // levels off = 16 .. G: leaf t takes leaf t + h (= t ^ h for t < h), h = off / G
  constexpr int kLevels = G == 32 ? 0 : G == 16 ? 1 : G == 8 ? 2 : G == 4 ? 3 : 4;
#pragma unroll
  for (int level = 0; level < kLevels; ++level) {
    const int h = (L / 2) >> level;
#pragma unroll
    for (int t = 0; t < h; ++t) {
      const int o = t + h;
      const float m_new = fmaxf(m[t], m[o]);
      s[t] = __fadd_rn(__fmul_rn(s[t], expf(m[t] - m_new)), __fmul_rn(s[o], expf(m[o] - m_new)));
      m[t] = m_new;
      if (best[o] > best[t] || (best[o] == best[t] && bidx[o] < bidx[t])) {
        best[t] = best[o];
        bidx[t] = bidx[o];
      }
      lg_x[t] = __fadd_rn(lg_x[t], lg_x[o]);
      g_x[t] = __fadd_rn(g_x[t], g_x[o]);
    }
  }

  // levels off = G / 2 .. 1: draw_row's butterfly, inside the group
  float mm = m[0], ss = s[0], bb = best[0], lx = lg_x[0], gx = g_x[0];
  int bi = bidx[0];
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, mm, off);
    const float s_o = __shfl_xor_sync(0xffffffffu, ss, off);
    const float b_o = __shfl_xor_sync(0xffffffffu, bb, off);
    const int i_o = __shfl_xor_sync(0xffffffffu, bi, off);
    const float m_new = fmaxf(mm, m_o);
    ss = __fadd_rn(__fmul_rn(ss, expf(mm - m_new)), __fmul_rn(s_o, expf(m_o - m_new)));
    mm = m_new;
    if (b_o > bb || (b_o == bb && i_o < bi)) {
      bb = b_o;
      bi = i_o;
    }
    lx = __fadd_rn(lx, __shfl_xor_sync(0xffffffffu, lx, off));
    gx = __fadd_rn(gx, __shfl_xor_sync(0xffffffffu, gx, off));
  }

  const float score_other =
      __fsub_rn(__fsub_rn(__fadd_rn(logf(fmaxf(ar, kMinProb)), bb), mm), logf(ss));
  const float p1x = __fdiv_rn(expf(lx - mm), ss);
  const float px = __fadd_rn(1.0f - ar, __fmul_rn(ar, p1x));
  const float score_x = __fadd_rn(logf(fmaxf(px, kMinProb)), gx);
  return score_x >= score_other ? xr : bi;
}

// -- draw_row_grouped<G> taken apart, for K draws on one row (ws_fused.cu) ----------
//
// A row's (m, s) depend on its logits and T alone, so K draws on the same row need
// them once. stats_leaf and merge_stats<G> are draw_row_grouped<G>'s leaf update and
// merge tree for (m, s) alone; best_merge and merge_best<G> those for (best, bidx);
// the fields never mix in draw_row's merge, so apart they give the same bits.
// A step then reads lg_x and g_x at column x directly: draw_row's tree adds that one
// value to zeros, which is exact but for the sign of a zero (-0 + 0 = +0), and that
// sign reaches no score (exp(-0 - m) = exp(+0 - m), y + -0 = y + +0 for y = log p).
//
// walk_leaves<G, kRounds> visits a lane's columns in draw_row_grouped<G>'s order:
// round by round (base = j, j + 32, ...), one column of each of the lane's L = 32 / G
// leaves a round, column base + G t for leaf t. f(t, k, col) gets the leaf, the rank
// k = round * L + t of the column among the lane's and the column (col >= vocab past
// the row: f leaves the leaf as it was). With kRounds > 0 the walk is unrolled over at
// most kRounds rounds, so that k can index a register array; the caller ensures that
// vocab <= 32 * kRounds. kRounds = 0 walks any vocab, four rounds unrolled so that
// their columns' hashes and logs overlap (each leaf still takes its columns in order).

template <int G, int kRounds, class F>
__device__ __forceinline__ void walk_leaves(int vocab, int j, F&& f) {
  constexpr int L = 32 / G;
  if constexpr (kRounds > 0) {
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int base = j + 32 * r;
      if (base >= vocab) break;
#pragma unroll
      for (int t = 0; t < L; ++t) f(t, r * L + t, base + G * t);
    }
  } else {
#pragma unroll 4
    for (int base = j; base < vocab; base += 32) {
#pragma unroll
      for (int t = 0; t < L; ++t) f(t, 0, base + G * t);
    }
  }
}

// draw_row's (m, s) update of a leaf by the column lg (ok: the column lies in the row)
__device__ __forceinline__ void stats_leaf(float& m, float& s, float lg, bool ok) {
  const float m_new = ok ? fmaxf(m, lg) : m;
  const float s_new = __fadd_rn(__fmul_rn(s, expf(m - m_new)), expf(lg - m_new));
  s = ok ? s_new : s;
  m = m_new;
}

// draw_row's merge of (m_o, s_o) into (m, s)
__device__ __forceinline__ void stats_merge(float& m, float& s, float m_o, float s_o) {
  const float m_new = fmaxf(m, m_o);
  s = __fadd_rn(__fmul_rn(s, expf(m - m_new)), __fmul_rn(s_o, expf(m_o - m_new)));
  m = m_new;
}

// draw_row's merge of (b_o, i_o) into (best, bidx): the larger, ties to the lower column
__device__ __forceinline__ void best_merge(float& best, int& bidx, float b_o, int i_o) {
  if (b_o > best || (b_o == best && i_o < bidx)) {
    best = b_o;
    bidx = i_o;
  }
}

// draw_row_grouped<G>'s levels off = 16 .. G, in registers: leaf t takes leaf t + H
// for H = L / 2, L / 4, ..., 1, each level's H a compile-time constant (a level loop
// that computes H at run time leaves the leaves on the stack at G = 2).
template <int H, class Merge>
__device__ __forceinline__ void merge_register_levels(Merge&& merge) {
  if constexpr (H > 0) {
#pragma unroll
    for (int t = 0; t < H; ++t) merge(t, t + H);
    merge_register_levels<H / 2>(merge);
  }
}

// The lane's leaves' (m, s), merged as draw_row_grouped<G> merges them; every lane of
// the group ends with the row's (m, s).
template <int G>
__device__ __forceinline__ void merge_stats(float (&m)[32 / G], float (&s)[32 / G], float& mm,
                                            float& ss) {
  merge_register_levels<16 / G>([&](int t, int o) { stats_merge(m[t], s[t], m[o], s[o]); });
  mm = m[0];
  ss = s[0];
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    stats_merge(mm, ss, __shfl_xor_sync(0xffffffffu, mm, off),
                __shfl_xor_sync(0xffffffffu, ss, off));
}

// The same tree for the leaves' (best, bidx)
template <int G>
__device__ __forceinline__ void merge_best(float (&best)[32 / G], int (&bidx)[32 / G],
                                           float& bb, int& bi) {
  merge_register_levels<16 / G>(
      [&](int t, int o) { best_merge(best[t], bidx[t], best[o], bidx[o]); });
  bb = best[0];
  bi = bidx[0];
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    best_merge(bb, bi, __shfl_xor_sync(0xffffffffu, bb, off),
               __shfl_xor_sync(0xffffffffu, bi, off));
}

// draw_row's scores from the merged row: keep x or move to bidx
__device__ __forceinline__ int finish_draw(float mm, float ss, float bb, int bi, float lx,
                                           float gx, int xr, float ar) {
  const float score_other =
      __fsub_rn(__fsub_rn(__fadd_rn(logf(fmaxf(ar, kMinProb)), bb), mm), logf(ss));
  const float p1x = __fdiv_rn(expf(lx - mm), ss);
  const float px = __fadd_rn(1.0f - ar, __fmul_rn(ar, p1x));
  const float score_x = __fadd_rn(logf(fmaxf(px, kMinProb)), gx);
  return score_x >= score_other ? xr : bi;
}

// -- the host side of the grouped layout, shared by ws_step.cu and ws_fused.cu ------

// Lanes a row for a vocabulary of V columns: 8, doubled (to 32, draw_row's
// layout) while a lane would take more than kColsPerLane columns. Timed on an
// H100 at 8192 rows, 8 lanes beat 2, 4, 16 and 32 at V = 27, 64 and 100: fewer
// lanes leave too few warps to hide the hash's and the logs' latency, more
// spend the issue on merges.
constexpr int kColsPerLane = 16;

inline int lanes_for(int vocab) {
  int g = 8;
  while (g < 32 && g * kColsPerLane < vocab) g *= 2;
  return g;
}

inline bool admissible_lanes(int lanes) {
  return lanes == 2 || lanes == 4 || lanes == 8 || lanes == 16 || lanes == 32;
}

// Launch over rows rows with G lanes a row, 32 / G rows a warp, kWarpsPerBlock warps a
// block, for the G that lanes names (0: lanes_for(vocab)): LAUNCH(G, grid, stream)
// launches the kernel's instance for the compile-time G. Returns from the caller with
// cudaErrorInvalidValue for a G that is not admissible.
#define WSFM_GROUPED_LAUNCH(lanes, vocab, rows, stream, LAUNCH)                         \
  do {                                                                                 \
    const int g_ = (lanes) == 0 ? wsfm::lanes_for(vocab) : (lanes);                    \
    if (!wsfm::admissible_lanes(g_)) return static_cast<int>(cudaErrorInvalidValue);   \
    const int warps_ = ((rows) + 32 / g_ - 1) / (32 / g_);                              \
    const dim3 grid_((warps_ + wsfm::kWarpsPerBlock - 1) / wsfm::kWarpsPerBlock);        \
    const auto st_ = static_cast<cudaStream_t>(stream);                                \
    switch (g_) {                                                                      \
      case 2: LAUNCH(2, grid_, st_); break;                                            \
      case 4: LAUNCH(4, grid_, st_); break;                                            \
      case 8: LAUNCH(8, grid_, st_); break;                                            \
      case 16: LAUNCH(16, grid_, st_); break;                                          \
      default: LAUNCH(32, grid_, st_); break;                                          \
    }                                                                                  \
  } while (0)

}  // namespace wsfm
