// K fused warm-start Euler sampling steps for Hopper (sm_90a).
//
// Replaces the TPU kernel ws_fused_streamed_pallas / _ws_fused_kernel
// (src/repro/kernels/ws_fused/kernel.py): K consecutive draws against one
// frozen logits buffer (one backbone evaluation), the token carried from
// step to step, so the K - 1 intermediate token buffers never reach device
// memory and K - 1 launches disappear.
//
// Design. ws_step_kernel<G>'s layout: G = lanes_for(V) lanes a row (8 up to
// V = 128, 32 from V = 257 on), 32 / G rows a warp, the carried token in a
// register. Each step is draw_row_grouped<G>'s draw, so one launch of K steps
// equals K ws_step launches bit for bit, but what does not change from step to
// step is taken once (ws_common.cuh, beside draw_row_grouped): the row's (m, s),
// through the same leaves and merge tree, in the first step's walk. Each later
// step hashes its noise, forms lg + g and merges (best, bidx) over v != x through
// the tree; every step reads lg[x] and the noise at x directly. Where a lane's
// columns fit in registers (V <= 16 G, so V = 27 at G = 8: at most 16 columns a
// lane, kCached) lg = logits / T stays there across the K steps; otherwise a step
// re-reads the row, from L1/L2 (V = 50257: 201 KB, from L2), four columns in
// flight a lane. The TPU kernel walked a (row
// block, step, vocab tile) grid with its state in VMEM scratch; here the state
// is in registers and there is no VMEM budget to model.
//
// Two key layouts, one kernel: row r draws step j with the key words
// seeds[j, r / key_group] and the noise counter (r % key_group, col).
//   single key:  key_group = R, one key per step: the counter is the
//                absolute row, as ws_step's;
//   per row:     key_group = N, key (j, b) for request row b: the counter is
//                the position within the request (pack-invariant).
// a[j, r / a_group] is the step's mixing weight (a_group = R for one weight
// per step, N for one per request row). a = 0 freezes a row bit for bit,
// which is how padded tail steps and per-row entry masks are expressed.
//
// Bound on an H100 SXM: the logits are read once (R * V * 4 bytes); the
// arithmetic is K * R * V * ~112 operations (hash, two logf, streamed
// softmax), so at V = 27 the float rate bounds it; at (8192, 27, K = 4)
// about 1.5 us, far below the launch overhead this kernel saves.

#include <type_traits>

#include "ws_common.cuh"

namespace {

constexpr int kThreads = wsfm::kWarpsPerBlock * 32;
constexpr int kCachedCols = wsfm::kColsPerLane;   // lg in registers: V <= G * 16

// __launch_bounds__ with a minimum of one block an SM: without it ptxas held the
// G = 2 instance that re-reads the row at 64 registers and spilled its leaves.
template <int G, bool kCached>
__global__ void __launch_bounds__(kThreads, 1)
ws_fused_kernel(const float* __restrict__ logits, const int32_t* __restrict__ x,
                const float* __restrict__ a, const int64_t* __restrict__ seeds,
                int32_t* __restrict__ out, int rows, int vocab, int steps, int key_group,
                int a_group, float temperature) {
  constexpr int L = 32 / G;                            // leaves a lane holds
  constexpr int kRounds = kCached ? kCachedCols * G / 32 : 0;
  const int lane = threadIdx.x & 31;
  const int first = (blockIdx.x * wsfm::kWarpsPerBlock + (threadIdx.x >> 5)) * (32 / G);
  if (first >= rows) return;  // the whole warp leaves together
  const int mine = first + lane / G;
  const int row = min(mine, rows - 1);  // tail lanes draw the last row again, write nothing
  const int j = lane % G;
  const float* lrow = logits + static_cast<size_t>(row) * vocab;

  const int key_cols = rows / key_group;
  const int a_cols = rows / a_group;
  const int kb = row / key_group;
  const int ab = row / a_group;
  const uint32_t c0 = static_cast<uint32_t>(row % key_group);
  float lgc[kCached ? kCachedCols : 1];   // lg of the lane's columns (kCached)
  float m[L], s[L];                       // the (m, s) leaves, step 0 only
  float mm, ss;                           // the row's (m, s)
  int xr = x[row];

  // One draw: the candidates of step `step` over v != x, and at step 0 (kStats) the
  // row's (m, s) in the same walk, as draw_row_grouped takes them; later steps take
  // lg from registers (kCached) or from the row again.
  auto draw = [&](int step, auto stats) {
    constexpr bool kStats = decltype(stats)::value;
    const int64_t* sd = seeds + 2 * (static_cast<size_t>(step) * key_cols + kb);
    const wsfm::CounterNoise noise{static_cast<uint32_t>(sd[0]),
                                   static_cast<uint32_t>(sd[1]), c0};
    float best[L];
    int bidx[L];
#pragma unroll
    for (int t = 0; t < L; ++t) {
      best[t] = wsfm::kNeg;
      bidx[t] = 0;
      if constexpr (kStats) {
        m[t] = wsfm::kNeg;
        s[t] = 0.0f;
      }
    }
    wsfm::walk_leaves<G, kRounds>(vocab, j, [&](int t, int k, int col) {
      // draw_row_grouped's update, as selects (a column past the row reads the
      // last one and leaves the leaf as it was)
      const bool ok = col < vocab;
      const int c = ok ? col : vocab - 1;
      float lg;
      if constexpr (kCached && !kStats) {
        lg = lgc[k];
      } else {
        lg = __fdiv_rn(lrow[c], temperature);
      }
      if constexpr (kStats) {
        if constexpr (kCached) lgc[k] = lg;
        wsfm::stats_leaf(m[t], s[t], lg, ok);
      }
      const float cand = __fadd_rn(lg, noise(c));
      const bool take = ok && col != xr && cand > best[t];  // strict, as draw_row
      best[t] = take ? cand : best[t];
      bidx[t] = take ? col : bidx[t];
    });
    if constexpr (kStats) wsfm::merge_stats<G>(m, s, mm, ss);
    float bb;
    int bi;
    wsfm::merge_best<G>(best, bidx, bb, bi);
    // column x, read directly (its leaf's value; the tree adds only zeros to it)
    const bool x_in = xr >= 0 && xr < vocab;
    const float lg_x = x_in ? __fdiv_rn(lrow[xr], temperature) : 0.0f;
    const float g_x = x_in ? noise(xr) : 0.0f;
    xr = wsfm::finish_draw(mm, ss, bb, bi, lg_x, g_x, xr,
                           a[static_cast<size_t>(step) * a_cols + ab]);
  };
  draw(0, std::true_type{});
  for (int step = 1; step < steps; ++step) draw(step, std::false_type{});
  if (j == 0 && mine < rows) out[row] = xr;
}

}  // namespace

extern "C" int ws_fused_launch(const void* logits, const void* x, const void* a,
                               const void* seeds, void* out, int rows, int vocab, int steps,
                               int key_group, int a_group, float temperature, int lanes,
                               void* stream) {
  if (rows <= 0 || vocab <= 0 || steps <= 0 || key_group <= 0 || a_group <= 0 ||
      rows % key_group != 0 || rows % a_group != 0)
    return static_cast<int>(cudaErrorInvalidValue);
#define WSFM_FUSED_ARGS                                                                    \
  static_cast<const float*>(logits), static_cast<const int32_t*>(x),                       \
      static_cast<const float*>(a), static_cast<const int64_t*>(seeds),                    \
      static_cast<int32_t*>(out), rows, vocab, steps, key_group, a_group, temperature
#define WSFM_FUSED(G, grid, st)                                                            \
  if (vocab <= (G) * kCachedCols)                                                          \
    ws_fused_kernel<G, true><<<grid, kThreads, 0, st>>>(WSFM_FUSED_ARGS);                  \
  else                                                                                     \
    ws_fused_kernel<G, false><<<grid, kThreads, 0, st>>>(WSFM_FUSED_ARGS)
  WSFM_GROUPED_LAUNCH(lanes, vocab, rows, stream, WSFM_FUSED);
#undef WSFM_FUSED
#undef WSFM_FUSED_ARGS
  return static_cast<int>(cudaGetLastError());
}
