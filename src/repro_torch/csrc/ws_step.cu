// Warm-start Euler sampling step for Hopper (sm_90a): one draw per row.
//
// ws_step_kernel replaces the TPU kernel ws_step_streamed_pallas /
// _ws_step_streamed_kernel (src/repro/kernels/ws_step/kernel.py): one key
// for the whole batch, the noise keyed by the absolute (row, col) through
// the TPU kernel's counter-based threefry (its hardware PRNG has no
// counterpart), so it does not depend on the launch shape.
//
// ws_step_rows_kernel is the scheduler's per-row mode, which the JAX
// package runs in XLA (make_euler_one_step_rows, core/sampler.py): request
// row b of a (B, N, V) batch draws with its own key, and its noise is
// jax.random.gumbel(key_b, (N, V)), so a request's draw depends on its own
// key alone, wherever it sits in the batch.
//
// ws_step_gumbel_kernel<G, kKeyed> replaces the TPU kernel ws_step_pallas /
// _ws_step_kernel (same file): the Euler step with Gumbel noise, scored in
// probability space over the first valid_v of Vp columns:
//   x' = argmax_v log(max((1 - a) [v == x] + a softmax(lg / T)_v, 1e-30)) + g_v.
// That score is a different floating-point function from draw_row's streamed
// decomposition, so it has its own three passes (max, sum, score + argmax). The
// noise is given (kKeyed false: an (R, Vp) array, the TPU kernel's contract) or
// keyed (kKeyed true: jax.random.gumbel(key, (R, Vp)) hashed in pass 3, each
// element once, as the JAX package's default step draws it in XLA), so the
// default Euler step is one launch with no noise array.
//
// Design of ws_step_kernel and ws_step_rows_kernel. G lanes draw a row (G a
// power of two chosen from V alone by lanes_for: 8 up to V = 128, 32 from V = 257
// on), so a warp draws 32 / G rows, through ws_common.cuh draw_row_grouped:
// draw_row's leaves and its xor merge tree, regrouped so that a lane computes
// 32 / G leaves side by side and merges the upper levels in registers, and the
// group's lanes the last log2(G) levels by shuffles. The tokens equal
// draw_row's bit for bit at every G, so they equal ws_fused.cu's, whose K
// draws take the same leaves and tree. Any V (27, 50257, 262144) runs without
// padding. Build without --use_fast_math: logf must be the accurate one for
// the Gumbel noise to match the plain version. The C entry points take `lanes` (0: lanes_for)
// so that the tests can hold every G against G = 32.
//
// The step key of ws_step and of the keyed ws_step_gumbel comes as its two words by
// value (ws_step_kernel, ws_step_gumbel_kernel) or as a pointer to them on the card
// (ws_step_dkey_kernel, ws_step_gumbel_dkey_kernel): a CUDA graph of the refine loop
// reads each replay's keys through the pointer, where words passed by value would be
// baked into it. A dkey kernel loads the words and runs the same row body on them, so
// the two give the same bits; the by-value kernels are unchanged (their words stay in
// the constant bank). The loaded words take registers, and ptxas then held the keyed
// body at 32 registers with spills: the dkey kernels declare __launch_bounds__(256, 1)
// (at least one block an SM), which lifts that cap.
//
// Bound on an H100 SXM: the logits are the only (R, V) array read (R * V
// * 4 bytes, plus 12 bytes a row); the arithmetic is a 20-round hash, two
// logf for the noise and the streamed softmax per element, about 112
// operations, so at V = 27 the float rate bounds it (0.37 us at R = 8192).
// With one warp a row (draw_row) at V = 27 the 5 butterfly levels cost about
// as much issue as the element itself (160 lane merges where the tree needs
// 31). Fewer lanes a row cost less issue but leave fewer warps to hide the
// hash's and the logs' latency: at (8192, 27) on an H100, G = 8 took 4.3 us,
// G = 32 6.3, G = 4 9.9 and G = 2 19 (chip_smoke.py times every G). What
// holds the kernel above its bound at that size is the launch (1.3 us for
// the least kernel on that card) and the latency of a warp's chain of
// elements; a CUDA graph of the refine loop is the tool for the first.
//
// ws_step_gumbel takes the layout of ws_step_kernel<G>, G = lanes_for(valid_v),
// since with the hash inside its element costs about what ws_step's does. Keyed,
// the logits are the only (R, Vp) array read (R * valid_v * 4 bytes, plus 12 a
// row) and an element is about 130 operations (the hash, the uniform, three logf,
// two expf, a division and the mixing), so the float rate bounds it (0.43 us at
// (8192, 27)). Given, it reads the noise too (8 bytes an element) and does about
// 20 operations an element: the bytes bound it (0.56 us there). Both are
// launch-bound at that size. At (8192, 27) on an H100 the keyed launch took
// 5.6 us at G = 8, 5.1 at 16, 5.9 at 32, 6.1 at 4 and 10.1 at 2 (chip_smoke.py
// times every G). G = 16 would save 0.5 us a launch, 6 us a 13-step generate,
// so lanes_for's 8 is kept and every ws kernel takes its G from one rule.

#include "ws_common.cuh"

namespace {

// G lanes a row, 32 / G rows a warp. A warp past the last row leaves whole;
// in the last warp, lanes past the last row draw that row again (every lane
// must join the shuffles) and write nothing.
template <int G>
__device__ __forceinline__ void step_rows(const float* __restrict__ logits,
                                          const int32_t* __restrict__ x,
                                          const float* __restrict__ a,
                                          int32_t* __restrict__ out, int rows, int vocab,
                                          uint32_t seed0, uint32_t seed1, float temperature) {
  const int lane = threadIdx.x & 31;
  const int first = (blockIdx.x * wsfm::kWarpsPerBlock + (threadIdx.x >> 5)) * (32 / G);
  if (first >= rows) return;  // the whole warp leaves together
  const int mine = first + lane / G;
  const int row = min(mine, rows - 1);
  const wsfm::CounterNoise noise{seed0, seed1, static_cast<uint32_t>(row)};
  const int next = wsfm::draw_row_grouped<G>(logits + static_cast<size_t>(row) * vocab, vocab,
                                             x[row], a[row], temperature, noise, lane % G);
  if (lane % G == 0 && mine < rows) out[row] = next;
}

template <int G>
__global__ void __launch_bounds__(wsfm::kWarpsPerBlock * 32)
ws_step_kernel(const float* __restrict__ logits, const int32_t* __restrict__ x,
               const float* __restrict__ a, int32_t* __restrict__ out, int rows, int vocab,
               uint32_t seed0, uint32_t seed1, float temperature) {
  step_rows<G>(logits, x, a, out, rows, vocab, seed0, seed1, temperature);
}

// key: (2,) int64 on the card holding the two uint32 words (prng's key data).
template <int G>
__global__ void __launch_bounds__(wsfm::kWarpsPerBlock * 32, 1)
ws_step_dkey_kernel(const float* __restrict__ logits, const int32_t* __restrict__ x,
                    const float* __restrict__ a, const int64_t* __restrict__ key,
                    int32_t* __restrict__ out, int rows, int vocab, float temperature) {
  step_rows<G>(logits, x, a, out, rows, vocab, static_cast<uint32_t>(key[0]),
               static_cast<uint32_t>(key[1]), temperature);
}

// keys: (B, 2) int64 holding uint32 key words; a: (B,); rows = B * group.
template <int G>
__global__ void __launch_bounds__(wsfm::kWarpsPerBlock * 32)
ws_step_rows_kernel(const float* __restrict__ logits, const int32_t* __restrict__ x,
                    const float* __restrict__ a, const int64_t* __restrict__ keys,
                    int32_t* __restrict__ out, int rows, int vocab, int group,
                    float temperature) {
  const int lane = threadIdx.x & 31;
  const int first = (blockIdx.x * wsfm::kWarpsPerBlock + (threadIdx.x >> 5)) * (32 / G);
  if (first >= rows) return;
  const int mine = first + lane / G;
  const int row = min(mine, rows - 1);
  const int b = row / group;
  const uint32_t n = static_cast<uint32_t>(row % group);
  const wsfm::JaxNoise noise{static_cast<uint32_t>(keys[2 * b]),
                             static_cast<uint32_t>(keys[2 * b + 1]),
                             n * static_cast<uint32_t>(vocab)};
  const int next = wsfm::draw_row_grouped<G>(logits + static_cast<size_t>(row) * vocab, vocab,
                                             x[row], a[b], temperature, noise, lane % G);
  if (lane % G == 0 && mine < rows) out[row] = next;
}

// The noise of ws_step_gumbel: given, g[row * vp + v] of an (R, Vp) array ...
struct GivenNoise {
  const float* __restrict__ g;   // the row's noise
  __device__ __forceinline__ float operator()(int v) const { return g[v]; }
};

// ... or keyed: jax.random.gumbel(key, (R, Vp))[row, v], hashed here (JaxNoise with
// base = row * Vp; the launch refuses R * Vp >= 2**32, as jax.random does).

// ws_step_pallas's draw of one row with G lanes: lane j of the group takes columns
// j, j + G, ... of the first valid_v. Pass 1 takes the max of lg / T, pass 2 the sum
// of exp(lg / T - m), pass 3 the score and its first argmax; each ends in a xor
// butterfly inside the group, which leaves the same value in every lane (a pair adds
// or compares the same two values). A max is exact in any order; the sum's order is
// fixed by G alone, so both noise sources give the same tokens at the same G. Every
// rounding is as the plain version's separate operations take it (no contraction
// into an FMA).
template <int G, class Noise>
__device__ __forceinline__ int gumbel_draw(const float* __restrict__ lg, int valid_v, int xr,
                                           float ar, float temperature, const Noise& noise,
                                           int j) {
  float m = wsfm::kNeg;
  for (int v = j; v < valid_v; v += G) m = fmaxf(m, lg[v] / temperature);
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));

  float s = 0.0f;
  for (int v = j; v < valid_v; v += G) s = __fadd_rn(s, expf(__fsub_rn(lg[v] / temperature, m)));
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));

  const float keep = __fsub_rn(1.0f, ar);
  float best = __int_as_float(static_cast<int>(0xff800000u));  // -inf
  int bidx = valid_v;
  for (int v = j; v < valid_v; v += G) {
    const float p1 = __fdiv_rn(expf(__fsub_rn(lg[v] / temperature, m)), s);
    const float probs = __fadd_rn(__fmul_rn(keep, v == xr ? 1.0f : 0.0f), __fmul_rn(ar, p1));
    const float score = __fadd_rn(logf(fmaxf(probs, wsfm::kMinProb)), noise(v));
    if (score > best) {  // strict: a lane's earlier column wins a tie
      best = score;
      bidx = v;
    }
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    wsfm::best_merge(best, bidx, __shfl_xor_sync(0xffffffffu, best, off),
                     __shfl_xor_sync(0xffffffffu, bidx, off));
  return bidx;
}

// logits: (rows, vp); x, out: (rows,); a: (rows / a_group,), row r mixes with
// a[r / a_group]; gumbel: (rows, vp) when the noise is given, else unused. Columns >=
// valid_v are never read and never win (their score is -1e30 in the TPU kernel). The
// layout is ws_step_kernel<G>'s: tail lanes draw the last row again and write nothing.
template <int G, bool kKeyed>
__device__ __forceinline__ void gumbel_rows(const float* __restrict__ logits,
                                            const int32_t* __restrict__ x,
                                            const float* __restrict__ a,
                                            const float* __restrict__ gumbel,
                                            int32_t* __restrict__ out, int rows, int vp,
                                            int valid_v, int a_group, uint32_t k0, uint32_t k1,
                                            float temperature) {
  const int lane = threadIdx.x & 31;
  const int first = (blockIdx.x * wsfm::kWarpsPerBlock + (threadIdx.x >> 5)) * (32 / G);
  if (first >= rows) return;  // the whole warp leaves together
  const int mine = first + lane / G;
  const int row = min(mine, rows - 1);
  const float* lg = logits + static_cast<size_t>(row) * vp;
  int next;
  if constexpr (kKeyed) {
    const wsfm::JaxNoise noise{k0, k1, static_cast<uint32_t>(row) * static_cast<uint32_t>(vp)};
    next = gumbel_draw<G>(lg, valid_v, x[row], a[row / a_group], temperature, noise, lane % G);
  } else {
    const GivenNoise noise{gumbel + static_cast<size_t>(row) * vp};
    next = gumbel_draw<G>(lg, valid_v, x[row], a[row / a_group], temperature, noise, lane % G);
  }
  if (lane % G == 0 && mine < rows) out[row] = next;
}

template <int G, bool kKeyed>
__global__ void __launch_bounds__(wsfm::kWarpsPerBlock * 32)
ws_step_gumbel_kernel(const float* __restrict__ logits, const int32_t* __restrict__ x,
                      const float* __restrict__ a, const float* __restrict__ gumbel,
                      int32_t* __restrict__ out, int rows, int vp, int valid_v, int a_group,
                      uint32_t k0, uint32_t k1, float temperature) {
  gumbel_rows<G, kKeyed>(logits, x, a, gumbel, out, rows, vp, valid_v, a_group, k0, k1,
                         temperature);
}

// The keyed draw with its key on the card: key (2,) int64 holding the two words.
template <int G>
__global__ void __launch_bounds__(wsfm::kWarpsPerBlock * 32, 1)
ws_step_gumbel_dkey_kernel(const float* __restrict__ logits, const int32_t* __restrict__ x,
                           const float* __restrict__ a, const int64_t* __restrict__ key,
                           int32_t* __restrict__ out, int rows, int vp, int valid_v,
                           int a_group, float temperature) {
  gumbel_rows<G, true>(logits, x, a, nullptr, out, rows, vp, valid_v, a_group,
                       static_cast<uint32_t>(key[0]), static_cast<uint32_t>(key[1]),
                       temperature);
}

constexpr int kThreads = wsfm::kWarpsPerBlock * 32;

bool gumbel_shape_ok(int rows, int vp, int valid_v) {
  return rows > 0 && vp > 0 && valid_v > 0 && valid_v <= vp;
}

}  // namespace

extern "C" int ws_step_lanes(int vocab) { return vocab > 0 ? wsfm::lanes_for(vocab) : 0; }

extern "C" int ws_step_launch(const void* logits, const void* x, const void* a, void* out,
                              int rows, int vocab, uint32_t seed0, uint32_t seed1,
                              float temperature, int lanes, void* stream) {
  if (rows <= 0 || vocab <= 0) return static_cast<int>(cudaErrorInvalidValue);
#define WSFM_STEP(G, grid, st)                                                             \
  ws_step_kernel<G><<<grid, kThreads, 0, st>>>(                                            \
      static_cast<const float*>(logits), static_cast<const int32_t*>(x),                   \
      static_cast<const float*>(a), static_cast<int32_t*>(out), rows, vocab, seed0, seed1, \
      temperature)
  WSFM_GROUPED_LAUNCH(lanes, vocab, rows, stream, WSFM_STEP);
#undef WSFM_STEP
  return static_cast<int>(cudaGetLastError());
}

// The step key on the card: key (2,) int64, read by the kernel.
extern "C" int ws_step_dkey_launch(const void* logits, const void* x, const void* a,
                                   const void* key, void* out, int rows, int vocab,
                                   float temperature, int lanes, void* stream) {
  if (rows <= 0 || vocab <= 0 || key == nullptr) return static_cast<int>(cudaErrorInvalidValue);
#define WSFM_STEP(G, grid, st)                                                             \
  ws_step_dkey_kernel<G><<<grid, kThreads, 0, st>>>(                                       \
      static_cast<const float*>(logits), static_cast<const int32_t*>(x),                   \
      static_cast<const float*>(a), static_cast<const int64_t*>(key),                      \
      static_cast<int32_t*>(out), rows, vocab, temperature)
  WSFM_GROUPED_LAUNCH(lanes, vocab, rows, stream, WSFM_STEP);
#undef WSFM_STEP
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ws_step_rows_launch(const void* logits, const void* x, const void* a,
                                   const void* keys, void* out, int rows, int vocab, int group,
                                   float temperature, int lanes, void* stream) {
  if (rows <= 0 || vocab <= 0 || group <= 0 || rows % group != 0)
    return static_cast<int>(cudaErrorInvalidValue);
#define WSFM_ROWS(G, grid, st)                                                             \
  ws_step_rows_kernel<G><<<grid, kThreads, 0, st>>>(                                       \
      static_cast<const float*>(logits), static_cast<const int32_t*>(x),                   \
      static_cast<const float*>(a), static_cast<const int64_t*>(keys),                     \
      static_cast<int32_t*>(out), rows, vocab, group, temperature)
  WSFM_GROUPED_LAUNCH(lanes, vocab, rows, stream, WSFM_ROWS);
#undef WSFM_ROWS
  return static_cast<int>(cudaGetLastError());
}

// The noise given: gumbel (rows, vp), one weight a row.
extern "C" int ws_step_gumbel_launch(const void* logits, const void* x, const void* a,
                                     const void* gumbel, void* out, int rows, int vp,
                                     int valid_v, float temperature, int lanes, void* stream) {
  if (!gumbel_shape_ok(rows, vp, valid_v)) return static_cast<int>(cudaErrorInvalidValue);
#define WSFM_GIVEN(G, grid, st)                                                            \
  ws_step_gumbel_kernel<G, false><<<grid, kThreads, 0, st>>>(                              \
      static_cast<const float*>(logits), static_cast<const int32_t*>(x),                   \
      static_cast<const float*>(a), static_cast<const float*>(gumbel),                     \
      static_cast<int32_t*>(out), rows, vp, valid_v, 1, 0u, 0u, temperature)
  WSFM_GROUPED_LAUNCH(lanes, valid_v, rows, stream, WSFM_GIVEN);
#undef WSFM_GIVEN
  return static_cast<int>(cudaGetLastError());
}

// The noise keyed: jax.random.gumbel((k0, k1), (rows, vp)), drawn in the kernel; a
// weight for every a_group rows.
extern "C" int ws_step_gumbel_keyed_launch(const void* logits, const void* x, const void* a,
                                           uint32_t k0, uint32_t k1, void* out, int rows,
                                           int vp, int valid_v, int a_group, float temperature,
                                           int lanes, void* stream) {
  if (!gumbel_shape_ok(rows, vp, valid_v) || a_group <= 0 || rows % a_group != 0 ||
      static_cast<uint64_t>(rows) * static_cast<uint64_t>(vp) >= (uint64_t{1} << 32))
    return static_cast<int>(cudaErrorInvalidValue);
#define WSFM_KEYED(G, grid, st)                                                            \
  ws_step_gumbel_kernel<G, true><<<grid, kThreads, 0, st>>>(                               \
      static_cast<const float*>(logits), static_cast<const int32_t*>(x),                   \
      static_cast<const float*>(a), nullptr, static_cast<int32_t*>(out), rows, vp,         \
      valid_v, a_group, k0, k1, temperature)
  WSFM_GROUPED_LAUNCH(lanes, valid_v, rows, stream, WSFM_KEYED);
#undef WSFM_KEYED
  return static_cast<int>(cudaGetLastError());
}

// The key on the card: key (2,) int64, read by the kernel.
extern "C" int ws_step_gumbel_dkey_launch(const void* logits, const void* x, const void* a,
                                          const void* key, void* out, int rows, int vp,
                                          int valid_v, int a_group, float temperature,
                                          int lanes, void* stream) {
  if (!gumbel_shape_ok(rows, vp, valid_v) || a_group <= 0 || rows % a_group != 0 ||
      key == nullptr ||
      static_cast<uint64_t>(rows) * static_cast<uint64_t>(vp) >= (uint64_t{1} << 32))
    return static_cast<int>(cudaErrorInvalidValue);
#define WSFM_DKEY(G, grid, st)                                                             \
  ws_step_gumbel_dkey_kernel<G><<<grid, kThreads, 0, st>>>(                                \
      static_cast<const float*>(logits), static_cast<const int32_t*>(x),                   \
      static_cast<const float*>(a), static_cast<const int64_t*>(key),                      \
      static_cast<int32_t*>(out), rows, vp, valid_v, a_group, temperature)
  WSFM_GROUPED_LAUNCH(lanes, valid_v, rows, stream, WSFM_DKEY);
#undef WSFM_DKEY
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wsfm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
