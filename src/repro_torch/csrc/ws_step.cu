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
// ws_step_gumbel_kernel replaces the TPU kernel ws_step_pallas /
// _ws_step_kernel (same file): the Euler step with its Gumbel noise drawn
// beforehand into an (R, Vp) array (as jax.random.gumbel draws it in XLA for
// the JAX package's default step, euler_step_probs + categorical_from_probs),
// scored in probability space over the first valid_v columns:
//   x' = argmax_v log(max((1 - a) [v == x] + a softmax(lg / T)_v, 1e-30)) + g_v.
// That score is a different floating-point function from draw_row's streamed
// decomposition, so it has its own three passes (max, sum, score + argmax).
//
// Design of ws_step_kernel and ws_step_rows_kernel. G lanes draw a row (G a
// power of two chosen from V alone by lanes_for: 8 up to V = 128, 32 from V = 257
// on), so a warp draws 32 / G rows, through ws_common.cuh draw_row_grouped:
// draw_row's leaves and its xor merge tree, regrouped so that a lane computes
// 32 / G leaves side by side and merges the upper levels in registers, and the
// group's lanes the last log2(G) levels by shuffles. The tokens equal
// draw_row's bit for bit at every G, so they equal ws_fused.cu's, which runs
// draw_row K times. Any V (27, 50257, 262144) runs without padding. Build
// without --use_fast_math: logf must be the accurate one for the Gumbel noise
// to match the plain version. The C entry points take `lanes` (0: lanes_for)
// so that the tests can hold every G against G = 32.
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
// ws_step_gumbel reads the noise as well: 8 bytes an element, plus 12 a
// row, and about 20 operations an element (a division, expf, logf, the
// mixing and the compares), so the bytes bound it (0.56 us at R = 8192,
// V = 27); it too is launch-bound at that size.

#include "ws_common.cuh"

namespace {

// G lanes a row, 32 / G rows a warp. A warp past the last row leaves whole;
// in the last warp, lanes past the last row draw that row again (every lane
// must join the shuffles) and write nothing.
template <int G>
__global__ void __launch_bounds__(wsfm::kWarpsPerBlock * 32)
ws_step_kernel(const float* __restrict__ logits, const int32_t* __restrict__ x,
               const float* __restrict__ a, int32_t* __restrict__ out, int rows, int vocab,
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

// logits, gumbel: (rows, vp); x, a, out: (rows,). Columns >= valid_v are
// never read and never win (their score is -1e30 in the TPU kernel).
__global__ void ws_step_gumbel_kernel(const float* __restrict__ logits,
                                      const int32_t* __restrict__ x,
                                      const float* __restrict__ a,
                                      const float* __restrict__ gumbel,
                                      int32_t* __restrict__ out, int rows, int vp, int valid_v,
                                      float temperature) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * wsfm::kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const float* lg = logits + static_cast<size_t>(row) * vp;
  const float* g = gumbel + static_cast<size_t>(row) * vp;

  // pass 1: max of lg / T (a max is exact in any order)
  float m = wsfm::kNeg;
  for (int v = lane; v < valid_v; v += 32) m = fmaxf(m, lg[v] / temperature);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));

  // pass 2: s = sum of exp(lg / T - m); a xor butterfly leaves the same sum
  // in every lane (each pair adds the same two values)
  float s = 0.0f;
  for (int v = lane; v < valid_v; v += 32)
    s = __fadd_rn(s, expf(__fsub_rn(lg[v] / temperature, m)));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));

  // pass 3: the score and its first argmax; every rounding as the plain
  // version's separate operations take it (no contraction into an FMA)
  const int xr = x[row];
  const float ar = a[row];
  const float keep = __fsub_rn(1.0f, ar);
  float best = __int_as_float(static_cast<int>(0xff800000u));  // -inf
  int bidx = valid_v;
  for (int v = lane; v < valid_v; v += 32) {
    const float p1 = __fdiv_rn(expf(__fsub_rn(lg[v] / temperature, m)), s);
    const float probs = __fadd_rn(__fmul_rn(keep, v == xr ? 1.0f : 0.0f), __fmul_rn(ar, p1));
    const float score = __fadd_rn(logf(fmaxf(probs, wsfm::kMinProb)), g[v]);
    if (score > best) {  // strict: a lane's earlier column wins a tie
      best = score;
      bidx = v;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bidx, off);
    if (ob > best || (ob == best && oi < bidx)) {  // ties go to the lower column
      best = ob;
      bidx = oi;
    }
  }
  if (lane == 0) out[row] = bidx;
}

int blocks_for(int rows) { return (rows + wsfm::kWarpsPerBlock - 1) / wsfm::kWarpsPerBlock; }

// Lanes a row for a vocabulary of V columns: 8, doubled (to 32, draw_row's
// layout) while a lane would take more than kColsPerLane columns. Timed on an
// H100 at 8192 rows, 8 lanes beat 2, 4, 16 and 32 at V = 27, 64 and 100: fewer
// lanes leave too few warps to hide the hash's and the logs' latency, more
// spend the issue on merges.
constexpr int kColsPerLane = 16;

int lanes_for(int vocab) {
  int g = 8;
  while (g < 32 && g * kColsPerLane < vocab) g *= 2;
  return g;
}

bool admissible(int lanes) {
  return lanes == 2 || lanes == 4 || lanes == 8 || lanes == 16 || lanes == 32;
}

// Launch KERNEL<G> for the G that lanes names (0: lanes_for(vocab)) over rows
// rows, 32 / G a warp.
#define WSFM_LAUNCH_GROUPED(KERNEL, lanes, vocab, rows, stream, ...)                  \
  do {                                                                                \
    const int g_ = (lanes) == 0 ? lanes_for(vocab) : (lanes);                         \
    if (!admissible(g_)) return static_cast<int>(cudaErrorInvalidValue);              \
    const int blocks_ = blocks_for(((rows) + 32 / g_ - 1) / (32 / g_));                \
    const auto st_ = static_cast<cudaStream_t>(stream);                               \
    switch (g_) {                                                                     \
      case 2: KERNEL<2><<<blocks_, wsfm::kWarpsPerBlock * 32, 0, st_>>>(__VA_ARGS__); break;   \
      case 4: KERNEL<4><<<blocks_, wsfm::kWarpsPerBlock * 32, 0, st_>>>(__VA_ARGS__); break;   \
      case 8: KERNEL<8><<<blocks_, wsfm::kWarpsPerBlock * 32, 0, st_>>>(__VA_ARGS__); break;   \
      case 16: KERNEL<16><<<blocks_, wsfm::kWarpsPerBlock * 32, 0, st_>>>(__VA_ARGS__); break; \
      default: KERNEL<32><<<blocks_, wsfm::kWarpsPerBlock * 32, 0, st_>>>(__VA_ARGS__); break; \
    }                                                                                 \
  } while (0)

}  // namespace

extern "C" int ws_step_lanes(int vocab) { return vocab > 0 ? lanes_for(vocab) : 0; }

extern "C" int ws_step_launch(const void* logits, const void* x, const void* a, void* out,
                              int rows, int vocab, uint32_t seed0, uint32_t seed1,
                              float temperature, int lanes, void* stream) {
  if (rows <= 0 || vocab <= 0) return static_cast<int>(cudaErrorInvalidValue);
  WSFM_LAUNCH_GROUPED(ws_step_kernel, lanes, vocab, rows, stream,
                      static_cast<const float*>(logits), static_cast<const int32_t*>(x),
                      static_cast<const float*>(a), static_cast<int32_t*>(out), rows, vocab,
                      seed0, seed1, temperature);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ws_step_rows_launch(const void* logits, const void* x, const void* a,
                                   const void* keys, void* out, int rows, int vocab, int group,
                                   float temperature, int lanes, void* stream) {
  if (rows <= 0 || vocab <= 0 || group <= 0 || rows % group != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  WSFM_LAUNCH_GROUPED(ws_step_rows_kernel, lanes, vocab, rows, stream,
                      static_cast<const float*>(logits), static_cast<const int32_t*>(x),
                      static_cast<const float*>(a), static_cast<const int64_t*>(keys),
                      static_cast<int32_t*>(out), rows, vocab, group, temperature);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ws_step_gumbel_launch(const void* logits, const void* x, const void* a,
                                     const void* gumbel, void* out, int rows, int vp,
                                     int valid_v, float temperature, void* stream) {
  if (rows <= 0 || vp <= 0 || valid_v <= 0 || valid_v > vp)
    return static_cast<int>(cudaErrorInvalidValue);
  ws_step_gumbel_kernel<<<blocks_for(rows), wsfm::kWarpsPerBlock * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const int32_t*>(x),
      static_cast<const float*>(a), static_cast<const float*>(gumbel),
      static_cast<int32_t*>(out), rows, vp, valid_v, temperature);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wsfm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
