// Warm-start Euler sampling step for Hopper (sm_90a).
//
// Replaces the TPU kernel ws_step_streamed_pallas / _ws_step_streamed_kernel
// (src/repro/kernels/ws_step/kernel.py). For each row r of logits (R, V):
//
//   lg          = logits[r] / temperature
//   g[v]        = gumbel(threefry2x32(seed, (r, v)).word0)
//   (m, s)      = online max and sum of exp(lg - m)
//   best, bidx  = max and first argmax of lg + g over v != x[r]
//   score_other = log(max(a, 1e-30)) + best - m - log s
//   score_x     = log(max((1 - a) + a * exp(lg[x] - m) / s, 1e-30)) + g[x]
//   out[r]      = score_x >= score_other ? x[r] : bidx
//
// which is the argmax over v of log((1 - a) onehot(x) + a softmax(lg)) + g,
// streamed so that the logits are the only (R, V) array read.
//
// Design. One warp per row; lane l visits columns l, l + 32, ... so each
// load instruction of the warp reads 32 consecutive floats, for any V
// (27, 50257, 262144) with no padding. Each lane keeps (m, s, best, bidx,
// lg_x, g_x) in registers; a butterfly of __shfl_xor_sync merges the lanes.
// Ties in best go to the lower column, as jnp.argmax's first occurrence
// and the TPU kernel's strict `tile_best > best` give. The noise is the
// TPU kernel's counter-based threefry path (its hardware PRNG has no
// counterpart), keyed by the absolute (row, col), so it does not depend on
// the launch shape. Build without --use_fast_math: logf must be the
// accurate one for the Gumbel noise to match the plain version.
//
// Bound on an H100 SXM: the bytes. It reads the logits once (R * V * 4
// bytes) plus 12 bytes a row; the arithmetic (a 20-round hash and two
// logs per element) is far below the card's integer and float rates at
// these sizes. On the main path (R = 32 * 256 = 8192, V = 27) that is
// 0.98 MB, about 0.3 us at 3.35 TB/s, so the launch itself dominates;
// this kernel does nothing about that (a CUDA graph of the refine loop is
// the tool, later).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kMinProb = 1e-30f;
constexpr float kNeg = -1e30f;
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

#define WSFM_ROUND(r)  \
  x0 += x1;            \
  x1 = rotl32(x1, r);  \
  x1 ^= x0;

// threefry-2x32, 20 rounds, JAX's parameterisation; returns word 0.
__device__ __forceinline__ uint32_t threefry2x32_w0(uint32_t k0, uint32_t k1,
                                                    uint32_t c0, uint32_t c1) {
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
  x0 += ks2;
  return x0;
}

#undef WSFM_ROUND

__device__ __forceinline__ float gumbel_from_bits(uint32_t bits) {
  const float u = (static_cast<float>(bits >> 8) + 0.5f) * (1.0f / 16777216.0f);
  return -logf(-logf(u));
}

__global__ void ws_step_kernel(const float* __restrict__ logits,
                               const int32_t* __restrict__ x,
                               const float* __restrict__ a,
                               int32_t* __restrict__ out, int rows, int vocab,
                               uint32_t seed0, uint32_t seed1, float temperature) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together

  const float* lrow = logits + static_cast<size_t>(row) * vocab;
  const int xr = x[row];
  float m = kNeg, s = 0.0f, best = kNeg, lg_x = 0.0f, g_x = 0.0f;
  int bidx = 0;
  for (int col = lane; col < vocab; col += 32) {
    const float lg = lrow[col] / temperature;
    const float g = gumbel_from_bits(
        threefry2x32_w0(seed0, seed1, static_cast<uint32_t>(row),
                        static_cast<uint32_t>(col)));
    const float m_new = fmaxf(m, lg);
    s = s * expf(m - m_new) + expf(lg - m_new);
    m = m_new;
    if (col == xr) {
      lg_x = lg;
      g_x = g;
    } else {
      const float cand = lg + g;
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
    s = s * expf(m - m_new) + s_o * expf(m_o - m_new);
    m = m_new;
    if (b_o > best || (b_o == best && i_o < bidx)) {
      best = b_o;
      bidx = i_o;
    }
    // exactly one lane saw column x; the others hold zeros
    lg_x += __shfl_xor_sync(0xffffffffu, lg_x, off);
    g_x += __shfl_xor_sync(0xffffffffu, g_x, off);
  }

  if (lane == 0) {
    const float ar = a[row];
    const float score_other = logf(fmaxf(ar, kMinProb)) + best - m - logf(s);
    const float p1x = expf(lg_x - m) / s;
    const float px = __fadd_rn(1.0f - ar, __fmul_rn(ar, p1x));
    const float score_x = logf(fmaxf(px, kMinProb)) + g_x;
    out[row] = score_x >= score_other ? xr : bidx;
  }
}

}  // namespace

extern "C" int ws_step_launch(const void* logits, const void* x, const void* a, void* out,
                              int rows, int vocab, uint32_t seed0, uint32_t seed1,
                              float temperature, void* stream) {
  if (rows <= 0 || vocab <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  ws_step_kernel<<<blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const int32_t*>(x),
      static_cast<const float*>(a), static_cast<int32_t*>(out), rows, vocab, seed0, seed1,
      temperature);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wsfm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
