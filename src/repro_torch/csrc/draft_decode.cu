// Draft-transformer decode kernels (float32) for Hopper (sm_90a).
//
// Replace the TPU kernels of src/repro/kernels/draft_decode/kernel.py:
//   qkv_rope    qkv_rope_pallas    (_qkv_rope_kernel):  ln1 -> q/k/v (+bias) -> RoPE
//   attn_cached attn_cached_pallas (_attn_kernel):      one query token against the
//               row's whole T = max_len KV buffer, mask col <= pos && col < end,
//               direct softmax, (p @ v) / l
//   post_attn   post_attn_pallas   (_post_attn_kernel): wo (+bias) -> residual -> ln2 ->
//               up (gated or not; gelu/silu/relu) -> down (+bias) -> residual
//   head        head_pallas        (_head_kernel):      final norm -> vocab projection
// with the Pallas bodies' formulas: _norm_row's layernorm / rmsnorm (1 + scale),
// _rope_row's theta^(-j/half) frequencies, NEG_INF = -2.3819763e38, the division by l
// after p @ v, and query head h reading kv head h / (H / KH).
//
// The property that matters is batch invariance, the AR draft engine's contract:
// a batched prefill of S tokens must give the same bits as S one-token decode
// steps. On the TPU every token had its own grid program at fixed block shapes.
// Here every output element's reduction runs in one fixed order that depends only
// on the reduced length (D for the norms and q/k/v, H*hd for wo, F for down, T for
// attention), never on the number of rows R, the batch B or the chunk length S:
//   * one code path whatever R: the block shapes, the split of K and the order in
//     which the split is summed are constants; R only sets the grid size;
//   * no cuBLAS (its algorithm changes with M) and no atomics.
//
// qkv_rope (qkv_rope_kernel<hd>). Its bound at the decode shape is the 7.1 MB of
// weights it must read, 2.1 us at 3.35 TB/s; its 113 MFLOP take 1.7 us at the 67 TFLOP/s
// float32 rate of the CUDA cores, 0.7 us as 3xTF32 at the 495 TFLOP/s of the tensor
// cores. It replaced an 8-row kernel on the CUDA cores that read every weight four times
// at R = 32, normalised the same rows in each of its 144 blocks, walked K with 4-byte
// loads (16 in flight a warp) and met its 8 slices through shared memory. Now:
//   * a cluster of 8 blocks of 128 threads along grid x owns one head of q, k or v (hd
//     = 16, 32, 64 or 128 columns, whole RoPE pairs j, j + hd / 2) x 32 token rows:
//     (H + 2 KH) x 8 = 288
//     blocks at the decode shape, one wave, and every weight is read once for 32 rows.
//     Rows past R are zero-filled;
//   * rank s takes the s-th contiguous slice of D, 8 * ceil(D / 64) wide (a function of
//     D alone, whole k8 steps; the last may be short or empty). It copies its rows'
//     slice (32 x slice) and ln1's scale and bias over it into shared memory with
//     cp.async (16-byte copies when pointers and strides allow, else 4-byte), waits for
//     them, then starts its weight slab (slice x hd) as a second commit group, so that
//     the slab is in flight under the statistics (issued with the rows, it held the
//     rows back). A slab that does not fit at once streams through two buffers of a
//     fixed number of k rows (128, or 64 at hd = 128);
//   * ln1's statistics come from the ranks' slices: each rank takes its slice's mean and
//     centred sum of squares (rmsnorm: sum of squares) of every row, four lanes a row in
//     a fixed order; after a cluster barrier each rank combines the 8 slices' statistics
//     in rank order through distributed shared memory (layernorm: the mean from the
//     slices' counts and means, then the centred sum of squares as
//     sum_p M2_p + n_p (m_p - mean)^2), then normalises its own slice in place. No block
//     reads a whole row;
//   * the product runs on the tensor cores as 3xTF32 mma.sync.m16n8k8 (tf32_mma.cuh):
//     4 warps, each on both 16-row halves x hd / 32 n8 blocks (hd = 16: one half x one
//     n8 block), k8 steps in increasing k from the slice's start;
//   * the 8 partial tiles meet as in post_attn: rank s adds rows 4s .. 4s + 3 in rank
//     order 0 .. 7 through DSMEM, adds the bias, applies RoPE with a thread on each
//     pair, and stores q, or the k/v cache row at the cursor. The bias and the cursor
//     are loaded while the copies run, RoPE's sines and cosines computed while the
//     first cluster barrier completes, and the stores overlap the last barrier, which
//     keeps every block's shared memory alive until the last remote read.
// So every output's sum (statistics, slices, k8 steps, ranks) runs in an order that
// depends on D alone, and the mma adds the products of a k8 step the same way for every
// row. What holds it above its bound is the chain of phases a block runs one after the
// other (copy, statistics, cluster barrier, normalisation, products, barrier, combine):
// tools/qkv_rope_ablation.py times the kernel with each phase removed in turn.
//
// head (head_proj_kernel<rt, tied>). Its bound at the decode shape is the 191 KB it must
// move (83 KB of weights, the rows in and the logits out), 0.057 us at 3.35 TB/s; its
// 1.3 MFLOP take 0.02 us at 67 TFLOP/s. It replaced an 8-row kernel on a (ceil(V / 32),
// ceil(R / 8)) grid: 4 blocks at the decode shape on 132 SMs, one warp a row for the
// statistics, the rows staged with 4-byte loads into a transposed layout with 8-way bank
// conflicts, and 4-byte weight loads from device memory, 16 in flight a warp. Now:
//   * a block of 256 threads owns rt token rows x nt columns, (rt, nt) a function of
//     (D, V) alone (head_tiling): nt = 32 unless D x 32 floats exceed 112 KB; rt doubles
//     (to 8) while the grid at 32 rows still fills the 132 SMs. So the decode shape
//     (V = 27) launches 32 blocks of one row, and at V = 50257 a block takes 8 rows, so
//     the weight is read ceil(R / 8) times, by blocks that are neighbours along grid x
//     (the re-reads come from L2);
//   * the block copies its rows and the norm's scale and bias into shared memory with
//     cp.async (16-byte copies when the strides and the pointers allow), then its weight
//     slab, a second commit group: for a row-major w with V <= nt the slab is w itself,
//     one run of memory a K slice; for a tied head (the table transposed) the copy runs
//     along k, a row of the table a column;
//   * once the rows are in, all 256 threads take the rows' statistics, in an order that
//     depends on D alone (thread t takes k = 4t + 1024i, then the warps' butterflies, then
//     the 8 warps in order), and normalise them in place, rows contiguous, while the slab
//     is still arriving;
//   * then thread (q, n) sums the q-th slice of K (256 / nt slices, a multiple of 4 long)
//     for column n and each of the block's rows, one FMA chain a row in increasing k, on
//     the CUDA cores; the slices' sums meet in shared memory and are added in slice order.
// So every logit's sum depends on D and V alone, never on R or on the row's place in its
// tile. What holds it above its bound at the decode shape (tools/head_ablation.py): the
// launch, the slab's 83 KB into one SM (about 55 GB/s an SM with cp.async) and the
// products' 98 KB of shared-memory reads, one after the other. Tried and dropped, by
// their times on an H100: a cluster of 4 blocks splitting K (128 blocks, but its launch
// and two cluster barriers cost more than the quarter slab saved), the slab by one bulk
// copy a slice (the Tensor Memory Accelerator: no faster than cp.async with the rows
// copied first), 512 threads a block (slower).
//
// post_attn (post_attn_proj_kernel, one launch for each of wo + residual; ln2 + up/gate
// + act; down + residual, since ln2 needs the whole row after wo). Its bound at the
// decode shape is the 21.2 MB of weights it must read, 6.43 us at 3.35 TB/s (its 340
// MFLOP take 5.1 us at 67 TFLOP/s). It replaced three launches of an 8-row proj_kernel
// that read every weight four times at R = 32 (three from L2), kept 16 loads in flight
// a warp and gave wo and down 96 blocks for 132 SMs. Now:
//   * a cluster of 8 blocks along grid x splits K: rank s takes the s-th contiguous
//     slice, 4 * ceil(K / 32) wide (a function of K alone, 16-byte aligned); a slice
//     may be short or empty when K is small;
//   * a block owns 32 token rows x NT columns (wo: NT = 32, 24 x 8 = 192 blocks at the
//     decode shape; down: 64, 12 x 8 = 96 blocks, faster than 192 blocks of 32 when
//     timed on an H100; up: 128, 192 blocks; gated up: 64 up + 64 gate columns), so
//     every weight is read once for 32 rows. Rows past R and columns past N are
//     zero-filled;
//   * before its one wait the block copies its weight slab (slice x NT) and its rows'
//     slice (32 x slice) into shared memory with 16-byte cp.async.cg (4-byte copies
//     when a stride or a pointer is not 16-byte aligned): one commit, one wait. For
//     up, each block meanwhile computes its 32 rows' ln2 statistics over the whole
//     row from global memory (L2; two passes of 192 blocks x 96 KB = 38 MB of L2 reads
//     at the decode shape) in row_stats' order, then normalises its own slice;
//   * a thread owns 4 rows x 2 or 4 columns, each one FMA chain over the block's
//     slice in increasing k, from 0, all chains independent;
//   * the 8 partial tiles meet through distributed shared memory: after cluster.sync()
//     rank s finalises rows 4s .. 4s + 3 of the tile, adding the 8 ranks' partials in
//     rank order 0 .. 7, then the bias and the epilogue (residual; act, or act(gate) *
//     up); a second cluster.sync() keeps every block's shared memory alive until the
//     last remote read.
//   * a slice whose slab and rows do not fit in shared memory at once (at d_model 3072:
//     up's K = 3072 slice of 384 k rows x 128 columns needs 262 912 B, down's K = 12 288
//     slice 598 784 B, more than 232 448) streams through two buffers of post_stage(W)
//     k rows (64 at W = 128, else 128; 99.6 KB and 107.8 KB a block, two blocks an SM):
//     stage c + 1's slab and rows are copied while stage c is normalised (up) and
//     summed. Each thread's FMA chains run on across the stages in increasing k from 0,
//     so the staged path gives the bits of the whole-slice path at any K where both fit
//     (card test), and the engine's bitwise gates hold at d_model 3072. The whole-slice
//     path stays where it fits (every projection of the DiT's layer). The cluster is
//     not widened instead: 16 slices would change the order of every sum.
// So every output's sum runs in an order that depends on K only. A block's copy, its
// FMAs and its launch and cluster syncs run one after the other; waiting for the copy
// in stages along k did not overlap them (all of it is in flight at once). Left for
// later: ln2's statistics from the ranks' slices through DSMEM instead of from L2, a
// pipeline that throttles the copy so it overlaps the FMAs, the tensor cores (3xTF32,
// as qkv_rope), and programmatic dependent launch between the three projections.
//
// attn_cached. A block of 256 threads owns one (token row, query head). Warp w
// computes the scores of keys w, w + 8, ...: each lane takes hd/32 dims of q and k,
// then an xor-butterfly sums the lanes (hd = 16: 16 lanes a key, one dim each, two
// keys a warp at once, 2w and 2w + 1, then 2w + 16, ...). Every key's score is thus
// computed the same way whichever warp takes it. The max (exact in any order), then p = exp(s - m) in
// shared memory; then thread (slice, d) sums p[t] * v[t, d] and p[t] over the
// slice-th contiguous quarter (hd = 64) of the T keys in order, and the slice sums
// are added in slice order. All T = max_len keys are read whatever the position:
// masked keys contribute exp(NEG_INF - m) = 0, so S = 1 and S = P sum the same
// lanes in the same order.
//
// Cache. qkv_rope writes k and v straight into the layer's cache buffers
// (B, T, KH*hd) at the cursor read from the device (*cache_pos, clamped as
// dynamic_update_slice clamps), so the host never reads the cursor and no copy
// runs between the kernels. attn_cached reads end = *cache_pos + S.
//
// Bounds on an H100 SXM at the main path's decode shape (R = 32 rows, T = 271,
// dfm_dit CONFIG as the draft: D = 768, 12 heads of 64, F = 3072, V = 27):
//   qkv_rope 7.1 MB of weights, 113 MFLOP: 2.1 us at 3.35 TB/s (bytes);
//   attn_cached 53 MB of K/V, 27 MFLOP: 15.9 us (bytes);
//   post_attn 21.2 MB of weights, 340 MFLOP: 6.43 us (bytes);
//   head 191 KB (83 KB of weights), ~1.3 MFLOP: 0.057 us (bytes), launch-bound.
// attn_cached reads the whole KV buffer; nothing here does anything yet about the
// launch count (a CUDA graph of the decode step) or skipping masked keys. Build without
// --use_fast_math: expf, tanhf, powf, sinf and cosf are the accurate ones.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "tf32_mma.cuh"

namespace cg = cooperative_groups;

namespace {

using wsfm::cp_async16;
using wsfm::cp_async4;
using wsfm::cp_async_commit;
using wsfm::cp_async_wait;
using wsfm::mma_3xtf32;
using wsfm::split;

constexpr int kMaxSmem = 232448;       // an H100 block's dynamic shared memory limit
constexpr float kNegInf = -2.3819763e38f;

enum Norm { kLayerNorm = 0, kRmsNorm = 1 };
enum Act { kGelu = 0, kSilu = 1, kRelu = 2 };
enum Epi { kEpiResid = 0, kEpiAct = 1 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float activate(int act, float x) {
  if (act == kGelu) {  // jax.nn.gelu(approximate=True)
    const float inner = 0.7978845608028654f * (x + 0.044715f * (x * x * x));
    return x * (0.5f * (1.0f + tanhf(inner)));
  }
  if (act == kSilu) return x / (1.0f + expf(-x));
  return fmaxf(x, 0.0f);
}

// -- head ------------------------------------------------------------------------------

constexpr int kHeadThreads = 256;
constexpr int kHeadMaxRows = 8;        // token rows a block may own
constexpr int kHeadSlabBytes = 114688; // NT halves (to 4) until D x NT floats fit in this
constexpr int kCardSms = 132;          // H100 SXM: the grid the tiling aims to fill
constexpr int kRefRows = 32;           // at this many rows (the decode batch)

// The smallest value >= v that is congruent to r modulo 32.
constexpr int up_to_mod32(int v, int r) { return v + ((r - v % 32) % 32 + 32) % 32; }

// A head block's tiling, a function of (D, V) alone: rt token rows x nt columns; 256
// threads, thread t on column t % nt and K slice t / nt (s = 256 / nt slices of sl, a
// multiple of 4, the last short or empty). Shared memory holds the weight slab in
// either layout (slab floats, the larger of the two), the block's rows normalised
// (rt x ldx, ldx = s * sl, zero past D), the norm's scale and bias (2 x ldx) and the
// partial sums (s x rt x nt).
//   row-major w (strides (V, 1)): slice q's rows at q * sst, row kk of it at kk * ldw;
//     ldw = V when V <= nt (one column tile: a slice of the slab is one run of w),
//     else nt. sst = nt (mod 32) for nt < 32, so the 32 / nt slices a warp reads fall
//     in distinct banks;
//   tied (strides (1, D)): column n at n * ld, along k; ld = 4 (mod 32), so the
//     float4 reads of 8 columns (a quarter warp) fall in distinct banks.
struct HeadTiling {
  int rt, nt, s, sl, ldx, ldw, sst, ld, slab;
  size_t smem;
};

HeadTiling head_tiling(int D, int V) {
  HeadTiling t{};
  t.nt = 32;
  while (t.nt > 4 && static_cast<long>(D) * t.nt * 4 > kHeadSlabBytes) t.nt /= 2;
  t.s = kHeadThreads / t.nt;
  t.sl = 4 * ((D + 4 * t.s - 1) / (4 * t.s));
  t.ldx = t.s * t.sl;
  t.ldw = V <= t.nt ? V : t.nt;
  t.sst = up_to_mod32(t.sl * t.ldw, t.nt % 32);
  t.ld = up_to_mod32(t.ldx, 4);
  t.slab = std::max(t.s * t.sst, t.nt * t.ld);
  // rows double while the grid at kRefRows rows still fills the card; fewer when the
  // shared memory does not take them
  const int tiles = (V + t.nt - 1) / t.nt;
  t.rt = 1;
  while (t.rt < kHeadMaxRows && tiles * ((kRefRows + 2 * t.rt - 1) / (2 * t.rt)) >= kCardSms)
    t.rt *= 2;
  auto smem = [&](int rt) {
    return (static_cast<size_t>(t.slab) + static_cast<size_t>(rt + 2) * t.ldx +
            static_cast<size_t>(t.s) * rt * t.nt) * sizeof(float);
  };
  while (t.rt > 1 && smem(t.rt) > kMaxSmem) t.rt /= 2;
  t.smem = smem(t.rt);
  return t;
}

struct HeadArgs {
  const float* x;         // (R, D)
  const float* ln_scale;  // the final norm
  const float* ln_bias;   // or null
  const float* w;         // (D, V): row-major, or the (V, D) table transposed (tied)
  float* out;             // (R, V)
  int R, D, V, norm;
  float eps;
  HeadTiling t;
  int vec;                // 16-byte copies of the slab
  int xvec;               // 16-byte copies of the rows and the norm's parameters
};

__device__ __forceinline__ void cp_async(float* dst, const float* src, bool ok, bool vec) {
  if (vec) {
    cp_async16(dst, src, ok);
  } else {
    cp_async4(dst, src, ok);
  }
}

// Final norm -> vocab projection for rt token rows x nt columns (see the note on top).
template <int RT, bool TIED>
__global__ void __launch_bounds__(kHeadThreads, 1) head_proj_kernel(HeadArgs a) {
  extern __shared__ float4 smem4[];
  const HeadTiling t = a.t;
  float* ws = reinterpret_cast<float*>(smem4);
  float* xs = ws + t.slab;
  float* ps = xs + RT * t.ldx;        // the norm's scale, then its bias
  float* red = ps + 2 * t.ldx;
  const int tid = threadIdx.x;
  const int r0 = static_cast<int>(blockIdx.x) * RT;
  const int n0 = static_cast<int>(blockIdx.y) * t.nt;
  const bool ln = a.norm == kLayerNorm;

  // 1. the copies, zeros past D, R and V: the rows and the norm's parameters (the first
  // commit group, waited for first), then the weight slab (the second, waited for after
  // the normalisation). Each loop walks runs of memory with a thread stride, so a copy
  // costs no division.
  {
    const bool vec = a.xvec != 0;
    const int step = vec ? 4 : 1;
    for (int r = 0; r < RT + 2; ++r) {
      const float* src = r < RT ? a.x + static_cast<size_t>(r0 + r) * a.D
                                : r == RT ? a.ln_scale : a.ln_bias;
      const int len = (r < RT ? r0 + r < a.R : r == RT || ln) ? a.D : 0;
      for (int k = step * tid; k < t.ldx; k += step * kHeadThreads)
        cp_async(xs + r * t.ldx + k, k < len ? src + k : a.x, k < len, vec);
    }
  }
  cp_async_commit();
  const bool vec = a.vec != 0;
  const int step = vec ? 4 : 1;
  if (TIED) {          // column n is row n0 + n of the table
    for (int n = 0; n < t.nt; ++n) {
      const int len = n0 + n < a.V ? a.D : 0;
      const float* src = a.w + static_cast<size_t>(n0 + n) * a.D;
      for (int k = step * tid; k < t.ldx; k += step * kHeadThreads)
        cp_async(ws + n * t.ld + k, k < len ? src + k : a.w, k < len, vec);
    }
  } else if (a.V <= t.nt) {   // slice q's rows are one run of sl * V floats of w
    const int run = t.sl * a.V;
    for (int q = 0; q < t.s; ++q) {
      const int len = min(run, max(0, a.D * a.V - q * run));
      const float* src = a.w + static_cast<size_t>(q) * run;
      for (int c = step * tid; c < run; c += step * kHeadThreads)
        cp_async(ws + q * t.sst + c, c < len ? src + c : a.w, c < len, vec);
    }
  } else {             // rows of nt columns at stride V; nt / step is a power of two
    const int per = t.nt / step, shift = __ffs(per) - 1;
    for (int q = 0; q < t.s; ++q) {
      for (int i = tid; i < t.sl * per; i += kHeadThreads) {
        const int kk = i >> shift, n = step * (i & (per - 1)), k = q * t.sl + kk;
        const bool ok = k < a.D && n0 + n < a.V;
        cp_async(ws + q * t.sst + kk * t.nt + n,
                 ok ? a.w + static_cast<size_t>(k) * a.V + n0 + n : a.w, ok, vec);
      }
    }
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // 2. the rows' statistics, by all the block's threads: thread t takes k = 4t + 1024i .. 4t + 1024i + 3 of each row in
  // increasing i, the xor butterfly adds a warp's lanes, and the 8 warps' sums are
  // added in warp order (through red, free until the products): an order that depends
  // on D alone. Then each thread normalises its own elements in place. Rows past R
  // stay zeros.
  const int warp = tid / 32, lane = tid % 32;
  constexpr int kWarps = kHeadThreads / 32;
  float mu[RT], inv[RT];
  {
    float acc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      acc[r] = 0.f;
      for (int k = 4 * tid; k < t.ldx; k += 4 * kHeadThreads) {
        const float4 v = *reinterpret_cast<const float4*>(xs + r * t.ldx + k);
        acc[r] += ln ? v.x : v.x * v.x;
        acc[r] += ln ? v.y : v.y * v.y;
        acc[r] += ln ? v.z : v.z * v.z;
        acc[r] += ln ? v.w : v.w * v.w;
      }
      acc[r] = warp_sum(acc[r]);
      if (lane == 0) red[warp * RT + r] = acc[r];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      float sum = red[r];
      for (int w = 1; w < kWarps; ++w) sum += red[w * RT + r];
      mu[r] = ln ? sum / a.D : 0.f;
      inv[r] = sum / a.D;   // rmsnorm's variance
    }
    if (ln) {
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        acc[r] = 0.f;
        auto sq = [&](float e, int k) { return k < a.D ? (e - mu[r]) * (e - mu[r]) : 0.f; };
        for (int k = 4 * tid; k < t.ldx; k += 4 * kHeadThreads) {
          const float4 v = *reinterpret_cast<const float4*>(xs + r * t.ldx + k);
          acc[r] += sq(v.x, k);
          acc[r] += sq(v.y, k + 1);
          acc[r] += sq(v.z, k + 2);
          acc[r] += sq(v.w, k + 3);
        }
        acc[r] = warp_sum(acc[r]);
        if (lane == 0) red[(kWarps + warp) * RT + r] = acc[r];
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        float sum = red[kWarps * RT + r];
        for (int w = 1; w < kWarps; ++w) sum += red[(kWarps + w) * RT + r];
        inv[r] = sum / a.D;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    inv[r] = rsqrtf(inv[r] + a.eps);
    if (r0 + r >= a.R) continue;
    auto normed = [&](float e, int k) {
      if (k >= a.D) return e;
      const float y = (e - mu[r]) * inv[r];
      return ln ? y * ps[k] + ps[t.ldx + k] : y * (1.0f + ps[k]);
    };
    for (int k = 4 * tid; k < t.ldx; k += 4 * kHeadThreads) {
      float* xr = xs + r * t.ldx + k;
      const float4 v = *reinterpret_cast<const float4*>(xr);
      *reinterpret_cast<float4*>(xr) = make_float4(normed(v.x, k), normed(v.y, k + 1),
                                                   normed(v.z, k + 2), normed(v.w, k + 3));
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // 3. thread (q, n) sums slice q of K for column n and each of the block's rows: one
  // FMA chain a row, in increasing k from the slice's start
  const int n = tid % t.nt, q = tid / t.nt;
  const int k0 = q * t.sl;
  const int len4 = (min(t.sl, max(0, a.D - k0)) + 3) & ~3;
  float acc[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) acc[r] = 0.f;
  const float* xk = xs + k0;
  if (TIED) {
    const float* wk = ws + n * t.ld + k0;
#pragma unroll 4
    for (int kk = 0; kk < len4; kk += 4) {
      const float4 w4 = *reinterpret_cast<const float4*>(wk + kk);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float4 x4 = *reinterpret_cast<const float4*>(xk + r * t.ldx + kk);
        acc[r] = fmaf(x4.x, w4.x, acc[r]);
        acc[r] = fmaf(x4.y, w4.y, acc[r]);
        acc[r] = fmaf(x4.z, w4.z, acc[r]);
        acc[r] = fmaf(x4.w, w4.w, acc[r]);
      }
    }
  } else {
    const float* wk = ws + q * t.sst + n;
    const int ldw = t.ldw;
#pragma unroll 4
    for (int kk = 0; kk < len4; kk += 4) {
      const float w0 = wk[kk * ldw], w1 = wk[(kk + 1) * ldw];
      const float w2 = wk[(kk + 2) * ldw], w3 = wk[(kk + 3) * ldw];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float4 x4 = *reinterpret_cast<const float4*>(xk + r * t.ldx + kk);
        acc[r] = fmaf(x4.x, w0, acc[r]);
        acc[r] = fmaf(x4.y, w1, acc[r]);
        acc[r] = fmaf(x4.z, w2, acc[r]);
        acc[r] = fmaf(x4.w, w3, acc[r]);
      }
    }
  }

  // 4. the slices' sums meet in red and are added in slice order
#pragma unroll
  for (int r = 0; r < RT; ++r) red[(q * RT + r) * t.nt + n] = acc[r];
  __syncthreads();
  for (int i = tid; i < RT * t.nt; i += kHeadThreads) {
    const int r = i / t.nt, c = i % t.nt;
    float y = red[i];
    for (int p = 1; p < t.s; ++p) y += red[p * RT * t.nt + i];
    if (r0 + r < a.R && n0 + c < a.V) a.out[static_cast<size_t>(r0 + r) * a.V + n0 + c] = y;
  }
}

template <int RT, bool TIED>
int launch_head(const HeadArgs& a, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      head_proj_kernel<RT, TIED>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((a.R + RT - 1) / RT, (a.V + a.t.nt - 1) / a.t.nt);
  head_proj_kernel<RT, TIED><<<grid, kHeadThreads, a.t.smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool TIED>
int launch_head_rows(const HeadArgs& a, cudaStream_t stream) {
  switch (a.t.rt) {
    case 1: return launch_head<1, TIED>(a, stream);
    case 2: return launch_head<2, TIED>(a, stream);
    case 4: return launch_head<4, TIED>(a, stream);
    default: return launch_head<8, TIED>(a, stream);
  }
}

// -- post_attn ---------------------------------------------------------------------------

constexpr int kCluster = 8;    // blocks of a cluster along grid x, one slice of K each
constexpr int kRowTile = 32;   // token rows of a post_attn block
static_assert(kRowTile == 4 * kCluster, "rank s finalises rows 4s .. 4s + 3");

// One rank's slice of K: a function of K alone, a multiple of 4 floats.
__host__ __device__ constexpr int post_slice(int K) { return 4 * ((K + 31) / 32); }

// Shared floats of a post_attn block: the weight slab (slice, W), the rows' slice
// (32, slice + 4), the partial tile (32, W), the rows' mean and 1 / std (2 x 32).
__host__ __device__ constexpr int post_smem_floats(int slice, int W) {
  return slice * W + kRowTile * (slice + 4) + kRowTile * W + 2 * kRowTile;
}

// The staged path (a slice whose slab and rows do not fit at once): k rows of a stage,
// 32 KB of weight slab at W >= 64.
__host__ __device__ constexpr int post_stage(int W) { return W >= 128 ? 64 : 128; }

// Shared floats of a staged block: two buffers of a stage's slab (stage, W) and rows
// (32, stage + 4), the partial tile, the rows' mean and 1 / std. A function of W alone.
__host__ __device__ constexpr int post_staged_floats(int W) {
  return 2 * (post_stage(W) * W + kRowTile * (post_stage(W) + 4)) + kRowTile * W +
         2 * kRowTile;
}

// Start copying the (rows, cols) tile at src (row stride lds) into dst (row stride ldd);
// elements at or past (nr, nc) are zero-filled (their copy reads base, a valid address).
// cols is a multiple of 4. vec: 16-byte copies, for lds, ldd, src and dst 16-byte aligned.
template <int THREADS>
__device__ __forceinline__ void copy_tile(float* dst, int ldd, const float* src, size_t lds,
                                          int rows, int cols, int nr, int nc,
                                          const float* base, bool vec) {
  const int step = vec ? 4 : 1, per = cols / step;
  for (int i = threadIdx.x; i < rows * per; i += THREADS) {
    const int r = i / per, c = step * (i % per);
    const bool ok = r < nr && c < nc;
    const float* s = ok ? src + r * lds + c : base;
    if (vec) {
      cp_async16(dst + r * ldd + c, s, ok);
    } else {
      cp_async4(dst + r * ldd + c, s, ok);
    }
  }
}

struct PostArgs {
  const float* in;        // (R, K)
  const float* ln_scale;  // ln2 of the input rows (up), or null
  const float* ln_bias;
  const float* w[2];      // (K, N) row-major; w[1]: the gate, or null
  const float* b[2];      // biases or null
  const float* resid;     // (R, N) for kEpiResid
  float* out;             // (R, N)
  int R, K, N, norm, act, vec;
  float eps;
};

// ln2's mean and 1 / std of the block's rows over the whole row (K), from global memory
// (L2), each row in a fixed order: lane-strided sums in increasing k, the xor
// butterfly, and a centred second pass for layernorm. A warp takes RPW rows at once so
// that RPW independent loads a lane are in flight.
template <int THREADS>
__device__ __forceinline__ void row_stats(const PostArgs& a, int r0, float* mu, float* inv) {
  constexpr int RPW = kRowTile / (THREADS / 32);
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool ln = a.norm == kLayerNorm;
  const float* row[RPW];
#pragma unroll
  for (int j = 0; j < RPW; ++j)   // rows past R read row R - 1; their results are unused
    row[j] = a.in + static_cast<size_t>(min(r0 + w + j * (THREADS / 32), a.R - 1)) * a.K;
  float s[RPW], m[RPW];
#pragma unroll
  for (int j = 0; j < RPW; ++j) s[j] = 0.f;
#pragma unroll 4
  for (int k = lane; k < a.K; k += 32)
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      const float v = row[j][k];
      s[j] += ln ? v : v * v;
    }
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    s[j] = warp_sum(s[j]);
    m[j] = ln ? s[j] / a.K : 0.f;
  }
  if (ln) {
#pragma unroll
    for (int j = 0; j < RPW; ++j) s[j] = 0.f;
#pragma unroll 4
    for (int k = lane; k < a.K; k += 32)
#pragma unroll
      for (int j = 0; j < RPW; ++j) {
        const float d = row[j][k] - m[j];
        s[j] += d * d;
      }
#pragma unroll
    for (int j = 0; j < RPW; ++j) s[j] = warp_sum(s[j]);
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      const int t = w + j * (THREADS / 32);
      mu[t] = m[j];
      inv[t] = rsqrtf(s[j] / a.K + a.eps);
    }
  }
}

// ln2 applied in place to rows t < nr, columns k < len of a (32, ld) tile of rows whose
// column k is column kb + k of the row: the same formula element by element on either path.
__device__ __forceinline__ void normalise_rows(const PostArgs& a, float* xs, int ld, int nr,
                                               int len, int kb, const float* mu,
                                               const float* inv, int threads) {
  for (int i = threadIdx.x; i < nr * len; i += threads) {
    const int t = i / len, k = i % len;
    float* p = xs + t * ld + k;
    const float y = (*p - mu[t]) * inv[t];
    *p = a.norm == kLayerNorm ? y * a.ln_scale[kb + k] + a.ln_bias[kb + k]
                              : y * (1.0f + a.ln_scale[kb + k]);
  }
}

// acc[i][j] += x[row0 + 4 i][k] * w[k][col0 + j] for k = 0 .. n - 1 in increasing k, one
// FMA chain each: xp points at row row0 (row stride xld), wp at column col0 (row stride W).
template <int TC, int W>
__device__ __forceinline__ void fma_slab(float (&acc)[4][TC], const float* xp, int xld,
                                         const float* wp, int n) {
#pragma unroll 2
  for (int k = 0; k < n; k += 4) {
    float x[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(xp + 4 * i * xld + k);
      x[i][0] = v.x;
      x[i][1] = v.y;
      x[i][2] = v.z;
      x[i][3] = v.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float wv[TC];
      if constexpr (TC == 4) {
        const float4 v = *reinterpret_cast<const float4*>(wp + (k + kk) * W);
        wv[0] = v.x;
        wv[1] = v.y;
        wv[2] = v.z;
        wv[3] = v.w;
      } else {
        const float2 v = *reinterpret_cast<const float2*>(wp + (k + kk) * W);
        wv[0] = v.x;
        wv[1] = v.y;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) acc[i][j] = fmaf(x[i][kk], wv[j], acc[i][j]);
    }
  }
}

// One projection of post_attn: out = epilogue(in @ w + b) for a 32-row x NT-column tile
// per cluster of 8 blocks, each block summing one slice of K (see the note on top).
// STAGED: the slice's slab and rows stream through two buffers of post_stage(W) k rows
// (for a slice that does not fit in shared memory at once); each thread's FMA chains run
// on across the stages in increasing k from 0, so both paths give the same bits.
template <int NT, int NC, int THREADS, int EPI, bool STAGED>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(THREADS)
post_attn_proj_kernel(PostArgs a) {
  constexpr int W = NT * NC;              // slab columns: NT of w[0], then NT of w[1]
  constexpr int TC = 8 * W / THREADS;     // columns a thread owns, beside 4 rows
  constexpr int CH = post_stage(W), CLD = CH + 4;   // the staged path's stage, row stride
  static_assert((TC == 2 || TC == 4) && NT % TC == 0 && 4 * NT % THREADS == 0,
                "a thread owns 4 rows x TC columns of one weight and whole output rows");
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int slice = post_slice(a.K), xsld = slice + 4;
  float* ws = reinterpret_cast<float*>(smem4);   // staged: 2 x (CH, W) slabs, 2 x (32, CLD) rows
  float* xs = ws + (STAGED ? 2 * CH * W : slice * W);
  float* part = xs + kRowTile * (STAGED ? 2 * CLD : xsld);
  float* mu = part + kRowTile * W;
  float* inv = mu + kRowTile;
  const int n0 = static_cast<int>(blockIdx.x) / kCluster * NT;
  const int r0 = static_cast<int>(blockIdx.y) * kRowTile;
  const int k0 = rank * slice;
  const int len = max(0, min(a.K, k0 + slice) - k0);
  const int len4 = (len + 3) & ~3;
  const int nr = min(kRowTile, a.R - r0);
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const bool vec = a.vec != 0;

  // rows row0 + 4 i (i < 4) x slab columns col0 .. col0 + TC - 1; a warp covers 16
  // rows x 8 column groups, so its x and w reads are one 64- and one TC * 32-byte run
  const int row0 = (w % 2) * 16 + lane / 8;
  const int col0 = (w / 2 * 8 + lane % 8) * TC;
  float acc[4][TC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;

  if constexpr (!STAGED) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
      copy_tile<THREADS>(ws + c * NT, W, a.w[c] + static_cast<size_t>(k0) * a.N + n0, a.N,
                         len4, NT, a.K - k0, a.N - n0, a.w[c], vec);
    copy_tile<THREADS>(xs, xsld, a.in + static_cast<size_t>(r0) * a.K + k0, a.K, kRowTile,
                       len4, a.R - r0, a.K - k0, a.in, vec);
    cp_async_commit();
    if (a.ln_scale != nullptr) row_stats<THREADS>(a, r0, mu, inv);   // while the copy runs

    cp_async_wait<0>();
    __syncthreads();
    if (a.ln_scale != nullptr) {
      normalise_rows(a, xs, xsld, nr, len, k0, mu, inv, THREADS);
      __syncthreads();
    }
    fma_slab<TC, W>(acc, xs + row0 * xsld, xsld, ws + col0, len4);
  } else {
    // stage c: k rows k0 + c CH .. of the slab and of the rows, into buffer c & 1
    const int nst = (len4 + CH - 1) / CH;
    auto copy_stage = [&](int c) {
      const int kc = k0 + c * CH, kn = min(CH, len4 - c * CH);
      float* wb = ws + (c & 1) * CH * W;
#pragma unroll
      for (int h = 0; h < NC; ++h)
        copy_tile<THREADS>(wb + h * NT, W, a.w[h] + static_cast<size_t>(kc) * a.N + n0, a.N,
                           kn, NT, a.K - kc, a.N - n0, a.w[h], vec);
      copy_tile<THREADS>(xs + (c & 1) * kRowTile * CLD, CLD,
                         a.in + static_cast<size_t>(r0) * a.K + kc, a.K, kRowTile, kn,
                         a.R - r0, a.K - kc, a.in, vec);
    };
    if (nst > 0) copy_stage(0);
    cp_async_commit();
    if (a.ln_scale != nullptr) row_stats<THREADS>(a, r0, mu, inv);   // while stage 0 lands
    for (int c = 0; c < nst; ++c) {
      if (c + 1 < nst) {
        copy_stage(c + 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();   // stage c (and the statistics) are visible to every thread
      float* xb = xs + (c & 1) * kRowTile * CLD;
      if (a.ln_scale != nullptr) {
        normalise_rows(a, xb, CLD, nr, min(CH, len - c * CH), k0 + c * CH, mu, inv, THREADS);
        __syncthreads();
      }
      fma_slab<TC, W>(acc, xb + row0 * CLD, CLD, ws + (c & 1) * CH * W + col0,
                      min(CH, len4 - c * CH));
      __syncthreads();   // the next copy overwrites this buffer
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) part[(row0 + 4 * i) * W + col0 + j] = acc[i][j];
  cluster.sync();

  const float* rp[kCluster];
#pragma unroll
  for (int q = 0; q < kCluster; ++q) rp[q] = cluster.map_shared_rank(part, q);
  for (int o = tid; o < 4 * NT; o += THREADS) {
    const int t = 4 * rank + o / NT, c = o % NT;
    float y[NC];
#pragma unroll
    for (int h = 0; h < NC; ++h) {
      const int at = t * W + h * NT + c;
      float s = rp[0][at];
#pragma unroll
      for (int q = 1; q < kCluster; ++q) s += rp[q][at];
      y[h] = s;
    }
    const int r = r0 + t, n = n0 + c;
    if (r >= a.R || n >= a.N) continue;
#pragma unroll
    for (int h = 0; h < NC; ++h)
      if (a.b[h] != nullptr) y[h] += a.b[h][n];
    const size_t at = static_cast<size_t>(r) * a.N + n;
    if (EPI == kEpiResid) {
      a.out[at] = a.resid[at] + y[0];
    } else {
      a.out[at] = NC == 2 ? activate(a.act, y[1]) * y[0] : activate(a.act, y[0]);
    }
  }
  cluster.sync();   // no block leaves while another may still read its partials
}

template <int NT, int NC, int THREADS, int EPI, bool STAGED>
int launch_post_path(const PostArgs& a, size_t smem, cudaStream_t stream) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(post_attn_proj_kernel<NT, NC, THREADS, EPI, STAGED>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((a.N + NT - 1) / NT * kCluster, (a.R + kRowTile - 1) / kRowTile);
  post_attn_proj_kernel<NT, NC, THREADS, EPI, STAGED><<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The whole slice at once where it fits (staged = 0), else (or with staged = 1) in stages.
template <int NT, int NC, int THREADS, int EPI>
int launch_post(const PostArgs& a, int staged, cudaStream_t stream) {
  const size_t whole = post_smem_floats(post_slice(a.K), NT * NC) * sizeof(float);
  if (staged == 0 && whole <= kMaxSmem)
    return launch_post_path<NT, NC, THREADS, EPI, false>(a, whole, stream);
  const size_t smem = post_staged_floats(NT * NC) * sizeof(float);
  static_assert(post_staged_floats(NT * NC) * sizeof(float) <= kMaxSmem, "a stage must fit");
  return launch_post_path<NT, NC, THREADS, EPI, true>(a, smem, stream);
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// -- qkv_rope ---------------------------------------------------------------------

struct QkvArgs {
  const float* x;
  const float* ln_scale;
  const float* ln_bias;
  const float* w[3];   // wq (D, H*hd), wk, wv (D, KH*hd)
  const float* b[3];   // biases or null
  float* q;            // (R, H*hd)
  float* cache[2];     // k, v buffers (B, T, KH*hd)
  const int* cache_pos;
  int R, S, T, D, H, KH, pos0, norm, use_rope, vec;
  float eps, theta;
};

constexpr int kQkvThreads = 128;   // 4 warps, each on HD / 32 of the tile's n8 blocks

// One rank's slice of D: a function of D alone, a multiple of 8 (the k8 steps).
__host__ __device__ constexpr int qkv_slice(int D) { return 8 * ((D + 63) / 64); }

template <int HD>
struct QkvTile {
  static constexpr int kWld = HD + 8;                 // slab row: B fragments hit 32 banks
  static constexpr int kChunk = HD <= 64 ? 128 : 64;  // k rows of a stage, if the slab is staged
  // a warp's share of the (2 x 16 rows) x (HD / 8 n8 blocks) tile: both 16-row halves x
  // HD / 32 n8 blocks, or at HD = 16 one half x one n8 block
  static constexpr int kMt = HD >= 32 ? 2 : 1;        // 16-row halves of a warp
  static constexpr int kNt = HD >= 32 ? HD / 32 : 1;  // n8 blocks of a warp
  static_assert(HD == 16 || HD % 32 == 0, "head_dim 16 or a multiple of 32");
  // rows of the slab's buffer: the whole slice, or two stages
  static __host__ __device__ constexpr int slab_rows(int slice) {
    return slice <= kChunk ? slice : 2 * kChunk;
  }
  // shared floats: the rows' slice (32, slice + 4), ln1's scale and bias over the
  // slice (2, slice), the slab, the partial tile (32, kWld), the rows' statistics over
  // the slice (2 x 32)
  static __host__ __device__ constexpr int smem_floats(int D) {
    return (kRowTile + 2) * qkv_slice(D) + 4 * kRowTile +
           (slab_rows(qkv_slice(D)) + kRowTile) * kWld + 2 * kRowTile;
  }
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// ln1 -> q/k/v (+bias) -> RoPE for a 32-row x one-head tile per cluster of 8 blocks,
// rank s summing the s-th slice of D (see the note on top).
template <int HD>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kQkvThreads)
qkv_rope_kernel(QkvArgs a) {
  using Tile = QkvTile<HD>;
  constexpr int WLD = Tile::kWld, CH = Tile::kChunk, MT = Tile::kMt, NT = Tile::kNt;
  constexpr int HALF = HD / 2;
  constexpr int kLanes = kQkvThreads / kRowTile;   // lanes on a row's statistics
  constexpr int kPairs = (4 * HALF + kQkvThreads - 1) / kQkvThreads;   // a thread's pairs
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int slice = qkv_slice(a.D), xld = slice + 4;
  float* xs = reinterpret_cast<float*>(smem4);
  float* lns = xs + kRowTile * xld;    // ln1's scale, then its bias, over the slice
  float* ws = lns + 2 * slice;
  float* part = ws + Tile::slab_rows(slice) * WLD;
  float* stats = part + kRowTile * WLD;
  const int head = static_cast<int>(blockIdx.x) / kCluster;   // of H + 2 KH: q, k, v
  const int sec = head < a.H ? 0 : (head < a.H + a.KH ? 1 : 2);
  const int lh = head - (sec == 0 ? 0 : (sec == 1 ? a.H : a.H + a.KH));
  const int ncols = (sec == 0 ? a.H : a.KH) * HD;
  const int r0 = static_cast<int>(blockIdx.y) * kRowTile;
  const int k0 = rank * slice;
  const int len = max(0, min(a.D, k0 + slice) - k0);
  const int len8 = (len + 7) & ~7;
  const int nch = (len8 + CH - 1) / CH;
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const bool vec = a.vec != 0, ln = a.norm == kLayerNorm;
  const float* wsrc = a.w[sec] + static_cast<size_t>(k0) * ncols + lh * HD;
  auto copy_chunk = [&](int c) {
    copy_tile<kQkvThreads>(ws + (c & 1) * CH * WLD, WLD,
                           wsrc + static_cast<size_t>(c) * CH * ncols, ncols,
                           min(CH, len8 - c * CH), HD, a.D - k0 - c * CH, HD, a.w[sec], vec);
  };

  copy_tile<kQkvThreads>(xs, xld, a.x + static_cast<size_t>(r0) * a.D + k0, a.D, kRowTile, len8,
                         a.R - r0, a.D - k0, a.x, vec);
  copy_tile<kQkvThreads>(lns, slice, a.ln_scale + k0, 0, 1, len8, 1, a.D - k0, a.ln_scale, vec);
  if (ln) {
    copy_tile<kQkvThreads>(lns + slice, slice, a.ln_bias + k0, 0, 1, len8, 1, a.D - k0,
                           a.ln_bias, vec);
  }
  cp_async_commit();

  // this thread's pairs of the epilogue, o = tid + e kQkvThreads: row 4 rank + o / HALF,
  // columns j, j + HALF of the head. Their bias and the cursor are loaded now, while the
  // copies run
  int tt[kPairs], j[kPairs];
  bool mine[kPairs];
  float bias[kPairs][2];
#pragma unroll
  for (int e = 0; e < kPairs; ++e) {
    const int o = tid + e * kQkvThreads;
    tt[e] = 4 * rank + o / HALF;
    j[e] = o % HALF;
    mine[e] = o < 4 * HALF && r0 + tt[e] < a.R;
    const bool b = mine[e] && a.b[sec] != nullptr;
    bias[e][0] = b ? a.b[sec][lh * HD + j[e]] : 0.f;
    bias[e][1] = b ? a.b[sec][lh * HD + j[e] + HALF] : 0.f;
  }
  const int w0 = min(max(*a.cache_pos, 0), a.T - a.S);

  cp_async_wait<0>();   // the rows have landed; then the slab, in flight under the statistics
  __syncthreads();
  if (nch > 0) copy_chunk(0);
  cp_async_commit();

  // ln1's statistics of the 32 rows over this slice: lanes kLanes t .. kLanes t + kLanes - 1
  // own row t, lane q summing k = q, q + kLanes, ... in order, then a fixed butterfly;
  // layernorm keeps the slice's mean and centred sum of squares, rmsnorm its sum of squares
  const int t = tid / kLanes, qd = tid % kLanes;
  float* xr = xs + t * xld;
  float s = 0.f, m2 = 0.f;
#pragma unroll 4
  for (int k = qd; k < len; k += kLanes) {
    const float v = xr[k];
    s += ln ? v : v * v;
  }
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (ln) {
    s = len > 0 ? s / static_cast<float>(len) : 0.f;
#pragma unroll 4
    for (int k = qd; k < len; k += kLanes) {
      const float d = xr[k] - s;
      m2 += d * d;
    }
#pragma unroll
    for (int o = 1; o < kLanes; o <<= 1) m2 += __shfl_xor_sync(0xffffffffu, m2, o);
  }
  if (qd == 0) {
    stats[t] = s;
    stats[kRowTile + t] = m2;
  }
  cluster_arrive();
  // RoPE's rotation of this thread's pairs, computed while the cluster meets
  const bool rot = a.use_rope && sec < 2;
  float sn[kPairs], cs[kPairs];
#pragma unroll
  for (int e = 0; e < kPairs; ++e) {
    sn[e] = 0.f;
    cs[e] = 1.f;
    if (mine[e] && rot) {
      const float freq = powf(a.theta, -static_cast<float>(j[e]) / static_cast<float>(HALF));
      const float ang = static_cast<float>(a.pos0 + (r0 + tt[e]) % a.S) * freq;
      sn[e] = sinf(ang);
      cs[e] = cosf(ang);
    }
  }
  cluster_wait();

  // the 8 slices' statistics in rank order through DSMEM, then this slice normalised in
  // place. Layernorm: mu = sum_p n_p m_p / D, and the centred sum of squares
  // sum_p (M2_p + n_p (m_p - mu)^2); rmsnorm: sum_p of the sums of squares
  float rs[kCluster], rm2[kCluster], nb[kCluster];
#pragma unroll
  for (int p = 0; p < kCluster; ++p) {   // every remote read in flight at once
    const float* st = cluster.map_shared_rank(stats, p);
    rs[p] = st[t];
    rm2[p] = st[kRowTile + t];
    nb[p] = static_cast<float>(max(0, min(a.D, (p + 1) * slice) - p * slice));
  }
  float mu = 0.f, ss = 0.f;
  if (ln) {
#pragma unroll
    for (int p = 0; p < kCluster; ++p) mu += nb[p] * rs[p];
    mu /= static_cast<float>(a.D);
#pragma unroll
    for (int p = 0; p < kCluster; ++p) {
      const float d = rs[p] - mu;
      ss += rm2[p] + nb[p] * (d * d);
    }
  } else {
#pragma unroll
    for (int p = 0; p < kCluster; ++p) ss += rs[p];
  }
  const float inv = rsqrtf(ss / static_cast<float>(a.D) + a.eps);
  for (int kb = qd; kb < len; kb += 4 * kLanes) {   // 4 elements' loads before their stores
    float v[4], sc[4], bs[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = min(kb + u * kLanes, len8 - 1);
      v[u] = xr[k];
      sc[u] = lns[k];
      bs[u] = lns[slice + k];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float y = (v[u] - mu) * inv;
      if (kb + u * kLanes < len) {
        xr[kb + u * kLanes] = ln ? y * sc[u] + bs[u] : y * (1.0f + sc[u]);
      }
    }
  }

  // the product on the tensor cores: 3xTF32 mma.sync.m16n8k8, warp w on both 16-row
  // halves of the tile x the w-th NT n8 blocks (HD = 16: half w % 2 x n8 block w / 2),
  // k8 steps in increasing k from the slice's start
  const int g = lane / 4, tq = lane % 4;
  const int m0 = MT == 2 ? 0 : w % 2, n0 = MT == 2 ? w * NT * 8 : w / 2 * 8;
  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch) {
      copy_chunk(c + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // the chunk, and the normalised rows, are visible to every warp
    const float* xa = xs + (16 * m0 + g) * xld + c * CH + tq;
    const float* wb = ws + (c & 1) * CH * WLD + tq * WLD + n0 + g;
    const int kn = min(CH, len8 - c * CH);
#pragma unroll 4
    for (int kk = 0; kk < kn; kk += 8) {
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* p = xa + 16 * mt * xld + kk;
        split(p[0], ah[mt][0], al[mt][0]);
        split(p[8 * xld], ah[mt][1], al[mt][1]);
        split(p[4], ah[mt][2], al[mt][2]);
        split(p[8 * xld + 4], ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* p = wb + kk * WLD + 8 * nt;
        uint32_t bh[2], bl[2];
        split(p[0], bh[0], bl[0]);
        split(p[4 * WLD], bh[1], bl[1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_3xtf32(acc[mt][nt], ah[mt], al[mt], bh, bl);
      }
    }
    __syncthreads();   // the next chunk's copy overwrites this buffer
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float* p = part + (16 * (m0 + mt) + g) * WLD + n0 + 8 * nt + 2 * tq;
      *reinterpret_cast<float2*>(p) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(p + 8 * WLD) = make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  cluster.sync();

  // rank s finalises rows 4s .. 4s + 3: the 8 partials in rank order, the bias, RoPE on
  // each pair (j, j + HD / 2), and the store of q or of the k/v cache row at the cursor
  float y[kPairs][2];
#pragma unroll
  for (int e = 0; e < kPairs; ++e) {
    y[e][0] = y[e][1] = 0.f;
    if (tid + e * kQkvThreads < 4 * HALF) {
      float v[kCluster][2];
#pragma unroll
      for (int p = 0; p < kCluster; ++p) {   // every remote read in flight at once
        const float* rp = cluster.map_shared_rank(part, p) + tt[e] * WLD + j[e];
        v[p][0] = rp[0];
        v[p][1] = rp[HALF];
      }
      y[e][0] = v[0][0];
      y[e][1] = v[0][1];
#pragma unroll
      for (int p = 1; p < kCluster; ++p) {
        y[e][0] += v[p][0];
        y[e][1] += v[p][1];
      }
    }
  }
  cluster_arrive();   // the last remote read is done; no block leaves before all are
#pragma unroll
  for (int e = 0; e < kPairs; ++e) {
    if (!mine[e]) continue;
    float y0 = y[e][0] + bias[e][0], y1 = y[e][1] + bias[e][1];
    if (rot) {
      const float o1 = y0 * cs[e] - y1 * sn[e];
      const float o2 = y1 * cs[e] + y0 * sn[e];
      y0 = o1;
      y1 = o2;
    }
    const int r = r0 + tt[e], i = r % a.S, c1 = lh * HD + j[e];
    float* dst = sec == 0 ? a.q + static_cast<size_t>(r) * ncols
                          : a.cache[sec - 1] + (static_cast<size_t>(r / a.S) * a.T + w0 + i) * ncols;
    dst[c1] = y0;
    dst[c1 + HALF] = y1;
  }
  cluster_wait();
}

template <int HD>
int launch_qkv(const QkvArgs& a, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      qkv_rope_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const size_t smem = static_cast<size_t>(QkvTile<HD>::smem_floats(a.D)) * sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((a.H + 2 * a.KH) * kCluster, (a.R + kRowTile - 1) / kRowTile);
  qkv_rope_kernel<HD><<<grid, kQkvThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// -- attn_cached -------------------------------------------------------------------

constexpr int kAttnThreads = 256;

template <int HD>
__global__ void __launch_bounds__(kAttnThreads)
attn_cached_kernel(const float* __restrict__ q, const float* __restrict__ kc,
                   const float* __restrict__ vc, const int* __restrict__ cache_pos,
                   float* __restrict__ out, int S, int T, int H, int KH, int pos0,
                   float scale) {
  constexpr int kPer = HD >= 32 ? HD / 32 : 1;  // dims of q and k per lane
  constexpr int kLanes = HD / kPer;             // lanes on a key's score: 32, or 16 at HD = 16
  constexpr int kKeys = 32 / kLanes;            // keys a warp scores at once
  constexpr int kPvSlices = kAttnThreads / HD;  // contiguous key slices of p @ v
  extern __shared__ float4 smem4[];
  float* sc = reinterpret_cast<float*>(smem4);  // T scores, then probabilities
  float* part = sc + ((T + 3) & ~3);          // (kPvSlices, HD) partial sums
  float* lpart = part + kPvSlices * HD;       // (kPvSlices) partial sums of p
  float* wmax = lpart + kPvSlices;            // one max per warp

  const int h = blockIdx.x, r = blockIdx.y;
  const int b = r / S, pos = pos0 + r % S;
  const int end = *cache_pos + S;
  const int kvh = h / (H / KH);
  const int ld = KH * HD;
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;

  // lane l takes dims (l % kLanes) kPer .. of key kKeys i + l / kLanes; the lanes of a key
  // meet in an xor butterfly over kLanes, so every key's score has one order
  const int kl = lane % kLanes;
  float qv[kPer];
  const float* qrow = q + static_cast<size_t>(r) * H * HD + h * HD + kl * kPer;
#pragma unroll
  for (int e = 0; e < kPer; ++e) qv[e] = qrow[e];
  const float* kbase = kc + static_cast<size_t>(b) * T * ld + kvh * HD + kl * kPer;
  if constexpr (kKeys == 1) {
#pragma unroll 8
    for (int t = w; t < T; t += kAttnThreads / 32) {
      const float* krow = kbase + static_cast<size_t>(t) * ld;
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < kPer; ++e) d = fmaf(qv[e], krow[e], d);
      d = warp_sum(d);
      if (lane == 0) sc[t] = (t <= pos && t < end) ? d * scale : kNegInf;
    }
  } else {
#pragma unroll 8
    for (int t0 = kKeys * w; t0 < T; t0 += kKeys * (kAttnThreads / 32)) {
      const int t = t0 + lane / kLanes;
      const float* krow = kbase + static_cast<size_t>(min(t, T - 1)) * ld;
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < kPer; ++e) d = fmaf(qv[e], krow[e], d);
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
      if (kl == 0 && t < T) sc[t] = (t <= pos && t < end) ? d * scale : kNegInf;
    }
  }
  __syncthreads();

  float m = kNegInf;
  for (int t = tid; t < T; t += kAttnThreads) m = fmaxf(m, sc[t]);
  m = warp_max(m);
  if (lane == 0) wmax[w] = m;
  __syncthreads();
  m = wmax[0];
  for (int i = 1; i < kAttnThreads / 32; ++i) m = fmaxf(m, wmax[i]);
  for (int t = tid; t < T; t += kAttnThreads) sc[t] = expf(sc[t] - m);
  __syncthreads();

  const int sl = tid / HD, d = tid % HD;
  const int chunk = (T + kPvSlices - 1) / kPvSlices;
  const int t0 = sl * chunk, t1 = min(T, t0 + chunk);
  const float* vcol = vc + static_cast<size_t>(b) * T * ld + kvh * HD + d;
  float acc = 0.f, l = 0.f;
  for (int t = t0; t < t1; ++t) {
    const float p = sc[t];
    l += p;
    acc = fmaf(p, vcol[static_cast<size_t>(t) * ld], acc);
  }
  part[sl * HD + d] = acc;
  if (d == 0) lpart[sl] = l;
  __syncthreads();
  if (tid < HD) {
    float o = part[tid], lsum = lpart[0];
    for (int s = 1; s < kPvSlices; ++s) {
      o += part[s * HD + tid];
      lsum += lpart[s];
    }
    out[static_cast<size_t>(r) * H * HD + h * HD + tid] = o / lsum;
  }
}

template <int HD>
int launch_attn(const float* q, const float* kc, const float* vc, const int* cache_pos,
                float* out, int R, int S, int T, int H, int KH, int pos0, float scale,
                cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_cached_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const size_t smem =
      (((T + 3) & ~3) + (kAttnThreads / HD) * (HD + 1) + kAttnThreads / 32) * sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(H, R);
  attn_cached_kernel<HD><<<grid, kAttnThreads, smem, stream>>>(q, kc, vc, cache_pos, out, S,
                                                              T, H, KH, pos0, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int draft_qkv_rope_launch(const void* x, const void* ln_scale, const void* ln_bias,
                                     const void* wq, const void* wk, const void* wv,
                                     const void* bq, const void* bk, const void* bv, void* q,
                                     void* kcache, void* vcache, const void* cache_pos, int R,
                                     int S, int T, int D, int H, int KH, int HD, int pos0,
                                     int norm, float eps, int use_rope, float theta,
                                     void* stream) {
  if (R <= 0 || S <= 0 || R % S != 0 || S > T || KH <= 0 || H % KH != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  QkvArgs a;
  a.x = static_cast<const float*>(x);
  a.ln_scale = static_cast<const float*>(ln_scale);
  a.ln_bias = static_cast<const float*>(ln_bias);
  a.w[0] = static_cast<const float*>(wq);
  a.w[1] = static_cast<const float*>(wk);
  a.w[2] = static_cast<const float*>(wv);
  a.b[0] = static_cast<const float*>(bq);
  a.b[1] = static_cast<const float*>(bk);
  a.b[2] = static_cast<const float*>(bv);
  a.q = static_cast<float*>(q);
  a.cache[0] = static_cast<float*>(kcache);
  a.cache[1] = static_cast<float*>(vcache);
  a.cache_pos = static_cast<const int*>(cache_pos);
  a.R = R; a.S = S; a.T = T; a.D = D; a.H = H; a.KH = KH; a.pos0 = pos0;
  a.norm = norm; a.use_rope = use_rope; a.eps = eps; a.theta = theta;
  a.vec = D % 4 == 0 && aligned16(x) && aligned16(ln_scale) && aligned16(ln_bias) &&
          aligned16(wq) && aligned16(wk) && aligned16(wv);
  auto st = static_cast<cudaStream_t>(stream);
  switch (HD) {
    case 16: return launch_qkv<16>(a, st);
    case 32: return launch_qkv<32>(a, st);
    case 64: return launch_qkv<64>(a, st);
    case 128: return launch_qkv<128>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int draft_attn_cached_launch(const void* q, const void* kcache, const void* vcache,
                                        const void* cache_pos, void* out, int R, int S, int T,
                                        int H, int KH, int HD, int pos0, float scale,
                                        void* stream) {
  if (R <= 0 || S <= 0 || R % S != 0 || S > T || KH <= 0 || H % KH != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(kcache);
  const auto* vf = static_cast<const float*>(vcache);
  const auto* cp = static_cast<const int*>(cache_pos);
  auto* of = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (HD) {
    case 16: return launch_attn<16>(qf, kf, vf, cp, of, R, S, T, H, KH, pos0, scale, st);
    case 32: return launch_attn<32>(qf, kf, vf, cp, of, R, S, T, H, KH, pos0, scale, st);
    case 64: return launch_attn<64>(qf, kf, vf, cp, of, R, S, T, H, KH, pos0, scale, st);
    case 128: return launch_attn<128>(qf, kf, vf, cp, of, R, S, T, H, KH, pos0, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// post_attn: three cluster launches on the stream, x1 (R, D) and u (R, F) scratch from
// the caller. staged: 0 takes each projection's whole slice at once where it fits, 1
// streams every slice in stages (the same bits).
extern "C" int draft_post_attn_launch(const void* a, const void* x, const void* wo,
                                      const void* bo, const void* ln_scale, const void* ln_bias,
                                      const void* wup, const void* bup, const void* wgate,
                                      const void* bgate, const void* wdown, const void* bdown,
                                      void* x1, void* u, void* out, int R, int D, int QD, int F,
                                      int norm, float eps, int act, int staged, void* stream) {
  if (R <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto vec = [](const PostArgs& p) {
    return p.K % 4 == 0 && p.N % 4 == 0 && aligned16(p.in) && aligned16(p.w[0]) &&
           aligned16(p.w[1]);
  };
  PostArgs p{};
  p.in = static_cast<const float*>(a);
  p.w[0] = static_cast<const float*>(wo);
  p.b[0] = static_cast<const float*>(bo);
  p.resid = static_cast<const float*>(x);
  p.out = static_cast<float*>(x1);
  p.R = R; p.K = QD; p.N = D; p.norm = norm; p.eps = eps; p.vec = vec(p);
  int rc = launch_post<32, 1, 128, kEpiResid>(p, staged, st);
  if (rc != 0) return rc;

  p = PostArgs{};
  p.in = static_cast<const float*>(x1);
  p.ln_scale = static_cast<const float*>(ln_scale);
  p.ln_bias = static_cast<const float*>(ln_bias);
  p.w[0] = static_cast<const float*>(wup);
  p.b[0] = static_cast<const float*>(bup);
  p.w[1] = static_cast<const float*>(wgate);
  p.b[1] = static_cast<const float*>(bgate);
  p.out = static_cast<float*>(u);
  p.R = R; p.K = D; p.N = F; p.norm = norm; p.eps = eps; p.act = act; p.vec = vec(p);
  rc = wgate != nullptr ? launch_post<64, 2, 256, kEpiAct>(p, staged, st)
                        : launch_post<128, 1, 256, kEpiAct>(p, staged, st);
  if (rc != 0) return rc;

  p = PostArgs{};
  p.in = static_cast<const float*>(u);
  p.w[0] = static_cast<const float*>(wdown);
  p.b[0] = static_cast<const float*>(bdown);
  p.resid = static_cast<const float*>(x1);
  p.out = static_cast<float*>(out);
  p.R = R; p.K = F; p.N = D; p.norm = norm; p.eps = eps; p.vec = vec(p);
  return launch_post<64, 1, 128, kEpiResid>(p, staged, st);
}

extern "C" int draft_head_launch(const void* x, const void* ln_scale, const void* ln_bias,
                                 const void* w, int ldk, int ldn, void* out, int R, int D, int V,
                                 int norm, float eps, void* stream) {
  if (R <= 0 || D <= 0 || V <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool row_major = ldn == 1 && ldk == V;
  const bool tied = !row_major && ldk == 1 && ldn == D;
  if (!row_major && !tied) return static_cast<int>(cudaErrorInvalidValue);
  HeadArgs a{};
  a.t = head_tiling(D, V);
  if (a.t.smem > kMaxSmem || (V + a.t.nt - 1) / a.t.nt > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  a.x = static_cast<const float*>(x);
  a.ln_scale = static_cast<const float*>(ln_scale);
  a.ln_bias = static_cast<const float*>(ln_bias);
  a.w = static_cast<const float*>(w);
  a.out = static_cast<float*>(out);
  a.R = R; a.D = D; a.V = V; a.norm = norm; a.eps = eps;
  const bool whole = tied ? D % 4 == 0 : V <= a.t.nt ? (D * V) % 4 == 0 : V % 4 == 0;
  a.vec = whole && aligned16(w);
  a.xvec = D % 4 == 0 && aligned16(x) && aligned16(ln_scale) && aligned16(ln_bias);
  auto st = static_cast<cudaStream_t>(stream);
  return tied ? launch_head_rows<true>(a, st) : launch_head_rows<false>(a, st);
}
