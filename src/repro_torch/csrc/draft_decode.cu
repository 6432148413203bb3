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
// attn_cached (attn_cached_kernel<hd, pb>). Its bound at the DiT's decode shape is the
// 53 MB of K and V it must read, 15.9 us at 3.35 TB/s; at starcoder2-3b's (R = 8, 24 heads
// of 128, 2 KV heads) 4.4 MB, 1.38 us; at a mid-decode cursor the valid keys' bytes only.
// It replaced one block of 256 threads for each (token row, query head), grid (H, R):
// under GQA every query head of a group read its KV head again (12 times at
// starcoder2-3b), every block read all T = max_len keys whatever the cursor, and p @ v
// walked its keys one dependent load at a time. Now:
//   * a cluster of C blocks owns one batch row b, one KV head and up to 16 (query row,
//     query head) pairs of it: the query heads of the group that share the KV head (up
//     to 16) x as many of b's S query rows as keep the pairs at 16. So each K and V row
//     is read from memory once for its whole group. Grid: C x B x KH x ceil(G / 16) x
//     ceil(S / rows) blocks along x, cluster dims (C, 1, 1) set at launch. An instance
//     for up to 4 and up to 16 pairs (pb; 128 and 256 threads), so a few pairs do not hold
//     the registers of sixteen. Where a cluster would own one pair (G = 1 and one query
//     row: the DiT's decode) there is nothing to share, and C blocks' copies and barriers
//     cost more than they save: attn_cached_solo_kernel<hd> then takes the pair in one
//     block of 256 threads, grid B x H, its C slices walked by C sets of threads with the
//     same arithmetic, key for key (below), so the same bits. It holds T scores in shared
//     memory; past some 40 000 keys (48 000 at hd 32, 52 000 at 16) the cluster instance
//     takes the one pair;
//   * rank s takes the s-th contiguous slice of T, keys [s W, min(T, (s + 1) W)), with
//     (C, W) = ops.attn_slices(T, hd): C = 8 at hd 128, 4 below, W = ceil(T / C), passed
//     by the wrapper; never a function of R, S, B, the cursor or G. A rank whose slice
//     starts at or past T holds nothing. It copies q of its pairs and its slice's K into
//     shared memory with cp.async (16-byte copies when the pointers allow, else 4-byte),
//     then V as a second commit group (warps 1 .. only), which lands under the scores. A
//     slice longer than a stage (64 keys at hd 128, 128 at 64, 256 at 16 and 32) streams
//     through one stage buffer twice: the scores and their max first, then K and V again,
//     the same scores recomputed;
//   * keys at or past end = *cache_pos + S are neither loaded nor summed. That is exact:
//     every row's key 0 counts (pos >= 0, end >= 1), so its max m is a real score; a key
//     masked for a row adds exp(NEG_INF - m) = +0 to l and fma(+0, v, acc) = acc to its
//     p @ v (no partial sum is ever -0), so the keys below end that a row does not see
//     change none of its bits, and neither would those at or past end. A rank whose whole
//     slice lies past end contributes +0. When some row could have no key (pos0 < 0 or
//     end < 1) every key of T is read, and masked keys are summed as the reference sums
//     them;
//   * the two-pass arithmetic of attn_cached_pallas, every sum in one order: a score is
//     q . k in four chains (the float4's lanes, d increasing) added (0 + 1) + (2 + 3),
//     times the scale (__fmul_rn: a recomputed score has the stored one's bits), masked to
//     NEG_INF; the row max over the ranks' local maxima through DSMEM after a cluster
//     barrier (exact in any order); p = exp(s - m); each rank's partial p @ v (the thread
//     on dim d of the pair) and l, each one chain in increasing key order; after a second
//     barrier each pair's l, the C ranks' partials added in rank order 0 .. C - 1, and
//     rank s finalises its share of the pairs' outputs, the partials added in rank order,
//     the division by l last; a third barrier keeps every block's shared memory alive
//     until the last remote read. No online rescaling, no atomics. Barriers 1 and 2 are a
//     release by one thread (after __syncthreads, a cluster-scope fence) and a relaxed
//     arrive by the others: thread 0 copies no V, so its fence waits on no copy.
// So a query token's output depends on T, hd and its own row's keys alone: a batched
// S-token prefill, S one-token steps, any chunking of them, any number of rows and either
// body give the same bits (chip_smoke.py's kernel-level and engine-level gates hold it).
// What holds it above its bound (tools/attn_cached_ablation.py): at starcoder2-3b a
// block's chain of copy, scores, three cluster barriers, p @ v and combine, one block an
// SM; at the DiT's decode the one-pair block's score pass (a thread a key) and its p @ v
// chains, one after the other (PERF.md).

// Cache. qkv_rope writes k and v straight into the layer's cache buffers
// (B, T, KH*hd) at the cursor read from the device (*cache_pos, clamped as
// dynamic_update_slice clamps), so the host never reads the cursor and no copy
// runs between the kernels. attn_cached reads end = *cache_pos + S.
//
// Bounds on an H100 SXM at the main path's decode shape (R = 32 rows, T = 271,
// dfm_dit CONFIG as the draft: D = 768, 12 heads of 64, F = 3072, V = 27):
//   qkv_rope 7.1 MB of weights, 113 MFLOP: 2.1 us at 3.35 TB/s (bytes);
//   attn_cached 53 MB of K/V at the cursor on the last row, 27 MFLOP: 15.9 us (bytes);
//     the keys below end only, so 8.5 us at end = 144;
//   post_attn 21.2 MB of weights, 340 MFLOP: 6.43 us (bytes);
//   head 191 KB (83 KB of weights), ~1.3 MFLOP: 0.057 us (bytes), launch-bound.
// The launch count is the CUDA graph's business (graphs.py). Build without
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

constexpr int kAttnPairs = 16;        // (query row, query head) pairs a cluster owns at most
constexpr int kAttnMaxCluster = 8;    // the portable cluster size

// A cluster block's layout for head dim HD and at most PB pairs (4 or 16: an instance for
// each, so a few pairs do not hold the registers and threads of sixteen).
template <int HD, int PB>
struct AttnTile {
  // threads of a block: 8 warps for 16 pairs, else 4
  static constexpr int kThreads = PB >= 16 ? 256 : 128;
  // keys of a stage: its K and V take 64-90 KB of shared memory
  static constexpr int kChunk = HD >= 128 ? 64 : (HD == 64 ? 128 : 256);
  // a K row in shared memory: the float4 reads of 8 consecutive rows hit distinct banks
  static constexpr int kKld = HD + 4;
  // p @ v: thread t on dim t % HD of pairs t / HD + kSets j, j < kAcc, whose
  // probabilities lie in slots (t / HD) kAcc + j of a key's row of kSlots
  static constexpr int kSets = kThreads / HD;
  static constexpr int kAcc = PB / kSets > 0 ? PB / kSets : 1;
  static constexpr int kSlots = kSets * kAcc;
  // pairs a score task takes against one key row
  static constexpr int kGroup = PB >= 16 ? 2 : 4;
  static_assert(kThreads % HD == 0 && PB % kGroup == 0 && PB <= kAttnPairs,
                "head_dim 16 .. 128, 4 or 16 pairs");
  // shared floats for stages of ch keys and pt pairs: K (ch, kKld), V (ch, HD), the
  // probabilities (ch, kSlots), q (pt, HD), the scores (pt, ch + 1), partial p @ v
  // (pt, HD), partial l, local max, row max then l (3 x pt)
  static __host__ __device__ constexpr int smem_floats(int ch, int pt) {
    return ch * (kKld + HD) + prob_floats(ch) + pt * (2 * HD + ch + 4);
  }
  // the probabilities' floats, rounded up to 16 bytes for q's copy after them
  static __host__ __device__ constexpr int prob_floats(int ch) {
    return (ch * kSlots + 3) & ~3;
  }
};

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

// Arrive at the cluster barrier, the fencing thread first making every write ordered
// before it (its own, and the block's through a preceding __syncthreads) visible to the
// cluster.
__device__ __forceinline__ void cluster_release_arrive(bool fencing) {
  if (fencing) asm volatile("fence.acq_rel.cluster;" ::: "memory");
  cluster_arrive_relaxed();
}

struct AttnArgs {
  const float* q;          // (R, H*HD), R = B * S
  const float* k;          // the layer's cache buffers (B, T, KH*HD)
  const float* v;
  const int* cache_pos;
  float* out;              // (R, H*HD)
  int S, T, H, KH, pos0;
  int C, W;                // the cluster and its slices of T (ops.attn_slices)
  int hg, qr;              // a cluster's heads of the group and query rows
  int htiles, rtiles;      // clusters along the group's heads and along S
  int vec;
  float scale;
};

// The scores of pairs p0 .. p0 + NG - 1 (q rows past P - 1 read as P - 1) against one key
// row: each q . k in four chains (the float4's lanes, d increasing), (0 + 1) + (2 + 3),
// scaled; the same bits wherever, beside whichever pairs and however often computed.
template <int HD, int NG>
__device__ __forceinline__ void attn_scores(const float* qs, int P, int p0, const float* krow,
                                            float scale, float (&out)[NG]) {
  const float* qrow[NG];
#pragma unroll
  for (int u = 0; u < NG; ++u) qrow[u] = qs + min(p0 + u, P - 1) * HD;
  float c[NG][4];
#pragma unroll
  for (int u = 0; u < NG; ++u) c[u][0] = c[u][1] = c[u][2] = c[u][3] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    const float4 y = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
    for (int u = 0; u < NG; ++u) {
      const float4 x = *reinterpret_cast<const float4*>(qrow[u] + d);
      c[u][0] = fmaf(x.x, y.x, c[u][0]);
      c[u][1] = fmaf(x.y, y.y, c[u][1]);
      c[u][2] = fmaf(x.z, y.z, c[u][2]);
      c[u][3] = fmaf(x.w, y.w, c[u][3]);
    }
  }
#pragma unroll
  for (int u = 0; u < NG; ++u)
    out[u] = __fmul_rn(__fadd_rn(__fadd_rn(c[u][0], c[u][1]), __fadd_rn(c[u][2], c[u][3])),
                       scale);
}

// The scores of a stage of n keys (rows of ks, key tk + row) into sc (P, sld): task e of
// ceil(P / NG) n takes key e % n against pairs NG (e / n) .. + NG - 1, walking e in steps
// of the block. Keys past the pair's own position (pos + p / nh) or at or past end score
// NEG_INF.
template <int HD, int NG, int NT>
__device__ __forceinline__ void attn_stage_scores(const float* qs, const float* ks, float* sc,
                                                  int sld, int P, int n, int tk, int pos,
                                                  int nh, int end, float scale) {
  const int groups = (P + NG - 1) / NG;
  const int step_g = NT / n, step_t = NT % n;
  int g = threadIdx.x / n, tl = threadIdx.x % n;
  for (; g < groups; g += step_g, tl += step_t) {
    if (tl >= n) {
      tl -= n;
      ++g;
      if (g >= groups) break;
    }
    const int t = tk + tl;
    float sv[NG];
    attn_scores<HD, NG>(qs, P, NG * g, ks + tl * (HD + 4), scale, sv);
#pragma unroll
    for (int u = 0; u < NG; ++u) {
      const int p = NG * g + u;
      if (p < P) sc[p * sld + tl] = t > pos + p / nh || t >= end ? kNegInf : sv[u];
    }
  }
}

// This thread's chains of p @ v (dim d) and l over a stage of n keys, for the NB slots
// pr[0 .. NB - 1] of each key's row of probabilities (SL slots a row), each chain in
// increasing key order; NB covers the block's pairs, so the slots past it hold nothing.
template <int HD, int NB, int SL, int ACC>
__device__ __forceinline__ void attn_pv(const float* pr, const float* vs, int n, int d,
                                        float (&acc)[ACC], float (&ls)[ACC]) {
  for (int tl = 0; tl < n; ++tl) {
    const float x = vs[tl * HD + d];
    const float* row = pr + tl * SL;
#pragma unroll
    for (int j = 0; j < NB; j += (NB % 4 == 0 ? 4 : NB)) {
      float pj[NB % 4 == 0 ? 4 : NB];
      if constexpr (NB % 4 == 0) {
        const float4 y = *reinterpret_cast<const float4*>(row + j);
        pj[0] = y.x;
        pj[1] = y.y;
        pj[2] = y.z;
        pj[3] = y.w;
      } else if constexpr (NB == 2) {
        const float2 y = *reinterpret_cast<const float2*>(row);
        pj[0] = y.x;
        pj[1] = y.y;
      } else {
        pj[0] = row[0];
      }
#pragma unroll
      for (int u = 0; u < (NB % 4 == 0 ? 4 : NB); ++u) {
        acc[j + u] = fmaf(pj[u], x, acc[j + u]);
        ls[j + u] = __fadd_rn(ls[j + u], pj[u]);
      }
    }
  }
}

// One query token against its batch row's keys below end, for a cluster's pairs, rank s
// summing the s-th slice of T (see the note on top).
template <int HD, int PB>
__device__ __forceinline__ void attn_cached_body(const AttnArgs& a) {
  using Tile = AttnTile<HD, PB>;
  constexpr int NT = Tile::kThreads;
  constexpr int KLD = Tile::kKld, ACC = Tile::kAcc, SETS = Tile::kSets, SL = Tile::kSlots;
  constexpr int NG = Tile::kGroup;
  constexpr int kLogSets = SETS == 16 ? 4 : (SETS == 8 ? 3 : (SETS == 4 ? 2 : (SETS == 2)));
  constexpr int kWarps = NT / 32, kWarpPairs = (PB + kWarps - 1) / kWarps;
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ch = min(a.W, Tile::kChunk), sld = ch + 1, pt = a.hg * a.qr;
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + ch * KLD;
  float* ps = vs + ch * HD;
  float* qs = ps + Tile::prob_floats(ch);
  float* sc = qs + pt * HD;
  float* part = sc + pt * sld;
  float* lpart = part + pt * HD;
  float* lmax = lpart + pt;
  float* gmax = lmax + pt;

  // the cluster's batch row, KV head, heads g0 .. g0 + nh - 1 of the group and query rows
  // i0 .. i0 + nr - 1; pair p is row i0 + p / nh, query head kvh G + g0 + p % nh
  int c = static_cast<int>(blockIdx.x) / a.C;
  const int rt = c % a.rtiles;
  c /= a.rtiles;
  const int ht = c % a.htiles;
  c /= a.htiles;
  const int kvh = c % a.KH, b = c / a.KH;
  const int G = a.H / a.KH;
  const int i0 = rt * a.qr, nr = min(a.qr, a.S - i0);
  const int g0 = ht * a.hg, nh = min(a.hg, G - g0);
  const int P = nr * nh;
  const int ld = a.KH * HD, qld = a.H * HD;
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const bool vec = a.vec != 0;
  const int pos0 = a.pos0;
  const float scale = a.scale;

  // no row sees a key at or past end; when some row could see no key at all, read them all
  const int end = *a.cache_pos + a.S;
  const int lim = end >= 1 && pos0 >= 0 ? min(end, a.T) : a.T;
  const int t0 = rank * a.W;
  const int len = max(0, min(min(t0 + a.W, a.T), lim) - t0);
  const int nch = (len + ch - 1) / ch;
  const size_t kv0 = (static_cast<size_t>(b) * a.T + t0) * ld + kvh * HD;
  const float* kb = a.k + kv0;
  const float* vb = a.v + kv0;

  copy_tile<NT>(qs, nh * HD,
                a.q + static_cast<size_t>(b * a.S + i0) * qld + (kvh * G + g0) * HD,
                qld, nr, nh * HD, nr, nh * HD, a.q, vec);
  if (nch > 0) {
    const int n = min(ch, len);
    copy_tile<NT>(ks, KLD, kb, ld, n, HD, n, HD, a.k, vec);
  }
  cp_async_commit();
  if (nch == 1 && tid >= 32) {   // warps 1 .. : warp 0 keeps nothing in flight (see (1))
    const int step = vec ? 4 : 1, cols = HD / step;
    for (int i = tid - 32; i < len * cols; i += NT - 32) {
      const int r = i / cols, cc = step * (i % cols);
      if (vec) {
        cp_async16(vs + r * HD + cc, vb + static_cast<size_t>(r) * ld + cc, true);
      } else {
        cp_async4(vs + r * HD + cc, vb + static_cast<size_t>(r) * ld + cc, true);
      }
    }
  }
  cp_async_commit();   // V lands under the scores

  const int pos = pos0 + i0;
  // pass 1: the scores of every stage and each pair's max over the slice; warp w keeps
  // the running max of pairs w, w + kWarps, ...
  float mx[kWarpPairs];
#pragma unroll
  for (int j = 0; j < kWarpPairs; ++j) mx[j] = kNegInf;
  for (int st = 0; st < nch; ++st) {
    const int n = min(ch, len - st * ch);
    if (st > 0) {
      copy_tile<NT>(ks, KLD, kb + static_cast<size_t>(st) * ch * ld, ld, n, HD, n,
                    HD, a.k, vec);
      cp_async_commit();
      cp_async_wait<0>();
    } else {
      cp_async_wait<1>();
    }
    __syncthreads();
    attn_stage_scores<HD, NG, NT>(qs, ks, sc, sld, P, n, t0 + st * ch, pos, nh, end, scale);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kWarpPairs; ++j) {
      const int p = w + kWarps * j;
      if (p < P) {
        float m = kNegInf;
        for (int tl = lane; tl < n; tl += 32) m = fmaxf(m, sc[p * sld + tl]);
        mx[j] = fmaxf(mx[j], warp_max(m));
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < kWarpPairs; ++j) {
      if (w + kWarps * j < P) lmax[w + kWarps * j] = mx[j];
    }
  }
  // (1) every rank's local maxima are written. The block barrier orders the block's
  // writes before thread 0's cluster-scope fence, and the fence orders them before its
  // arrive: a release at cluster scope for the waiters' acquire. Thread 0 has no copy in
  // flight, so its fence does not wait for V; every other thread arrives relaxed
  __syncthreads();
  cluster_release_arrive(tid == 0);
  cp_async_wait<0>();   // V of a one-stage slice, while the cluster meets
  cluster_wait();
  if (tid < P) {
    float m = kNegInf;
    for (int r = 0; r < a.C; ++r) m = fmaxf(m, cluster.map_shared_rank(lmax, r)[tid]);
    gmax[tid] = m;
  }

  // pass 2: p = exp(s - m) into ps (ch, SL) by slot: thread set t / HD reads slots
  // (t / HD) ACC .. + nb - 1, nb the power of two that covers the block's pairs; then
  // this thread's chains of p @ v and l (one a slot), each in increasing key order,
  // carried across the stages
  const int d = tid % HD, set = tid / HD;
  int nb = 1;
  while (nb * SETS < P) nb *= 2;
  const int lnb = __ffs(nb) - 1, lsn = lnb + kLogSets;
  float acc[ACC], ls[ACC];
#pragma unroll
  for (int j = 0; j < ACC; ++j) acc[j] = ls[j] = 0.f;
  for (int st = 0; st < nch; ++st) {
    const int n = min(ch, len - st * ch);
    if (nch > 1) {
      __syncthreads();   // every thread is done with the last stage
      copy_tile<NT>(ks, KLD, kb + static_cast<size_t>(st) * ch * ld, ld, n, HD,
                    n, HD, a.k, vec);
      copy_tile<NT>(vs, HD, vb + static_cast<size_t>(st) * ch * ld, ld, n, HD,
                    n, HD, a.v, vec);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      attn_stage_scores<HD, NG, NT>(qs, ks, sc, sld, P, n, t0 + st * ch, pos, nh, end,
                                    scale);
    }
    __syncthreads();
    for (int e = tid; e < (n << lsn); e += NT) {
      const int tl = e >> lsn, r = e & ((1 << lsn) - 1), sp = r >> lnb, j = r & (nb - 1);
      const int p = sp + SETS * j;
      ps[tl * SL + sp * ACC + j] = p < P ? expf(__fsub_rn(sc[p * sld + tl], gmax[p])) : 0.f;
    }
    __syncthreads();
    const float* pr = ps + set * ACC;
    if (nb == 1) {
      attn_pv<HD, 1, SL>(pr, vs, n, d, acc, ls);
    } else if (nb == 2) {
      if constexpr (ACC >= 2) attn_pv<HD, 2, SL>(pr, vs, n, d, acc, ls);
    } else if (nb == 4) {
      if constexpr (ACC >= 4) attn_pv<HD, 4, SL>(pr, vs, n, d, acc, ls);
    } else if (nb == 8) {
      if constexpr (ACC >= 8) attn_pv<HD, 8, SL>(pr, vs, n, d, acc, ls);
    } else {
      if constexpr (ACC >= 16) attn_pv<HD, 16, SL>(pr, vs, n, d, acc, ls);
    }
  }
#pragma unroll
  for (int j = 0; j < ACC; ++j) {
    const int p = set + SETS * j;
    if (p < P) {
      part[p * HD + d] = acc[j];
      if (d == 0) lpart[p] = ls[j];
    }
  }
  __syncthreads();   // (2) every rank's partials are written, released as at (1)
  cluster_release_arrive(tid == 0);
  cluster_wait();
  if (tid < P) {    // each pair's l, the ranks' partials in rank order (gmax is done)
    float l = cluster.map_shared_rank(lpart, 0)[tid];
    for (int r = 1; r < a.C; ++r) l = __fadd_rn(l, cluster.map_shared_rank(lpart, r)[tid]);
    gmax[tid] = l;
  }
  __syncthreads();

  // rank s finalises outputs [s per, (s + 1) per) of the P x HD: the C ranks' partials
  // added in rank order, then the division by l
  const int total = P * HD, per = (total + a.C - 1) / a.C;
  for (int o = rank * per + tid; o < min(total, (rank + 1) * per); o += NT) {
    float sum = cluster.map_shared_rank(part, 0)[o];
#pragma unroll
    for (int r = 1; r < kAttnMaxCluster; ++r) {
      if (r < a.C) sum = __fadd_rn(sum, cluster.map_shared_rank(part, r)[o]);
    }
    const int p = o / HD;
    a.out[static_cast<size_t>(b * a.S + i0 + p / nh) * qld + (kvh * G + g0 + p % nh) * HD +
          o % HD] = sum / gmax[p];
  }
  // (3) no block leaves while another may still read its partials; every remote value
  // read above is consumed, so the arrive needs no release
  cluster_arrive_relaxed();
  cluster_wait();
}

template <int HD, int PB>
__global__ void __launch_bounds__(AttnTile<HD, PB>::kThreads) attn_cached_kernel(AttnArgs a) {
  attn_cached_body<HD, PB>(a);
}

// At the registers ptxas picks itself it spills 16 bytes of the <32, 16> instance; with a
// minimum of one block an SM it takes more and spills none. That minimum on every instance
// cost starcoder2-3b's decode 6 us of 13 (PERF.md), so this instance alone has it.
template <int HD, int PB>
__global__ void __launch_bounds__(AttnTile<HD, PB>::kThreads, 1)
attn_cached_kernel_min1(AttnArgs a) {
  attn_cached_body<HD, PB>(a);
}

constexpr int kSoloThreads = 256;

// Keys of K a one-pair block stages at once: 70 KB at hd 64, three blocks an SM.
__host__ __device__ constexpr int solo_chunk(int hd) { return hd >= 128 ? 128 : 256; }

// Shared floats of a one-pair block: q, the slices' partial p @ v and l, a max a warp, a
// stage of K (rows padded by 4) and the scores (then p) of T keys.
__host__ __device__ constexpr int solo_smem_floats(int hd, int t) {
  return hd * (1 + kAttnMaxCluster) + kAttnMaxCluster + kSoloThreads / 32 +
         solo_chunk(hd) * (hd + 4) + ((t + 3) & ~3);
}

// One pair alone (G = 1 and one query row: the DiT's decode) in one block, no cluster: the
// C slices of the slice rule are walked by C sets of threads (set j takes slices j, j +
// 256 / HD, ...), with the arithmetic of attn_cached_kernel key for key: the same scores
// (attn_scores, a thread a key of a stage of K copied into shared memory), the max over
// the keys below lim, p = exp(s - m), each slice's p @ v and l one chain in increasing key
// order from +0, the slices added in order 0 .. C - 1, the division last. So its bits
// equal a cluster's for the same token, and which of the two computes a pair is free to
// depend on G and S.
template <int HD>
__global__ void __launch_bounds__(kSoloThreads)
attn_cached_solo_kernel(AttnArgs a) {
  constexpr int NT = kSoloThreads, SETS = NT / HD, CH = solo_chunk(HD), KLD = HD + 4;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* part = qs + HD;
  float* lpart = part + kAttnMaxCluster * HD;
  float* wmax = lpart + kAttnMaxCluster;
  float* ks = wmax + NT / 32;
  float* sc = ks + CH * KLD;

  const int h = static_cast<int>(blockIdx.x) % a.H, b = static_cast<int>(blockIdx.x) / a.H;
  const int ld = a.KH * HD;   // G = 1: KV head h
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const int pos = a.pos0, end = *a.cache_pos + 1;
  const int lim = end >= 1 && pos >= 0 ? min(end, a.T) : a.T;
  const size_t kv0 = static_cast<size_t>(b) * a.T * ld + h * HD;
  const float* kb = a.k + kv0;
  const float* vb = a.v + kv0;
  for (int i = tid; i < HD; i += NT) qs[i] = a.q[static_cast<size_t>(b) * a.H * HD + h * HD + i];

  float m = kNegInf;
  for (int t0 = 0; t0 < lim; t0 += CH) {
    const int n = min(CH, lim - t0);
    if (t0 > 0) __syncthreads();   // every thread is done with the last stage
    copy_tile<NT>(ks, KLD, kb + static_cast<size_t>(t0) * ld, ld, n, HD, n, HD, a.k,
                  a.vec != 0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int tl = tid; tl < n; tl += NT) {
      const int t = t0 + tl;
      float sv[1];
      attn_scores<HD, 1>(qs, 1, 0, ks + tl * KLD, a.scale, sv);
      const float s = t > pos || t >= end ? kNegInf : sv[0];
      sc[t] = s;
      m = fmaxf(m, s);
    }
  }
  m = warp_max(m);
  if (lane == 0) wmax[w] = m;
  __syncthreads();
  m = wmax[0];
#pragma unroll
  for (int i = 1; i < NT / 32; ++i) m = fmaxf(m, wmax[i]);
  for (int t = tid; t < lim; t += NT) sc[t] = expf(__fsub_rn(sc[t], m));
  __syncthreads();

  const int d = tid % HD;
  for (int r = tid / HD; r < a.C; r += SETS) {
    const int t1 = min(r * a.W + a.W, lim);
    float acc = 0.f, l = 0.f;
#pragma unroll 8
    for (int t = r * a.W; t < t1; ++t) {
      const float p = sc[t];
      acc = fmaf(p, vb[static_cast<size_t>(t) * ld + d], acc);
      l = __fadd_rn(l, p);
    }
    part[r * HD + d] = acc;
    if (d == 0) lpart[r] = l;
  }
  __syncthreads();
  for (int o = tid; o < HD; o += NT) {
    float l = lpart[0], sum = part[o];
    for (int r = 1; r < a.C; ++r) {
      l = __fadd_rn(l, lpart[r]);
      sum = __fadd_rn(sum, part[r * HD + o]);
    }
    a.out[static_cast<size_t>(b) * a.H * HD + h * HD + o] = sum / l;
  }
}

// The cluster's tiling of (G heads, S rows) into at most kAttnPairs pairs: a function of
// (G, S), which only says which cluster computes a pair, never how.
void attn_tiles(AttnArgs& a, int G) {
  a.hg = std::min(G, kAttnPairs);
  a.qr = std::max(1, std::min(a.S, kAttnPairs / a.hg));
  a.htiles = (G + a.hg - 1) / a.hg;
  a.rtiles = (a.S + a.qr - 1) / a.qr;
}

// A launch with the cluster dims (C, 1, 1) set at run time, C from the slice rule.
template <int HD, int PB>
int launch_attn_pb(const AttnArgs& a, int B, cudaStream_t stream) {
  void (*kernel)(AttnArgs);
  if constexpr (HD == 32 && PB == 16) {
    kernel = attn_cached_kernel_min1<HD, PB>;
  } else {
    kernel = attn_cached_kernel<HD, PB>;
  }
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int ch = std::min(a.W, AttnTile<HD, PB>::kChunk);
  const size_t smem =
      static_cast<size_t>(AttnTile<HD, PB>::smem_floats(ch, a.hg * a.qr)) * sizeof(float);
  const long blocks = static_cast<long>(a.C) * B * a.KH * a.htiles * a.rtiles;
  if (smem > kMaxSmem || blocks > 2147483647L) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = static_cast<unsigned>(a.C);
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(AttnTile<HD, PB>::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, kernel, a);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

// One block a pair (G = 1, S = 1) where its T scores fit in shared memory, else the
// cluster instance for up to 4 or up to 16 pairs: a function of G, S and T that says which
// code computes a pair, never how (the bits are the same).
template <int HD>
int launch_attn(const AttnArgs& a, int B, cudaStream_t stream) {
  const int pt = a.hg * a.qr;
  const size_t solo = static_cast<size_t>(solo_smem_floats(HD, a.T)) * sizeof(float);
  if (pt == 1 && solo <= kMaxSmem) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        attn_cached_solo_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    attn_cached_solo_kernel<HD><<<B * a.H, kSoloThreads, solo, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (pt <= 4) return launch_attn_pb<HD, 4>(a, B, stream);
  return launch_attn_pb<HD, 16>(a, B, stream);
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

// attn_cached: (C, W) is the slice rule's split of T, C blocks a cluster (1 .. 8), rank s
// on keys [s W, (s + 1) W).
extern "C" int draft_attn_cached_launch(const void* q, const void* kcache, const void* vcache,
                                        const void* cache_pos, void* out, int R, int S, int T,
                                        int H, int KH, int HD, int pos0, int C, int W,
                                        float scale, void* stream) {
  if (R <= 0 || S <= 0 || R % S != 0 || S > T || KH <= 0 || H % KH != 0 || C < 1 ||
      C > kAttnMaxCluster || W < 1 || static_cast<long>(C) * W < T) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  AttnArgs a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(kcache);
  a.v = static_cast<const float*>(vcache);
  a.cache_pos = static_cast<const int*>(cache_pos);
  a.out = static_cast<float*>(out);
  a.S = S; a.T = T; a.H = H; a.KH = KH; a.pos0 = pos0; a.C = C; a.W = W; a.scale = scale;
  attn_tiles(a, H / KH);
  a.vec = aligned16(q) && aligned16(kcache) && aligned16(vcache);
  auto st = static_cast<cudaStream_t>(stream);
  switch (HD) {
    case 16: return launch_attn<16>(a, R / S, st);
    case 32: return launch_attn<32>(a, R / S, st);
    case 64: return launch_attn<64>(a, R / S, st);
    case 128: return launch_attn<128>(a, R / S, st);
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
