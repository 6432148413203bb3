// Blockwise flash attention (forward, float32) for Hopper (sm_90a).
//
// Replaces the TPU kernel flash_attention_pallas / _fa_kernel
// (src/repro/kernels/flash_attn/kernel.py): online-softmax attention with
// bidirectional, causal and sliding-window masks, skipping key blocks
// that the mask removes entirely. The masks, NEG_INF = -2.3819763e38 and
// the 1e-30 floor on the normaliser are the TPU kernel's.
//
// Layout. q (B, S, H, DK), k (B, T, KH, DK), v (B, T, KH, DV), o (B, S,
// H, DV), all contiguous float32: the JAX wrapper's layout, read in place,
// so no transpose or GQA copy runs around the kernel. Query head h reads KV
// head h / (H / KH). DK = DV = 16, 32, 64, 80 (Zamba2's shared attention),
// 128 or 256 (gemma3-1b); DK = 192 with DV = 128 (DeepSeek-V3's MLA: qk_nope
// 128 + qk_rope 64 against v 128) and DK = 48 with DV = 32 (its smoke
// config). Q.K^T runs over DK; P.V, the accumulator and the output over DV.
//
// Bounds on an H100 SXM at the DiT's shape (B = 32, H = 12, S = T = 256,
// D = 64). Bytes: 4 * 25.2 MB of q, k, v, o is 30 us at 3.35 TB/s. The two
// products are 4 * B * H * S * T * D = 6.4 GFLOP: 13 us at the card's 495
// TFLOP/s dense TF32 tensor-core rate, so the function is bound by bytes
// (30 us), and 96 us at the 67 TFLOP/s float32 rate outside the tensor
// cores, the bound of a CUDA-core kernel. The tensor cores take float32
// only as TF32 (10 mantissa bits), which misses the 1e-4 contract by 5x,
// so this kernel runs each product as three TF32 products (3xTF32:
// a_lo b_hi + a_hi b_lo + a_hi b_hi, with hi = tf32(x), lo = x - hi):
// 19.3 G TF32 operations, 39 us at 495 TFLOP/s, the floor of this design
// rather than of the function.
//
// Design.
// - Grid (B * H, ceil(S / 64)); 4 warps own 16 query rows each (the M of
//   mma.sync.m16n8k8). Both products are mma.sync TF32 with the 3xTF32
//   split and float32 accumulators; Q is split once into hi/lo A fragments
//   (registers for D <= 64, re-split from shared memory for D = 80 and 128).
//   At D = 80 a row is 20 16-byte vectors (a 64-row Q tile and a 32-key
//   tile are 10 and 5 copies a thread) and the padded row of 84 floats
//   still spreads a fragment's 32 loads over 32 banks; the tiles take
//   64.5 KB of shared memory.
// - K/V tiles of 32 keys are double-buffered in shared memory: the 16-byte
//   cp.async copies of tile j + 1 (zero-filled past T) are in flight while
//   tile j computes. Rows are padded to D + 4 floats, so the B-fragment
//   loads of both products hit 32 distinct banks.
// - The online softmax works on the Q.K^T accumulator fragment: each
//   thread holds 2 rows x 2 columns of each 8-key block, the row max meets
//   over the quad of 4 lanes with two shuffles, each exp is computed once.
//   The per-element mask test runs only in tiles that cross a mask edge.
// - P is fed to P.V from the accumulator fragment without a shuffle: the
//   A fragment's column k = t stands for key 2t and k = t + 4 for key
//   2t + 1, and the V fragment reads its rows in the same order (a sum
//   over keys does not depend on their order).
//
// - D = 256 (gemma3-1b's head_dim): the 64 x 256 output accumulator of one
//   block is 128 floats a thread, and ptxas spilled 72 bytes at 255
//   registers (32-key tiles; H100 SXM, nvcc 12.8). So two blocks share a
//   query tile (grid z = Tiles::kSplit), each with the scores over all of D
//   and P.V for 128 columns of V and of the output: Q.K^T runs twice.
//   tools/flash_tile_sweep.py times the key tile (16, 32) and the split
//   (1, 2) at gemma3-1b's shapes (4 x 1024, 4 heads, kv 1; bidirectional
//   with the 512 window / causal with it / bidirectional, ms on an H100 SXM
//   at 700 W): 32 keys, split 2: 0.513 / 0.303 / 0.667, 241 registers, no
//   spill (kept); 16 keys, split 2: 0.590 / 0.363 / 0.753, 202 registers;
//   16 keys, one block: 0.408 / 0.267 / 0.518 but 48 bytes of spill; 32
//   keys, one block: 0.535 / 0.363 / 0.682, 224 bytes of spill. The spill
//   gate refuses both one-block tiles.
//
// - DK != DV (MLA, flash_attn_kernel<DK, DV>): the same body, with K rows
//   padded to DK + 4 and V rows to DV + 4 floats, V strided by KH * DV and O
//   by H * DV. At (192, 128) the accumulator is 64 floats a thread, as at
//   D = 128, and Q (DK > 64) is re-split from shared memory at every k-step.
//   The tiles take (64 x 196 + 2 x 32 x 196 + 2 x 32 x 132) floats = 131 KB
//   of shared memory: one block an SM under the 227 KB limit, so the second
//   block that __launch_bounds__ allows for cannot be had there. At (48, 32)
//   Q stays in registers (DK <= 64) and the tiles take 31 KB. Each
//   DK == DV instance is the template at DK = DV, unchanged.
//
// What holds it at about a quarter of the TF32 rate (chip_smoke.py, H100
// SXM at 700 W: 0.142 ms at the DiT's shape) is the CUDA-core work around
// each mma: every warp splits every K and V element it reads (3 integer
// and float operations each), and the softmax's exps. 64-key tiles, 128
// rows over 8 warps, Q in shared memory for every D and K/V split once per
// tile into shared memory were each as fast or slower on that card.

#include <cuda_runtime.h>

#include <cstdint>

#include "tf32_mma.cuh"

namespace {

using wsfm::cp_async16;
using wsfm::cp_async_commit;
using wsfm::cp_async_wait;
using wsfm::mma_3xtf32;
using wsfm::split;

constexpr int kBlockQ = 64;
constexpr int kWarps = kBlockQ / 16;
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -2.3819763e38f;

template <int DK, int DV>
struct Tiles {
  static_assert(DK % 8 == 0 && DK <= 256, "the q/k head_dim must be a multiple of 8, at most 256");
  static_assert(DV % 8 == 0 && DV <= 256, "the v head_dim must be a multiple of 8, at most 256");
  static constexpr int kBlockK = DV <= 128 ? 32 : 32;  // keys per tile
  // blocks that share a query tile, each computing the scores over all of DK and
  // P.V for its DV / kSplit columns of V and of the output (at DV = 256 the whole
  // output accumulator, 128 floats a thread, leaves ptxas spilling)
  static constexpr int kSplit = DV <= 128 ? 1 : 2;
  static constexpr int kDv = DV / kSplit;             // V and output columns of a block
  static constexpr bool kQInRegs = DK <= 64;          // else the registers spill
  static constexpr int kLd = DK + 4;                  // padded K row, in floats
  static constexpr int kLdv = kDv + 4;                // padded V row
  static constexpr int kQFloats = kBlockQ * kLd;
  static constexpr int kKFloats = kBlockK * kLd;
  static constexpr int kVFloats = kBlockK * kLdv;
  static constexpr size_t kSmemBytes = (kQFloats + 2 * kKFloats + 2 * kVFloats) * sizeof(float);
};

template <int BK>
__device__ __forceinline__ bool block_runs(int q_start, int k_start, int causal, int window) {
  if (causal) {
    bool run = k_start <= q_start + kBlockQ - 1;
    if (window > 0) run = run && (k_start + BK - 1 > q_start - window);
    return run;
  }
  if (window > 0) {
    return (k_start + BK - 1 > q_start - window) && (k_start < q_start + kBlockQ + window);
  }
  return true;
}

// True when every (row, key) of the tile attends: no per-element mask.
template <int BK>
__device__ __forceinline__ bool tile_full(int q_start, int k_start, int T, int causal,
                                          int window) {
  const int q_last = q_start + kBlockQ - 1, k_last = k_start + BK - 1;
  if (k_last >= T) return false;
  if (causal) return k_last <= q_start && (window <= 0 || k_start > q_last - window);
  if (window > 0) return max(k_last - q_start, q_last - k_start) < window;
  return true;
}

__device__ __forceinline__ bool attends(int qi, int ki, int seq_q, int seq_k, int causal,
                                        int window) {
  bool ok = qi < seq_q && ki < seq_k;
  if (causal) {
    ok = ok && ki <= qi;
    if (window > 0) ok = ok && ki > qi - window;
  } else if (window > 0) {
    ok = ok && abs(ki - qi) < window;
  }
  return ok;
}

// ROWS rows of D floats, from row0 of a (rows, stride) matrix into a
// padded shared tile (rows of D + 4); rows at or past n are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* src, size_t stride, int row0,
                                          int n, int tid) {
  constexpr int kVecs = D / 4;
  static_assert(ROWS * kVecs % kThreads == 0, "a tile is a whole number of copies a thread");
#pragma unroll
  for (int i = 0; i < ROWS * kVecs / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / kVecs, c = 4 * (idx % kVecs);
    const int row = row0 + r;
    const bool valid = row < n;
    cp_async16(dst + r * (D + 4) + c, src + static_cast<size_t>(valid ? row : n - 1) * stride + c,
               valid);
  }
}

// The A fragment of rows 16 w + g (+ 8), columns 8 ks + t (+ 4), split.
template <int LD>
__device__ __forceinline__ void q_fragment(const float* qw, int ks, uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  const float* p = qw + 8 * ks;
  split(p[0], hi[0], lo[0]);
  split(p[8 * LD], hi[1], lo[1]);
  split(p[4], hi[2], lo[2]);
  split(p[8 * LD + 4], hi[3], lo[3]);
}

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, 2)
flash_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int S, int T, int H,
                  int KH, float scale, int causal, int window) {
  using Cfg = Tiles<DK, DV>;
  constexpr int BK = Cfg::kBlockK, LD = Cfg::kLd, DVB = Cfg::kDv, LDV = Cfg::kLdv;
  constexpr int kDSteps = DK / 8;   // k-steps of Q.K^T
  constexpr int kVSteps = DVB / 8;  // n-blocks of P.V
  constexpr int kKSteps = BK / 8;  // n-blocks of Q.K^T, k-steps of P.V
  constexpr int kQRegs = Cfg::kQInRegs ? kDSteps : 1;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // (kBlockQ, LD)
  float* ks = qs + Cfg::kQFloats;               // 2 x (BK, LD)
  float* vs = ks + 2 * Cfg::kKFloats;           // 2 x (BK, LDV)

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / KH);
  const int q_start = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // the fragment's group and thread in group
  const int row = q_start + 16 * warp + g;  // this thread's rows: row, row + 8

  const size_t k_stride = static_cast<size_t>(KH) * DK;
  const size_t v_stride = static_cast<size_t>(KH) * DV;
  const float* kbase = k + (static_cast<size_t>(b) * T * KH + kvh) * DK;
  const int dv0 = static_cast<int>(blockIdx.z) * DVB;  // this block's V and output columns
  const float* vbase = v + (static_cast<size_t>(b) * T * KH + kvh) * DV + dv0;

  // the key blocks that run form one interval
  const int num_k_blocks = (T + BK - 1) / BK;
  int kb_begin = num_k_blocks, kb_end = 0;
  for (int kb = 0; kb < num_k_blocks; ++kb) {
    if (block_runs<BK>(q_start, kb * BK, causal, window)) {
      kb_begin = min(kb_begin, kb);
      kb_end = kb + 1;
    }
  }

  const float* qw = qs + (16 * warp + g) * LD + t;
  uint32_t qh[kQRegs][4], ql[kQRegs][4];
  float acc[kVSteps][4];
#pragma unroll
  for (int nd = 0; nd < kVSteps; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  if (kb_begin < kb_end) {  // uniform in the block; with no tile the output is 0
    load_tile<DK, kBlockQ>(qs, q + (static_cast<size_t>(b) * S * H + h) * DK,
                           static_cast<size_t>(H) * DK, q_start, S, tid);
    cp_async_commit();
    load_tile<DK, BK>(ks, kbase, k_stride, kb_begin * BK, T, tid);
    load_tile<DVB, BK>(vs, vbase, v_stride, kb_begin * BK, T, tid);
    cp_async_commit();
    if constexpr (Cfg::kQInRegs) {
      cp_async_wait<1>();  // Q has landed; the first K/V tile may still be in flight
      __syncthreads();
#pragma unroll
      for (int kd = 0; kd < kDSteps; ++kd) q_fragment<LD>(qw, kd, qh[kd], ql[kd]);
    }
  }

  for (int kb = kb_begin; kb < kb_end; ++kb) {
    const int buf = (kb - kb_begin) & 1;
    if (kb + 1 < kb_end) {
      load_tile<DK, BK>(ks + (buf ^ 1) * Cfg::kKFloats, kbase, k_stride, (kb + 1) * BK, T, tid);
      load_tile<DVB, BK>(vs + (buf ^ 1) * Cfg::kVFloats, vbase, v_stride, (kb + 1) * BK, T,
                         tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* kt = ks + buf * Cfg::kKFloats;
    const float* vt = vs + buf * Cfg::kVFloats;

    // S = Q K^T for this warp's 16 rows and the tile's BK keys
    float sc[kKSteps][4];
#pragma unroll
    for (int nk = 0; nk < kKSteps; ++nk) sc[nk][0] = sc[nk][1] = sc[nk][2] = sc[nk][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < kDSteps; ++kd) {
      uint32_t ah[4], al[4];
      if constexpr (Cfg::kQInRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ah[i] = qh[kd][i];
          al[i] = ql[kd][i];
        }
      } else {
        q_fragment<LD>(qw, kd, ah, al);
      }
#pragma unroll
      for (int nk = 0; nk < kKSteps; ++nk) {
        const float* kr = kt + (8 * nk + g) * LD + 8 * kd + t;
        uint32_t bh[2], bl[2];
        split(kr[0], bh[0], bl[0]);
        split(kr[4], bh[1], bl[1]);
        mma_3xtf32(sc[nk], ah, al, bh, bl);
      }
    }

    // scale, mask, online softmax; sc[nk][e] is row (e < 2 ? row : row + 8),
    // key k_start + 8 nk + 2 t + (e & 1)
    const int k_start = kb * BK;
    const bool edge = !tile_full<BK>(q_start, k_start, T, causal, window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nk = 0; nk < kKSteps; ++nk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = sc[nk][e] * scale;
        if (edge && !attends(row + 8 * (e >> 1), k_start + 8 * nk + 2 * t + (e & 1), S, T,
                             causal, window)) {
          s = kNegInf;
        }
        sc[nk][e] = s;
        mx[e >> 1] = fmaxf(mx[e >> 1], s);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nd = 0; nd < kVSteps; ++nd) {
      acc[nd][0] *= alpha[0];
      acc[nd][1] *= alpha[0];
      acc[nd][2] *= alpha[1];
      acc[nd][3] *= alpha[1];
    }

    // O += P V: the A fragment's k = t is key 2 t, k = t + 4 is key 2 t + 1
#pragma unroll
    for (int nk = 0; nk < kKSteps; ++nk) {
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[nk][e] - m[e >> 1]);
        l[e >> 1] += p;
        sc[nk][e] = p;
      }
      split(sc[nk][0], ph[0], pl[0]);
      split(sc[nk][2], ph[1], pl[1]);
      split(sc[nk][1], ph[2], pl[2]);
      split(sc[nk][3], ph[3], pl[3]);
      const float* vr = vt + (8 * nk + 2 * t) * LDV + g;
#pragma unroll
      for (int nd = 0; nd < kVSteps; ++nd) {
        uint32_t bh[2], bl[2];
        split(vr[8 * nd], bh[0], bl[0]);
        split(vr[LDV + 8 * nd], bh[1], bl[1]);
        mma_3xtf32(acc[nd], ph, pl, bh, bl);
      }
    }
    __syncthreads();  // the next iteration's copies overwrite this tile's buffer
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row + 8 * r;
    if (qi < S) {
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      float* orow = o + ((static_cast<size_t>(b) * S + qi) * H + h) * DV + dv0 + 2 * t;
#pragma unroll
      for (int nd = 0; nd < kVSteps; ++nd) {
        *reinterpret_cast<float2*>(orow + 8 * nd) =
            make_float2(acc[nd][2 * r] * inv, acc[nd][2 * r + 1] * inv);
      }
    }
  }
}

template <int DK, int DV>
int launch(const float* q, const float* k, const float* v, float* o, int B, int S, int T,
           int H, int KH, float scale, int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = Tiles<DK, DV>::kSmemBytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attn_kernel<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(B * H, (S + kBlockQ - 1) / kBlockQ, Tiles<DK, DV>::kSplit);
  flash_attn_kernel<DK, DV><<<grid, kThreads, smem, stream>>>(q, k, v, o, S, T, H, KH, scale,
                                                               causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// DK: q and k's head_dim; DV: v and o's.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v, void* o, int B,
                                 int S, int T, int H, int KH, int DK, int DV, float scale,
                                 int causal, int window, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || KH <= 0 || H % KH != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  auto st = static_cast<cudaStream_t>(stream);
#define FLASH_CASE(dk, dv)                                                                \
  if (DK == (dk) && DV == (dv)) {                                                         \
    return launch<dk, dv>(qf, kf, vf, of, B, S, T, H, KH, scale, causal, window, st);     \
  }
  FLASH_CASE(16, 16)
  FLASH_CASE(32, 32)
  FLASH_CASE(64, 64)
  FLASH_CASE(80, 80)
  FLASH_CASE(128, 128)
  FLASH_CASE(256, 256)
  FLASH_CASE(192, 128)
  FLASH_CASE(48, 32)
#undef FLASH_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
