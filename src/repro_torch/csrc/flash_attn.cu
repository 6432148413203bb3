// Blockwise flash attention (forward, float32) for Hopper (sm_90a).
//
// Replaces the TPU kernel flash_attention_pallas / _fa_kernel
// (src/repro/kernels/flash_attn/kernel.py): online-softmax attention with
// bidirectional, causal and sliding-window masks, skipping key blocks
// that the mask removes entirely. The masks, NEG_INF = -2.3819763e38 and
// the 1e-30 floor on the normaliser are the TPU kernel's.
//
// Layout. q (B, S, H, D), k and v (B, T, KH, D), o (B, S, H, D), all
// contiguous float32: the JAX wrapper's layout, read in place, so no
// transpose or GQA copy runs around the kernel. Query head h reads KV
// head h / (H / KH).
//
// Design. Grid (B * H, ceil(S / 64)); a block of 128 threads owns 64 query
// rows, two threads a row. Each thread keeps its half of the query row
// and of the output accumulator in registers, interleaved in float2 pairs
// (thread p of a row owns dims 4i + 2p and 4i + 2p + 1), so the two
// threads of a row read neighbouring shared-memory banks. The block walks
// 64-row key/value tiles staged through shared memory; for each key the
// two halves of the dot product meet with one __shfl_xor_sync, and the
// online softmax (m, l, acc) is updated every 16 keys. All arithmetic is
// float32 FMA on the CUDA cores; no tensor cores (wgmma/TMA is later work).
//
// Bound on an H100 SXM at the DiT's shape (B = 32, H = 12, S = T = 256,
// D = 64): 4 * 25.2 MB = 101 MB of q, k, v, o is 30 us at 3.35 TB/s; the
// two products are 4 * B * H * S * T * D = 6.4 GFLOP, 96 us at the card's
// 67 TFLOP/s float32 (non-tensor) rate. It is bound by operations. This
// kernel does nothing yet to reach that rate beyond keeping q and the
// accumulator in registers and k/v tiles in shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 2 * kBlockQ;
constexpr int kChunk = 16;
constexpr float kNegInf = -2.3819763e38f;

__device__ __forceinline__ bool block_runs(int q_start, int k_start, int causal, int window) {
  if (causal) {
    bool run = k_start <= q_start + kBlockQ - 1;
    if (window > 0) run = run && (k_start + kBlockK - 1 > q_start - window);
    return run;
  }
  if (window > 0) {
    return (k_start + kBlockK - 1 > q_start - window) && (k_start < q_start + kBlockQ + window);
  }
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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int S, int T, int H,
                  int KH, float scale, int causal, int window) {
  static_assert(D % 4 == 0 && D <= 128, "head_dim must be a multiple of 4, at most 128");
  constexpr int kPairs = D / 4;  // float2 pairs each thread owns
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // (kBlockK, D)
  float* vs = ks + kBlockK * D;                 // (kBlockK, D)

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KH);
  const int q_start = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x;
  const int part = tid & 1;
  const int qi = q_start + (tid >> 1);

  float2 qr[kPairs], acc[kPairs];
  {
    const float* qrow = q + ((static_cast<size_t>(b) * S + min(qi, S - 1)) * H + h) * D;
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      qr[i] = qi < S ? *reinterpret_cast<const float2*>(qrow + 4 * i + 2 * part)
                     : make_float2(0.f, 0.f);
      acc[i] = make_float2(0.f, 0.f);
    }
  }
  float m = kNegInf, l = 0.f;

  const int num_k_blocks = (T + kBlockK - 1) / kBlockK;
  for (int kb = 0; kb < num_k_blocks; ++kb) {
    const int k_start = kb * kBlockK;
    if (!block_runs(q_start, k_start, causal, window)) continue;  // uniform in the block
    __syncthreads();
    for (int idx = tid; idx < kBlockK * (D / 4); idx += kThreads) {
      const int r = idx / (D / 4), c = 4 * (idx % (D / 4));
      const int kj = k_start + r;
      float4 kv4 = make_float4(0.f, 0.f, 0.f, 0.f), vv4 = kv4;
      if (kj < T) {
        const size_t off = ((static_cast<size_t>(b) * T + kj) * KH + kvh) * D + c;
        kv4 = *reinterpret_cast<const float4*>(k + off);
        vv4 = *reinterpret_cast<const float4*>(v + off);
      }
      *reinterpret_cast<float4*>(ks + r * D + c) = kv4;
      *reinterpret_cast<float4*>(vs + r * D + c) = vv4;
    }
    __syncthreads();

    for (int j0 = 0; j0 < kBlockK; j0 += kChunk) {
      float sc[kChunk];
      float m_cur = kNegInf;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float* krow = ks + (j0 + jj) * D + 2 * part;
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < kPairs; ++i) {
          const float2 kk = *reinterpret_cast<const float2*>(krow + 4 * i);
          dot = fmaf(qr[i].x, kk.x, dot);
          dot = fmaf(qr[i].y, kk.y, dot);
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        const float s = attends(qi, k_start + j0 + jj, S, T, causal, window) ? dot * scale
                                                                             : kNegInf;
        sc[jj] = s;
        m_cur = fmaxf(m_cur, s);
      }
      const float m_new = fmaxf(m, m_cur);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        acc[i].x *= alpha;
        acc[i].y *= alpha;
      }
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = expf(sc[jj] - m_new);
        l += p;
        const float* vrow = vs + (j0 + jj) * D + 2 * part;
#pragma unroll
        for (int i = 0; i < kPairs; ++i) {
          const float2 vv = *reinterpret_cast<const float2*>(vrow + 4 * i);
          acc[i].x = fmaf(p, vv.x, acc[i].x);
          acc[i].y = fmaf(p, vv.y, acc[i].y);
        }
      }
      m = m_new;
    }
  }

  if (qi < S) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    float* orow = o + ((static_cast<size_t>(b) * S + qi) * H + h) * D;
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      *reinterpret_cast<float2*>(orow + 4 * i + 2 * part) =
          make_float2(acc[i].x * inv, acc[i].y * inv);
    }
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o, int B, int S, int T,
           int H, int KH, float scale, int causal, int window, cudaStream_t stream) {
  const size_t smem = 2 * kBlockK * D * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attn_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(B * H, (S + kBlockQ - 1) / kBlockQ);
  flash_attn_kernel<D><<<grid, kThreads, smem, stream>>>(q, k, v, o, S, T, H, KH, scale,
                                                          causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attn_launch(const void* q, const void* k, const void* v, void* o, int B,
                                 int S, int T, int H, int KH, int D, float scale, int causal,
                                 int window, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || KH <= 0 || H % KH != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  auto st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(qf, kf, vf, of, B, S, T, H, KH, scale, causal, window, st);
    case 64: return launch<64>(qf, kf, vf, of, B, S, T, H, KH, scale, causal, window, st);
    case 128: return launch<128>(qf, kf, vf, of, B, S, T, H, KH, scale, causal, window, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
