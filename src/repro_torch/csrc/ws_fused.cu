// K fused warm-start Euler sampling steps for Hopper (sm_90a).
//
// Replaces the TPU kernel ws_fused_streamed_pallas / _ws_fused_kernel
// (src/repro/kernels/ws_fused/kernel.py): K consecutive draws against one
// frozen logits buffer (one backbone evaluation), the token carried from
// step to step, so the K - 1 intermediate token buffers never reach device
// memory and K - 1 launches disappear.
//
// Design. One warp per row, as ws_step.cu: the K steps run inside the warp,
// each a call of ws_common.cuh draw_row (the same function ws_step_kernel
// calls, so one launch of K steps equals K ws_step launches bit for bit),
// and the carried token stays in a register. The TPU kernel walked a
// (row block, step, vocab tile) grid with its state in VMEM scratch; here a
// step streams the row's V columns lane-strided with (m, s, best, bidx,
// lg_x, g_x) in registers and one butterfly merge, and the next step
// re-reads the row, from L1/L2 (V = 27: 108 bytes; V = 50257: 201 KB, from
// L2). The per-step mixing weights a and key words come from device memory;
// there is no VMEM budget to model.
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

#include "ws_common.cuh"

namespace {

__global__ void ws_fused_kernel(const float* __restrict__ logits,
                                const int32_t* __restrict__ x,
                                const float* __restrict__ a,
                                const int64_t* __restrict__ seeds,
                                int32_t* __restrict__ out, int rows, int vocab, int steps,
                                int key_group, int a_group, float temperature) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * wsfm::kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const float* lrow = logits + static_cast<size_t>(row) * vocab;
  const int key_cols = rows / key_group;
  const int a_cols = rows / a_group;
  const int kb = row / key_group;
  const int ab = row / a_group;
  const uint32_t c0 = static_cast<uint32_t>(row % key_group);
  int xr = x[row];
  for (int j = 0; j < steps; ++j) {
    const int64_t* sd = seeds + 2 * (static_cast<size_t>(j) * key_cols + kb);
    const wsfm::CounterNoise noise{static_cast<uint32_t>(sd[0]),
                                   static_cast<uint32_t>(sd[1]), c0};
    xr = wsfm::draw_row(lrow, vocab, xr, a[static_cast<size_t>(j) * a_cols + ab], temperature,
                        noise, lane);
  }
  if (lane == 0) out[row] = xr;
}

}  // namespace

extern "C" int ws_fused_launch(const void* logits, const void* x, const void* a,
                               const void* seeds, void* out, int rows, int vocab, int steps,
                               int key_group, int a_group, float temperature, void* stream) {
  if (rows <= 0 || vocab <= 0 || steps <= 0 || key_group <= 0 || a_group <= 0 ||
      rows % key_group != 0 || rows % a_group != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (rows + wsfm::kWarpsPerBlock - 1) / wsfm::kWarpsPerBlock;
  ws_fused_kernel<<<blocks, wsfm::kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const int32_t*>(x),
      static_cast<const float*>(a), static_cast<const int64_t*>(seeds),
      static_cast<int32_t*>(out), rows, vocab, steps, key_group, a_group, temperature);
  return static_cast<int>(cudaGetLastError());
}
