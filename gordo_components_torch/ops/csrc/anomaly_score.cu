// Fused anomaly-score epilogue for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of gordo_components_tpu/ops/pallas_score.py:
//   - _kernel / _pallas_score         (per-model epilogue, fused_anomaly_score)
//   - _banked_kernel / _pallas_banked_score (banked epilogue, banked_anomaly_score)
// Both compute, for every row of a (B, T, F) reconstruction,
//   diff   = |target - output|
//   scaled = (diff - shift[idx[b]]) * scale[idx[b]]
//   tot_u  = sqrt(sum_f diff^2),  tot_s = sqrt(sum_f scaled^2)
// The per-model form is the banked one with B = 1 and its own scaler rows.
//
// Bound: memory. The banked form reads 8*B*T*F bytes of target/output (plus
// B gathered scaler rows of 8*F bytes) and writes its packed result,
// 4*B*(3*T*F + 2*T) bytes, at about eight flops per element. At the serving
// shape B=64, T=64, F=10 that is about 0.86 MB, or 0.26 us at 3.35 TB/s, so
// one launch (about 1.5 us on an H100) dominates: the design keeps to one
// launch, one output buffer and a short chain of dependent loads.
//
// Output layouts. Each entry point writes one buffer, so its wrapper
// allocates once:
//   - banked (K2): (B, W), W = 3*T*F + 2*T; each slot's row holds output
//     (copied as read), diff, scaled (T*F each), tot_u, tot_s (T each): the
//     bank's packed result, which it copies to the host as it is;
//   - per model (K1): diff, scaled (rows*F each), tot_u, tot_s (rows each).
//
// Design. A group of G = next_pow2(F) lanes (at most 32) owns a row, so at
// F = 10 a warp scores two rows; its lanes stride over F with coalesced
// loads and stores and reduce the two sums of squares with shuffles inside
// the group. A block is 8 warps, 256 / G rows of one slot; the grid is (row
// blocks, B), and each warp reads its slot's member id and scaler rows
// itself (through L1), which replaces the TPU's scalar prefetch. Rows past T
// and features past F are bounds-checked; nothing is padded, so the TPU's
// 128-lane mask has no counterpart. The launch plan (G, rows a block, row
// blocks) is computed by the caller (ops/score.py: _launch_plan) and checked
// here.
//
// Two designs measured slower on an H100 at the serving shapes and were not
// kept (their times are in PERF.md): the slot's scaler rows in shared
// memory (a block barrier behind the idx -> scaler-row load chain, +0.25
// us), and the tile's target and output rows staged in shared memory by
// 16-byte cp.async copies with 16-byte stores (about twice the time).
//
// Numerics: diff and scaled use round-to-nearest intrinsics, so no FMA
// contraction can change them; they are bitwise equal to the elementwise
// PyTorch ops, and the output copy is the input's bits. The norms sum in
// another order than torch.sum, so they agree within a few ULP.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;  // a block: 8 warps

// Grid (row blocks, B); a block is 8 warps of 32/G rows. kCopy: the banked
// packed layout (output copy first); else the per-model layout.
template <int G, bool kCopy>
__global__ void __launch_bounds__(kThreads)
score_rows(const float* __restrict__ target, const float* __restrict__ output,
           const float* __restrict__ shift_bank,
           const float* __restrict__ scale_bank,
           const int32_t* __restrict__ idx, int T, int F,
           float* __restrict__ out) {
  constexpr int kRowsPerWarp = kWarp / G;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int t0 = (blockIdx.x * (kThreads / kWarp) + warp) * kRowsPerWarp;
  // t0 is uniform across the warp, so the whole warp leaves together and the
  // full-mask shuffles below stay valid
  if (t0 >= T) return;
  const int t = t0 + lane / G;
  const int f0 = lane % G;
  const bool row_ok = t < T;

  const int64_t m = idx == nullptr ? 0 : idx[b];
  const float* sh = shift_bank + m * F;
  const float* sc = scale_bank + m * F;
  const int64_t TF = static_cast<int64_t>(T) * F;
  const int64_t in = (static_cast<int64_t>(b) * T + t) * F;
  float* copy = out + b * ((kCopy ? 3 : 2) * TF + 2 * T);
  float* diff = copy + (kCopy ? TF : 0);
  float* scaled = diff + TF;
  const int64_t at = static_cast<int64_t>(t) * F;

  float sum_u = 0.0f;
  float sum_s = 0.0f;
  if (row_ok) {
    for (int f = f0; f < F; f += G) {
      const float o = output[in + f];
      const float d = fabsf(__fsub_rn(target[in + f], o));
      const float s = __fmul_rn(__fsub_rn(d, sh[f]), sc[f]);
      if (kCopy) copy[at + f] = o;
      diff[at + f] = d;
      scaled[at + f] = s;
      sum_u = __fadd_rn(sum_u, __fmul_rn(d, d));
      sum_s = __fadd_rn(sum_s, __fmul_rn(s, s));
    }
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    sum_u += __shfl_xor_sync(0xffffffffu, sum_u, off);
    sum_s += __shfl_xor_sync(0xffffffffu, sum_s, off);
  }
  if (row_ok && f0 == 0) {
    scaled[TF + t] = sqrtf(sum_u);      // tot_u
    scaled[TF + T + t] = sqrtf(sum_s);  // tot_s
  }
}

// Check the plan (group, tile rows a block, grid_x row blocks) against the
// shape and launch; cudaErrorInvalidValue for a plan that does not cover it.
template <bool kCopy>
cudaError_t launch(const float* target, const float* output,
                   const float* shift, const float* scale, const int32_t* idx,
                   int B, int T, int F, int group, int tile, int grid_x,
                   float* out, cudaStream_t st) {
  if (T == 0) return cudaSuccess;  // an empty result: nothing to launch
  if (B < 1 || B > 65535 || T < 1 || F < 1 || group < 1 || group > kWarp ||
      (group & (group - 1)) != 0 || (group < F && group < kWarp) ||
      tile != kThreads / group || grid_x < 1 ||
      static_cast<int64_t>(grid_x) * tile < T) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(grid_x, B);
#define GORDO_CASE(G)                                                      \
  case G:                                                                  \
    score_rows<G, kCopy><<<grid, kThreads, 0, st>>>(target, output, shift, \
                                                    scale, idx, T, F, out); \
    break;
  switch (group) {
    GORDO_CASE(1)
    GORDO_CASE(2)
    GORDO_CASE(4)
    GORDO_CASE(8)
    GORDO_CASE(16)
    GORDO_CASE(32)
  }
#undef GORDO_CASE
  return cudaGetLastError();
}

}  // namespace

// The banked epilogue of a (B, T, F) batch on `stream` (a cudaStream_t
// passed as a pointer), with the launch plan of ops/score.py: _launch_plan;
// returns the cudaError_t of the launch as an int, 0 on success. All
// pointers are device pointers to contiguous arrays: target/output (B, T, F)
// float32, shift_bank/scale_bank (M, F) float32, idx (B,) int32 with
// 0 <= idx < M; out (B, 3*T*F + 2*T) float32 receives the packed result.
// Requires 1 <= B <= 65535.
extern "C" int gordo_anomaly_score_banked(const float* target,
                                          const float* output,
                                          const float* shift_bank,
                                          const float* scale_bank,
                                          const int32_t* idx, int B, int T,
                                          int F, int group, int tile,
                                          int grid_x, float* out,
                                          void* stream) {
  return static_cast<int>(launch<true>(target, output, shift_bank, scale_bank,
                                       idx, B, T, F, group, tile, grid_x, out,
                                       static_cast<cudaStream_t>(stream)));
}

// The per-model epilogue of one (rows, F) reconstruction on `stream`, with
// the launch plan of ops/score.py: _launch_plan; returns the cudaError_t of
// the launch as an int. target/output (rows, F) and shift/scale (F,) are
// contiguous float32 device arrays; out holds 2*rows*(F + 1) floats and
// receives diff (rows, F), scaled (rows, F), tot_u (rows,) and tot_s (rows,)
// back to back.
extern "C" int gordo_anomaly_score_one(const float* target, const float* output,
                                       const float* shift, const float* scale,
                                       int rows, int F, int group, int tile,
                                       int grid_x, float* out, void* stream) {
  return static_cast<int>(launch<false>(target, output, shift, scale, nullptr,
                                        1, rows, F, group, tile, grid_x, out,
                                        static_cast<cudaStream_t>(stream)));
}
