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
// Bound: memory. It reads 8*B*T*F bytes of target/output (plus B gathered
// scaler rows of 8*F bytes) and writes 8*B*T*F + 8*B*T bytes, at about eight
// flops per element. At the serving shape B=64, T=64, F=10 that is about
// 0.7 MB, or 0.2 us at 3.35 TB/s, so one launch (a few us) dominates.
//
// Design: every input byte is read once and every output byte written once,
// with nothing staged through device memory in between (the TPU kernel's one
// VMEM pass). The grid is (row blocks, B); each block reads its slot's member
// id itself, which replaces the TPU's scalar prefetch. A group of G lanes
// owns one row (G a power of two, so a warp holds 32/G rows): its lanes
// stride over F with coalesced loads, write diff and scaled elementwise, and
// reduce the two sums of squares with shuffles inside the group. Rows past T
// and features past F are bounds-checked; nothing is padded, so the TPU's
// 128-lane mask has no counterpart.
//
// Two entry points. gordo_anomaly_score (banked, K2) keeps one warp a row
// (G = 32). gordo_anomaly_score_one (per model, K1) takes one (rows, F)
// reconstruction and its own scaler rows (null idx: the block reads shift
// and scale directly), picks G = next_pow2(F) up to 32, so at F = 10 a warp
// scores two rows instead of idling 22 of 32 lanes, and writes its four
// outputs into one buffer, so its wrapper allocates once. At one detector's
// request the launch and the wrapper's host work, not the device, set its
// time; the lean entry point is what lets the wrapper stay short.
//
// Numerics: diff and scaled use round-to-nearest intrinsics, so no FMA
// contraction can change them; they are bitwise equal to the elementwise
// PyTorch ops. The norms sum in another order than torch.sum, so they agree
// within a few ULP.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kWarp = 32;

template <int G>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
anomaly_score_kernel(const float* __restrict__ target,
                     const float* __restrict__ output,
                     const float* __restrict__ shift_bank,
                     const float* __restrict__ scale_bank,
                     const int32_t* __restrict__ idx,
                     int T, int F,
                     float* __restrict__ diff,
                     float* __restrict__ scaled,
                     float* __restrict__ tot_u,
                     float* __restrict__ tot_s) {
  constexpr int kRowsPerWarp = kWarp / G;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int t0 = (blockIdx.x * kWarpsPerBlock + warp) * kRowsPerWarp;
  // t0 is uniform across the warp, so the whole warp leaves together and the
  // full-mask shuffles below stay valid
  if (t0 >= T) return;
  const int t = t0 + lane / G;
  const int f0 = lane % G;
  const bool row_ok = t < T;

  const int64_t m = idx == nullptr ? 0 : idx[b];
  const float* sh = shift_bank + m * F;
  const float* sc = scale_bank + m * F;
  const int64_t row = (static_cast<int64_t>(b) * T + t);
  const int64_t base = row * F;

  float sum_u = 0.0f;
  float sum_s = 0.0f;
  if (row_ok) {
    for (int f = f0; f < F; f += G) {
      const float d = fabsf(__fsub_rn(target[base + f], output[base + f]));
      const float s = __fmul_rn(__fsub_rn(d, sh[f]), sc[f]);
      diff[base + f] = d;
      scaled[base + f] = s;
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
    tot_u[row] = sqrtf(sum_u);
    tot_s[row] = sqrtf(sum_s);
  }
}

template <int G>
cudaError_t launch(const float* target, const float* output, const float* shift,
                   const float* scale, const int32_t* idx, int B, int T, int F,
                   float* diff, float* scaled, float* tot_u, float* tot_s,
                   cudaStream_t stream) {
  constexpr int kRowsPerBlock = kWarpsPerBlock * (kWarp / G);
  const dim3 grid((T + kRowsPerBlock - 1) / kRowsPerBlock, B);
  anomaly_score_kernel<G><<<grid, kWarpsPerBlock * kWarp, 0, stream>>>(
      target, output, shift, scale, idx, T, F, diff, scaled, tot_u, tot_s);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer); returns the
// cudaError_t of the launch as an int, 0 on success. All pointers are device
// pointers to contiguous arrays: target/output/diff/scaled (B, T, F) float32,
// shift_bank/scale_bank (M, F) float32, idx (B,) int32 with 0 <= idx < M,
// tot_u/tot_s (B, T) float32. Requires 1 <= B <= 65535.
extern "C" int gordo_anomaly_score(const float* target, const float* output,
                                   const float* shift_bank,
                                   const float* scale_bank, const int32_t* idx,
                                   int B, int T, int F, float* diff,
                                   float* scaled, float* tot_u, float* tot_s,
                                   void* stream) {
  if (B <= 0 || T <= 0) return 0;
  return static_cast<int>(launch<kWarp>(
      target, output, shift_bank, scale_bank, idx, B, T, F, diff, scaled, tot_u,
      tot_s, static_cast<cudaStream_t>(stream)));
}

// The per-model epilogue of one (rows, F) reconstruction on `stream`;
// returns the cudaError_t of the launch as an int. target/output (rows, F)
// and shift/scale (F,) are contiguous float32 device arrays; out holds
// 2*rows*(F + 1) floats and receives diff (rows, F), scaled (rows, F),
// tot_u (rows,) and tot_s (rows,) back to back.
extern "C" int gordo_anomaly_score_one(const float* target, const float* output,
                                       const float* shift, const float* scale,
                                       int rows, int F, float* out,
                                       void* stream) {
  if (rows <= 0) return 0;
  const int64_t n = static_cast<int64_t>(rows) * F;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GORDO_ONE(G)                                                      \
  launch<G>(target, output, shift, scale, nullptr, 1, rows, F, out,       \
            out + n, out + 2 * n, out + 2 * n + rows, st)
  const cudaError_t err = F <= 1    ? GORDO_ONE(1)
                          : F <= 2  ? GORDO_ONE(2)
                          : F <= 4  ? GORDO_ONE(4)
                          : F <= 8  ? GORDO_ONE(8)
                          : F <= 16 ? GORDO_ONE(16)
                                    : GORDO_ONE(kWarp);
#undef GORDO_ONE
  return static_cast<int>(err);
}
