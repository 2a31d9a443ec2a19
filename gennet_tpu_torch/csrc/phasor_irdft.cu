// Fused phasor -> inverse real DFT, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gennet_tpu/ops/phasor_dft.py::_phasor_kernel
// (launched by _phasor_pallas). For h~ = A e^{-i Psi} it computes
//
//   out[b, t] = sum_k A[b,k] cos(Psi[b,k]) C[k,t] + A[b,k] sin(Psi[b,k]) S[k,t]
//
// where C/S are columns of the inverse-rDFT tables (with an optional
// per-sample window folded in), i.e. the last step of every template's
// synthesis. The phasor (A cos Psi, A sin Psi) is formed in shared memory one
// K-step at a time and never written to device memory.
//
// What bounds it on the card: about 4*B*K*T flops against
// 4*(2BK + 2KT + BT) bytes. At the bank's pass-B shape (B = 4096, K = 2049,
// T = 1024) that is 34 GFLOP against 84 MB, ~400 flop/byte, so it is
// compute-bound on the FP32 pipes (no tensor cores: plain FP32 FMA keeps
// full float32 accuracy, which the peak search and the 2e-5 tolerance need).
// The C/S tables are ~16.8 MB at pass B and stay in the 50 MB L2 across row
// tiles. The trig is recomputed once per (b, k) for every column tile, i.e.
// ceil(T/64) times (16 at pass B); bins with A == 0 (outside the band, where
// Psi reaches ~1e13 and sincosf would take its slow reduction path) skip it.
//
// Design: one 256-thread block owns a 64 x 64 output tile, each thread a
// 4 x 4 register micro-tile accumulated in float32. A loop over K in steps of
// 16 replaces the TPU kernel's sequential third grid axis. The ragged B, K
// and T edges are masked here (zero phasor / zero table entries), so callers
// pass the unpadded N//2+1 bins and any batch size.
//
// Accuracy: sincosf does full range reduction. Do not build this file with
// --use_fast_math: __sinf/__cosf lose accuracy as |Psi| grows, and the
// template phases reach 1e3-1e4 rad once the alignment ramp is added.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;   // rows (templates) per block
constexpr int BN = 64;   // output samples per block
constexpr int BK = 16;   // frequency bins per K-step
constexpr int TM = 4;    // rows per thread
constexpr int TN = 4;    // samples per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int PAD = 4;   // keeps float4 alignment, spreads the phasor stores over banks

__global__ void __launch_bounds__(THREADS)
phasor_irdft_kernel(const float* __restrict__ amp, const float* __restrict__ phase,
                    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                    float* __restrict__ out, int B, int K, int T) {
  __shared__ __align__(16) float s_re[BK][BM + PAD];
  __shared__ __align__(16) float s_im[BK][BM + PAD];
  __shared__ __align__(16) float s_c[BK][BN];
  __shared__ __align__(16) float s_s[BK][BN];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int ty = tid / (BN / TN);
  const int tx = tid % (BN / TN);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // phasor tile (BM x BK): neighbouring threads read neighbouring bins
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BK, kk = e % BK;
      const int b = row0 + r, k = k0 + kk;
      float re = 0.f, im = 0.f;
      if (b < B && k < K) {
        const size_t idx = static_cast<size_t>(b) * K + k;
        const float a = amp[idx];
        if (a != 0.f) {
          float s, c;
          sincosf(phase[idx], &s, &c);
          re = a * c;
          im = a * s;
        }
      }
      s_re[kk][r] = re;
      s_im[kk][r] = im;
    }
    // table tiles (BK x BN): neighbouring threads read neighbouring samples
#pragma unroll
    for (int i = 0; i < (BK * BN) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int kk = e / BN, c = e % BN;
      const int k = k0 + kk, t = col0 + c;
      const bool ok = k < K && t < T;
      const size_t idx = static_cast<size_t>(k) * T + t;
      s_c[kk][c] = ok ? cos_t[idx] : 0.f;
      s_s[kk][c] = ok ? sin_t[idx] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 re4 = *reinterpret_cast<const float4*>(&s_re[kk][ty * TM]);
      const float4 im4 = *reinterpret_cast<const float4*>(&s_im[kk][ty * TM]);
      const float4 c4 = *reinterpret_cast<const float4*>(&s_c[kk][tx * TN]);
      const float4 s4 = *reinterpret_cast<const float4*>(&s_s[kk][tx * TN]);
      const float re[TM] = {re4.x, re4.y, re4.z, re4.w};
      const float im[TM] = {im4.x, im4.y, im4.z, im4.w};
      const float cv[TN] = {c4.x, c4.y, c4.z, c4.w};
      const float sv[TN] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] = fmaf(re[i], cv[j], acc[i][j]);
          acc[i][j] = fmaf(im[i], sv[j], acc[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int b = row0 + ty * TM + i;
    if (b >= B) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int t = col0 + tx * TN + j;
      if (t < T) out[static_cast<size_t>(b) * T + t] = acc[i][j];
    }
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError(): a launch the device refuses never runs, and only this
// code reports it. All pointers are float32, row-major and contiguous:
// amp/phase (B, K), cos_t/sin_t (K, T), out (B, T).
extern "C" int phasor_irdft_f32(const float* amp, const float* phase, const float* cos_t,
                                const float* sin_t, float* out, int B, int K, int T,
                                void* stream) {
  if (B <= 0 || T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((T + BN - 1) / BN, (B + BM - 1) / BM);
  phasor_irdft_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      amp, phase, cos_t, sin_t, out, B, K, T);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gennet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
