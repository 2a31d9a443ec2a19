// Fused phasor -> inverse real DFT, hand-written for Hopper (sm_90a) as a
// 3xTF32 GEMM on wgmma whose A operand is made on chip.
//
// Replaces the Pallas TPU kernel gennet_tpu/ops/phasor_dft.py::_phasor_kernel
// (launched by _phasor_pallas). For h~ = A e^{-i Psi} it computes
//
//   out[b, t] = sum_k A[b,k] cos(Psi[b,k]) C[k,t] + A[b,k] sin(Psi[b,k]) S[k,t]
//
// where C/S are columns of the inverse-rDFT tables (with an optional
// per-sample window folded in), i.e. the last step of every template's
// synthesis. The phasor (A cos Psi, A sin Psi) lives only in registers.
//
// What bounds it on the card: 4*B*K*T flops against 4*(2BK + 2KT + BT)
// bytes, ~400 flop/byte at the bank's pass B (B 4096, K 2049, T 1024):
// compute-bound. The products run on TF32 tensor cores, three per float32
// product (tf32_wgmma.cuh), under a 165 TFLOP/s ceiling of float32 work;
// the trig (full-range sincosf, ~40 instructions) runs once per (b, k) and
// output tile.
//
// Design: M = templates in tiles of 128 (a 64-row wgmma tile per consumer
// warpgroup, two consumer warpgroups), N = output samples in tiles of BN =
// 128 (masked past T), the reduction over bins in steps of 8, each step
// two 3xTF32 chains (re against C, im against S). Each step is summed in
// the wgmma accumulator and then added into float32 totals (tf32_wgmma.cuh
// says why); partial sums and totals of a 256-wide tile would take 256
// registers a thread, so the tile stops at 128 and the trig runs once per
// 128 output samples (8 times per (b, k) at pass B).
//
// A producer warpgroup fills two rings of shared-memory stages ahead of
// the consumers (tf32_wgmma.cuh has the roles): the table tiles, one step
// a stage, each with one bulk copy (the wrapper packs C and S as
// (T / BN, kp / 8, C|S, hi|lo, BN x 8 in core-matrix order), kp = K
// rounded up to 8, T padded to BN, with zeros: each stage is one contiguous
// block); and the amp/phase tiles, four steps (32 bins) a stage, with
// 16-byte cp.async. Rows of 2049 floats are not 16-byte aligned, so each
// row's 32 bins are copied as the 9 aligned 16-byte pieces that cover them
// and the consumers read them from the row's shift (its start mod 4), with
// bins past K (the next row's) read as zero. The
// consumers wait on a stage's full barrier; each thread reads its A
// fragment, forms a*cos and a*sin (skipping the trig where a == 0: below
// f_low the phase reaches ~1e13 rad and sincosf would take its slow path)
// and splits them in registers, the next step's while this step's products
// run; a stage is released on its empty barrier when its products are done.
// The two consumer warpgroups never wait for each other, so one's trig
// overlaps the other's products. Where the output tiles leave SMs idle
// (pass A: 32 tiles; ml_recenter: 1-8), the bin axis is split across blocks
// into a workspace that a second kernel sums in a fixed order: no atomics,
// so a call is bitwise reproducible.
//
// Accuracy: sincosf does full range reduction. Do not build this file with
// --use_fast_math: __sinf/__cosf lose accuracy as |Psi| grows, and the
// template phases reach 1e3-1e4 rad once the alignment ramp is added.

#include "tf32_wgmma.cuh"

namespace {

using namespace tf32x3;

constexpr int BM = 128;             // templates per block
constexpr int BN = 128;             // output samples per block
constexpr int A_STEPS = 4;          // steps of 8 bins per amp/phase stage
constexpr int A_PIECES = 9;         // 16-byte pieces that cover 32 bins at any shift
constexpr int A_ROW = 4 * A_PIECES; // row stride of a staged amp/phase tile
constexpr int A_FLOATS = 2 * BM * A_ROW;  // amp then phase
constexpr int A_STAGES = 2;
constexpr int SMEM_LIMIT = 232448;  // bytes of shared memory a block may use
constexpr int MAX_T_STAGES = 8;

struct Phasor {
  const float* amp;
  const float* phase;
  const float* tables;  // packed, see above
  float* out;           // (B, T), or the workspace (splits, B, T)
  int B, K, T;
  int n_steps, steps_per_split, t_stages;
};

// Floats of one table stage: C hi, C lo, S hi, S lo.
constexpr int T_FLOATS = 4 * BN * 8;

// Build one step's A fragments (re = a cos, im = a sin, split) from a
// staged amp/phase tile: ap[0] and ap[1] point at this thread's two rows
// (row start + shift + the step's first bin + kcol); bins from `left` on
// are past K.
__device__ __forceinline__ void phasor_fragment(SplitA& re, SplitA& im, const float* const (&ap)[2],
                                                int left) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* e = ap[i & 1] + 4 * (i >> 1);
    const float a = 4 * (i >> 1) < left ? e[0] : 0.f;
    float c = 0.f, s = 0.f;
    if (a != 0.f) {
      sincosf(e[BM * A_ROW], &s, &c);
      c *= a;
      s *= a;
    }
    split_tf32(c, re.hi[i], re.lo[i]);
    split_tf32(s, im.hi[i], im.lo[i]);
  }
}

__device__ __forceinline__ void phasor_mma(float (&acc)[BN / 2], const SplitA& re,
                                           const SplitA& im, const float* tab) {
  const uint64_t d = kmajor_desc(tab, BN);
  wgmma_fence();
  mma_3xtf32<BN>(acc, re, d, d + desc_step(BN), true);
  mma_3xtf32<BN>(acc, im, d + 2 * desc_step(BN), d + 3 * desc_step(BN), false);
  wgmma_commit();
}

__global__ void __launch_bounds__(THREADS, 1) phasor_kernel(const Phasor p) {
  extern __shared__ __align__(128) float smem[];
  float* a_ring = smem;                             // A_STAGES amp/phase stages
  float* t_ring = smem + A_STAGES * A_FLOATS;       // t_stages table stages
  uint64_t* a_full = reinterpret_cast<uint64_t*>(t_ring + p.t_stages * T_FLOATS);
  uint64_t* a_empty = a_full + A_STAGES;
  uint64_t* t_full = a_empty + A_STAGES;
  uint64_t* t_empty = t_full + p.t_stages;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int first = blockIdx.z * p.steps_per_split;  // a multiple of A_STEPS
  const int n_local = min(p.n_steps - first, p.steps_per_split);
  if (tid == 0) {
    for (int i = 0; i < A_STAGES; ++i) {
      mbar_init(&a_full[i], PRODUCERS);
      mbar_init(&a_empty[i], CONSUMERS / 32);
    }
    for (int i = 0; i < p.t_stages; ++i) {
      mbar_init(&t_full[i], 1);
      mbar_init(&t_empty[i], CONSUMERS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer warpgroup
    regs_shrink<PRODUCER_REGS>();
    const int pt = tid - CONSUMERS;
    const float* tab = p.tables + (static_cast<size_t>(blockIdx.x) * p.n_steps + first) * T_FLOATS;
    for (int s = 0; s < n_local; ++s) {
      if (s % A_STEPS == 0) {
        // amp/phase of bins k0 ... k0 + 31: row r's aligned pieces from the
        // piece that holds bin k0, zero past the end of the tensor
        const int a = s / A_STEPS, slot = a % A_STAGES;
        mbar_wait(&a_empty[slot], ((a / A_STAGES) & 1) ^ 1);
        const long long k0 = 8LL * (first + s), n = static_cast<long long>(p.B) * p.K;
        float* dst = a_ring + slot * A_FLOATS;
        for (int e = pt; e < 2 * BM * A_PIECES; e += PRODUCERS) {
          const int r = e / A_PIECES, j = e - r * A_PIECES;
          const int b = m0 + (r % BM);
          const float* src = r < BM ? p.amp : p.phase;
          const long long g = ((static_cast<long long>(b) * p.K + k0) & ~3LL) + 4 * j;
          const long long have = b < p.B ? n - g : 0;
          const int bytes = have >= 4 ? 16 : (have > 0 ? static_cast<int>(4 * have) : 0);
          cp_async16(dst + r * A_ROW + 4 * j, bytes ? src + g : src, bytes);
        }
        cp_async_arrive(&a_full[slot]);
      }
      const int slot = s % p.t_stages;
      if (pt == 0) {
        mbar_wait(&t_empty[slot], ((s / p.t_stages) & 1) ^ 1);
        bulk_load(t_ring + slot * T_FLOATS, tab + static_cast<size_t>(s) * T_FLOATS,
                  T_FLOATS * 4, &t_full[slot]);
      }
    }
    cp_async_wait_all();
    return;
  }

  // ---- consumer warpgroups
  regs_grow<CONSUMER_REGS>();
  const int lane = tid & 31, warp = (tid >> 5) & 3, wg = tid >> 7;
  float acc[BN / 2], total[BN / 2];  // wgmma partial sums of a step; float32 totals
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = total[i] = 0.f;
  SplitA re0, im0, re1, im1;
  const int mrow = wg * 64 + warp * 16 + (lane >> 2);
  const int kcol = lane & 3;
  // this thread's two rows in a staged amp/phase tile: row start + shift + kcol
  int row_off[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = mrow + 8 * h;
    row_off[h] = r * A_ROW + static_cast<int>((static_cast<long long>(m0 + r) * p.K) & 3) + kcol;
  }
  // step s: its A fragments into (re, im); returns its table stage
  auto fragment = [&](int s, SplitA& re, SplitA& im) {
    const int a = s / A_STEPS;
    if (s % A_STEPS == 0) mbar_wait(&a_full[a % A_STAGES], (a / A_STAGES) & 1);
    const float* base = a_ring + (a % A_STAGES) * A_FLOATS + 8 * (s % A_STEPS);
    const float* const ap[2] = {base + row_off[0], base + row_off[1]};
    phasor_fragment(re, im, ap, p.K - 8 * (first + s) - kcol);
    mbar_wait(&t_full[s % p.t_stages], (s / p.t_stages) & 1);
    return t_ring + (s % p.t_stages) * T_FLOATS;
  };
  // the products of step s are done: release its stages, add its sum
  auto finish = [&](int s) {
    wgmma_wait<0>();
    if (lane == 0) {
      mbar_arrive(&t_empty[s % p.t_stages]);
      if (s % A_STEPS == A_STEPS - 1 || s == n_local - 1)
        mbar_arrive(&a_empty[(s / A_STEPS) % A_STAGES]);
    }
    promote(total, acc);
  };
  const float* tab = fragment(0, re0, im0);
  for (int s = 0; s < n_local; s += 2) {
    phasor_mma(acc, re0, im0, tab);
    const float* next = s + 1 < n_local ? fragment(s + 1, re1, im1) : nullptr;
    finish(s);
    if (!next) break;
    phasor_mma(acc, re1, im1, next);
    tab = s + 2 < n_local ? fragment(s + 2, re0, im0) : nullptr;
    finish(s + 1);
  }

  float* out = p.out + static_cast<size_t>(blockIdx.z) * p.B * p.T;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int t = n0 + 8 * (i >> 2) + 2 * kcol + (i & 1);
    const int b = m0 + mrow + 8 * ((i >> 1) & 1);
    if (t < p.T && b < p.B) out[static_cast<size_t>(b) * p.T + t] = total[i];
  }
}

// out[i] = sum over splits of ws[split][i], in split order.
__global__ void sum_splits(const float* __restrict__ ws, float* __restrict__ out, size_t n,
                           int splits) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int j = 0; j < splits; ++j) s += ws[j * n + i];
    out[i] = s;
  }
}

// The bin-axis split: as many blocks as fit one per SM, each with a whole
// number of amp/phase stages.
void plan(int B, int K, int T, int& splits, int& per) {
  const int n_steps = (K + 7) / 8;
  const int blocks = ((T + BN - 1) / BN) * ((B + BM - 1) / BM);
  splits = sm_count() / blocks;
  splits = splits < 1 ? 1 : splits;
  per = (n_steps + splits - 1) / splits;
  per = (per + A_STEPS - 1) / A_STEPS * A_STEPS;
  splits = (n_steps + per - 1) / per;
}

int launch(Phasor p, int splits, cudaStream_t stream) {
  const int a_bytes = A_STAGES * (4 * A_FLOATS + 16);  // stages and their two barriers
  const int t_bytes = 4 * T_FLOATS + 16;
  p.t_stages = (SMEM_LIMIT - a_bytes) / t_bytes;
  p.t_stages = p.t_stages < MAX_T_STAGES ? p.t_stages : MAX_T_STAGES;
  const int smem = a_bytes + p.t_stages * t_bytes;
  cudaError_t err = cudaFuncSetAttribute(phasor_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.T + BN - 1) / BN, (p.B + BM - 1) / BM, splits);
  phasor_kernel<<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of workspace phasor_irdft_f32 needs at (B, K, T): 0 when the bin
// axis is not split.
extern "C" long long phasor_irdft_workspace(int B, int K, int T) {
  if (B <= 0 || K <= 0 || T <= 0) return 0;
  int splits, per;
  plan(B, K, T, splits, per);
  return splits > 1 ? static_cast<long long>(splits) * B * T : 0;
}

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError(): a launch the device refuses never runs, and only this
// code reports it. All pointers are float32, row-major and contiguous:
// amp/phase (B, K), each 16-byte aligned (the 16-byte copies find a row's
// shift from its element index); tables the packed C and S (ops/
// phasor_dft.py::pack_tables); out (B, T); ws as many floats as
// phasor_irdft_workspace() says (may be null when that is 0).
extern "C" int phasor_irdft_f32(const float* amp, const float* phase, const float* tables,
                                float* out, float* ws, int B, int K, int T, void* stream) {
  if (B <= 0 || K <= 0 || T <= 0 ||
      ((reinterpret_cast<uintptr_t>(amp) | reinterpret_cast<uintptr_t>(phase)) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  int splits, per;
  plan(B, K, T, splits, per);
  if (splits > 1 && ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Phasor p{};
  p.amp = amp;
  p.phase = phase;
  p.tables = tables;
  p.out = splits > 1 ? ws : out;
  p.B = B;
  p.K = K;
  p.T = T;
  p.n_steps = (K + 7) / 8;
  p.steps_per_split = per;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = launch(p, splits, s);
  if (rc != 0 || splits == 1) return rc;
  const size_t n = static_cast<size_t>(B) * T;
  const size_t want = (n + 255) / 256;
  sum_splits<<<static_cast<unsigned>(want < 4096 ? want : 4096), 256, 0, s>>>(ws, out, n, splits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gennet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
