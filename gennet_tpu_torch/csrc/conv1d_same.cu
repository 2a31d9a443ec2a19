// SAME stride-1 1-D convolution + bias + activation, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel gennet_tpu/ops/pallas_conv1d.py::
// _conv1d_kernel (launched by conv1d_same). It computes
//
//   out[b, co, l] = act( sum_{ci,k} x_pad[b, ci, l + k] * W[k, ci, co] + bias[co] )
//
// with x_pad zero-padded by (K-1)/2 on both sides (K odd) and
// act in {none, tanh, leaky_relu(slope), relu} fused before the single store.
// The layouts are the PyTorch port's: x (B, Cin, L) and out (B, Cout, L);
// W is (K, Cin, Cout), the tap-major layout the wrapper makes from a
// (Cout, Cin, K) Conv1d weight, so a tile of output channels reads
// contiguous memory. The same kernel computes the backward's dx with taps
// flipped and channels transposed (the wrapper builds that W).
//
// What bounds it on the card: 2*B*L*K*Cin*Cout flops against
// 4*(B*L*(Cin + Cout) + K*Cin*Cout) bytes. At the flagship's widest layer
// (G Conv_4: B 8, L 1024, Cin 512, Cout 1024, K 5) that is 43 GFLOP against
// 60 MB, ~700 flop/byte: compute-bound on the FP32 pipes. Plain FP32 FMA, no
// TF32: the port holds float32 parity with the reference.
//
// Design, in the shape of the TPU kernel: one haloed row window of x,
// (Cin, BL + K - 1), is loaded into shared memory once per (batch, L-block)
// and reused across every output-channel tile the block walks (the Pallas
// kernel DMA'd the same window once and reused it across its Cout grid
// axis). The block then streams W through shared memory in chunks of BC
// input channels, double-buffered: each thread fetches its share of the
// next chunk into registers while the block computes on the current one,
// so the L2 latency of the W stream hides behind the FMAs even at the one
// or two blocks per SM that a wide window leaves room for. Each thread
// keeps a TM x TN (channels x positions) register tile; per input channel
// it loads its TN + K - 1 window values once and reuses them for all K
// taps, so one channel costs 2 + K float4 shared-memory loads for TM*TN*K
// FMAs. Ragged L, Cin and Cout are masked here (zeros in the window and the
// W chunks, guarded stores), so nothing is padded to 8/128 as on the TPU.
// The whole-Cin window bounds Cin: with BL = 32 and K = 5 it is 144 bytes
// per input channel, so Cin <= 1329 fits the 227 KB a block may use beside
// the two W buffers (the flagship's widest input is 1024). A launch that
// does not fit returns cudaErrorInvalidValue.
//
// When B * ceil(L/BL) blocks would not fill the card (batch 8 at L 512 gives
// 128 blocks for 132 SMs) the output-channel tiles are split over
// gridDim.y groups, each loading its own copy of the window.

#include <cuda_runtime.h>

namespace {

constexpr int BL = 32;                  // output positions per block
constexpr int BM = 128;                 // output channels per tile
constexpr int BC = 8;                   // input channels per W chunk
constexpr int TN = 4;                   // positions per thread
constexpr int TM = 4;                   // output channels per thread
constexpr int TX = BL / TN;             // 8 threads along positions
constexpr int TY = BM / TM;             // 32 threads along channels
constexpr int THREADS = TX * TY;        // 256
constexpr int SMEM_LIMIT = 232448;      // bytes of shared memory a block may use
constexpr int MIN_BLOCKS = 264;         // two waves of 132 SMs

enum Act { ACT_NONE = 0, ACT_TANH = 1, ACT_LEAKY_RELU = 2, ACT_RELU = 3 };

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// Shared-memory row length of the x window: BL + K - 1 positions, rounded
// to whole float4s so every row starts 16-byte aligned.
__host__ __device__ constexpr int window_width(int K) { return round4(BL + K - 1); }

// Floats in one W chunk (BC input channels x K taps x BM output channels),
// and each thread's share of it.
__host__ __device__ constexpr int chunk_size(int K) { return BC * K * BM; }
static_assert((BC * BM) % THREADS == 0, "a W chunk splits evenly over the threads");

// This thread's share of the W chunk [ci0, ci0 + BC) x all taps x
// [co0, co0 + BM), zero outside Cin and Cout; neighbouring threads read
// neighbouring output channels. Element e of the chunk is (cl, k, co) with
// e = (cl * K + k) * BM + co.
template <int K>
__device__ __forceinline__ void fetch_chunk(float (&reg)[chunk_size(K) / THREADS],
                                            const float* __restrict__ w, int tid, int co0,
                                            int ci0, int Cin, int Cout) {
#pragma unroll
  for (int i = 0; i < chunk_size(K) / THREADS; ++i) {
    const int e = tid + i * THREADS;
    const int co = e % BM, r = e / BM;
    const int ci = ci0 + r / K, k = r % K, c = co0 + co;
    reg[i] = (ci < Cin && c < Cout) ? w[(static_cast<size_t>(k) * Cin + ci) * Cout + c] : 0.f;
  }
}

template <int K>
__device__ __forceinline__ void stash_chunk(float* __restrict__ buf,
                                            const float (&reg)[chunk_size(K) / THREADS],
                                            int tid) {
#pragma unroll
  for (int i = 0; i < chunk_size(K) / THREADS; ++i) buf[tid + i * THREADS] = reg[i];
}

__device__ __forceinline__ float apply_act(float y, int act, float slope) {
  switch (act) {
    case ACT_TANH: return tanhf(y);
    case ACT_LEAKY_RELU: return y >= 0.f ? y : slope * y;
    case ACT_RELU: return fmaxf(y, 0.f);
    default: return y;
  }
}

template <int K>
__global__ void __launch_bounds__(THREADS)
conv1d_same_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int L, int Cin, int Cout, int n_lblocks, int act, float slope) {
  constexpr int XW = window_width(K);
  constexpr int XR = round4(TN + K - 1);  // window values a thread reads per channel
  constexpr int PAD = (K - 1) / 2;
  constexpr int WC = chunk_size(K);
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                       // [Cin][XW]
  float* ws = smem + Cin * XW;            // [2][BC][K][BM]: two W chunk buffers

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int lb = blockIdx.x % n_lblocks;
  const int b = blockIdx.x / n_lblocks;
  const int l0 = lb * BL;

  // ---- the haloed window: x[b, :, l0 - PAD : l0 - PAD + XW], zero outside [0, L)
  const float* xb = x + static_cast<size_t>(b) * Cin * L;
  for (int e = tid; e < Cin * XW; e += THREADS) {
    const int ci = e / XW, j = e % XW;
    const int l = l0 - PAD + j;
    xs[e] = (l >= 0 && l < L) ? xb[static_cast<size_t>(ci) * L + l] : 0.f;
  }

  const int n_tiles = (Cout + BM - 1) / BM;
  const int n_chunks = (Cin + BC - 1) / BC;
  float reg[WC / THREADS];
  for (int tile = blockIdx.y; tile < n_tiles; tile += gridDim.y) {
    const int co0 = tile * BM;
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    // every thread is past the previous tile's last read of both buffers
    fetch_chunk<K>(reg, w, tid, co0, 0, Cin, Cout);
    stash_chunk<K>(ws, reg, tid);
    __syncthreads();

    for (int c = 0; c < n_chunks; ++c) {
      const int ci0 = c * BC;
      const float* cur = ws + (c & 1) * WC;
      const bool more = c + 1 < n_chunks;
      if (more) fetch_chunk<K>(reg, w, tid, co0, ci0 + BC, Cin, Cout);  // in flight below

      const int nc = min(BC, Cin - ci0);
      for (int cl = 0; cl < nc; ++cl) {
        float xr[XR];
        const float* xrow = xs + (ci0 + cl) * XW + tx * TN;
#pragma unroll
        for (int q = 0; q < XR / 4; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(xrow + 4 * q);
          xr[4 * q] = v.x;
          xr[4 * q + 1] = v.y;
          xr[4 * q + 2] = v.z;
          xr[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float4 w4 = *reinterpret_cast<const float4*>(cur + (cl * K + k) * BM + ty * TM);
          const float wv[TM] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(wv[i], xr[j + k], acc[i][j]);
        }
      }
      // the other buffer was last read in iteration c - 1, before its barrier
      if (more) stash_chunk<K>(ws + ((c + 1) & 1) * WC, reg, tid);
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int c = co0 + ty * TM + i;
      if (c >= Cout) continue;
      const float bc = bias[c];
      float* orow = out + (static_cast<size_t>(b) * Cout + c) * L;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int l = l0 + tx * TN + j;
        if (l < L) orow[l] = apply_act(acc[i][j] + bc, act, slope);
      }
    }
  }
}

template <int K>
int launch(const float* x, const float* w, const float* bias, float* out, int B, int L,
           int Cin, int Cout, int act, float slope, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(Cin) * window_width(K) + 2 * chunk_size(K));
  if (smem > static_cast<size_t>(SMEM_LIMIT)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(conv1d_same_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_lblocks = (L + BL - 1) / BL;
  const long long blocks = static_cast<long long>(B) * n_lblocks;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (Cout + BM - 1) / BM;
  int groups = static_cast<int>((MIN_BLOCKS + blocks - 1) / blocks);
  groups = groups < 1 ? 1 : (groups > n_tiles ? n_tiles : groups);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(groups));
  conv1d_same_kernel<K><<<grid, THREADS, smem, stream>>>(x, w, bias, out, L, Cin, Cout,
                                                         n_lblocks, act, slope);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Largest Cin whose window fits a block's shared memory at tap count K
// (0 for an unsupported K); the wrapper checks it before launching.
extern "C" int conv1d_same_max_cin(int K) {
  if (K != 1 && K != 3 && K != 5 && K != 7 && K != 9) return 0;
  return (SMEM_LIMIT / static_cast<int>(sizeof(float)) - 2 * chunk_size(K)) / window_width(K);
}

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments the kernel does
// not take (K not in {1, 3, 5, 7, 9}, act unknown, Cin too large for the
// window). All pointers are float32, contiguous: x (B, Cin, L),
// w (K, Cin, Cout), bias (Cout), out (B, Cout, L).
extern "C" int conv1d_same_f32(const float* x, const float* w, const float* bias, float* out,
                               int B, int L, int Cin, int Cout, int K, int act, float slope,
                               void* stream) {
  if (B <= 0 || L <= 0 || Cin <= 0 || Cout <= 0 || act < ACT_NONE || act > ACT_RELU)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: return launch<1>(x, w, bias, out, B, L, Cin, Cout, act, slope, s);
    case 3: return launch<3>(x, w, bias, out, B, L, Cin, Cout, act, slope, s);
    case 5: return launch<5>(x, w, bias, out, B, L, Cin, Cout, act, slope, s);
    case 7: return launch<7>(x, w, bias, out, B, L, Cin, Cout, act, slope, s);
    case 9: return launch<9>(x, w, bias, out, B, L, Cin, Cout, act, slope, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
