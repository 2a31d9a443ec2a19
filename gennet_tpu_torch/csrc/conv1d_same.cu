// SAME 1-D convolution + bias + activation at any stride, hand-written for
// Hopper (sm_90a) as a 3xTF32 implicit GEMM on wgmma.
//
// Replaces the Pallas TPU kernel gennet_tpu/ops/pallas_conv1d.py::
// _conv1d_kernel (launched by conv1d_same). It computes
//
//   out[b, co, j] = act( sum_{k,ci} W[co, ci, k] * x[b, ci, j*s + k - pad_low] + bias[co] )
//
// with x zero outside [0, L), for j < L_out. Stride 1 with pad_low =
// (K-1)/2 is the TPU kernel's SAME conv; stride s with flax's pad_low is the
// strided layer computed natively (only the kept outputs). The layouts are
// the PyTorch port's: x (B, Cin, L), out (B, Cout, L_out). The backward's
// dx is this kernel at stride 1 with a weight packed flipped and transposed.
//
// What bounds it on the card: 2*B*L_out*K*Cin*Cout flops against
// 4*(B*(L*Cin + L_out*Cout) + 2*K*cin8*Cout) bytes, compute-bound at every
// wide layer. The products run on TF32 tensor cores, three per float32
// product (tf32_wgmma.cuh), so the ceiling is 165 TFLOP/s of float32 work,
// not the 67 of the FP32 pipes the plain cuDNN version is held to. Each
// M tile re-reads the weights from L2 (hi and lo: 8 bytes a weight), so a
// 128-row tile needs ~23 bytes a clock per SM at the tensor cores' rate,
// about what the L2 serves; two 64-row tiles per warpgroup halve that where
// the registers allow.
//
// Design: an implicit GEMM. M = output positions of one batch row, in
// tiles of BM = 128 * MT (MT 64-row wgmma tiles per consumer warpgroup, two
// consumer warpgroups; tf32_wgmma.cuh has the roles); N = Cout in a tile of BN in {8, ..., 128} fitted to
// the layer by the wrapper; the reduction runs over 8-channel chunks, and
// within a chunk over the K taps, one m64nBNk8 step each. Each chunk is
// summed in the wgmma accumulator and then added into float32 totals
// (tf32_wgmma.cuh says why), so a thread holds 2 * MT * BN / 2
// accumulators: MT = 2 only for BN <= 64. (A 256-wide tile would need 256,
// and its weight stage of 80 KB at K 5 would leave room for two stages.)
//
// A producer warpgroup fills a ring of shared-memory stages ahead of the
// consumers, one chunk a stage: the weight tiles with one bulk copy (the
// wrapper packs W as (Cout / BN, cin8 / 8, hi|lo, K, BN x 8 in core-matrix
// order), cin8 = Cin rounded up to 8 with zeros: each stage is one
// contiguous block), and the x window of the tile with 4-byte cp.async
// (positions j0*s - pad_low ... + (BM-1)*s + K, zero outside [0, L), stored
// split by phase (position mod s) so a tap reads consecutive rows at any
// stride). The consumers wait on the stage's full barrier, build each tap's
// A fragment (the im2col of x, never stored) from the window and split it in
// registers, the next tap's while this tap's products run, and release the
// stage on its empty barrier when its products are done. The two consumer
// warpgroups never wait for each other, so one's fragments overlap the
// other's products. Cin is streamed, so there is no bound on it. Bias and
// act are fused before the single store; ragged L_out and Cout are masked.
// No atomics: each output is summed by one thread in a fixed order, so a
// call is bitwise reproducible.
//
// The weight pack (split, padded, tiled; for dx also flipped and
// transposed) is made on the card by pack_weight_kernel, one launch: a
// training step re-packs every weight, and at batch 8 the step is bound by
// the host, where a pack in torch ops would cost ~20 launches.

#include "tf32_wgmma.cuh"

namespace {

using namespace tf32x3;

constexpr int SMEM_LIMIT = 232448;  // bytes of shared memory a block may use
constexpr int MAX_STAGES = 4;

enum Act { ACT_NONE = 0, ACT_TANH = 1, ACT_LEAKY_RELU = 2, ACT_RELU = 3 };

struct Conv {
  const float* x;
  const float* w;  // packed, see above
  const float* bias;
  float* out;
  int L, Cin, Cout, K, stride, pad_low, L_out;
  int cin8, n_chunks, m_tiles;  // m_tiles: M tiles per batch row
  int win, wph, xw;             // window positions, per-phase length, row stride
  int stage_floats, stages;
  int act;
  float slope;
};

__device__ __forceinline__ float apply_act(float y, int act, float slope) {
  switch (act) {
    case ACT_TANH: return tanhf(y);
    case ACT_LEAKY_RELU: return y >= 0.f ? y : slope * y;
    case ACT_RELU: return fmaxf(y, 0.f);
    default: return y;
  }
}

// One tap of a chunk: wait for the products that last read `a` (two taps
// back), build the tap's A fragments from the window (xk: this thread's
// first element at this tap), issue 3 * MT wgmmas (the chunk's first tap
// restarts the partial sums).
template <int BN, int MT>
__device__ __forceinline__ void conv_tap(float (&acc)[MT][BN / 2], SplitA (&a)[MT],
                                         const float* xk, int xw4, uint64_t dh, uint64_t dl,
                                         bool fresh) {
  wgmma_wait<1>();
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i)  // row + 8 (i & 1), channel + 4 (i >> 1)
      split_tf32(xk[t * 64 + 8 * (i & 1) + (i >> 1) * xw4], a[t].hi[i], a[t].lo[i]);
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < MT; ++t) mma_3xtf32<BN>(acc[t], a[t], dh, dl, fresh);
  wgmma_commit();
}

template <int BN, int MT>
__global__ void __launch_bounds__(THREADS, 1) conv1d_kernel(const Conv p) {
  constexpr int BM = 128 * MT;
  constexpr int R = BN / 2;
  extern __shared__ __align__(128) float smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.stages * p.stage_floats);
  uint64_t* empty = full + p.stages;
  const int tid = threadIdx.x;
  const int b = blockIdx.x / p.m_tiles;
  const int j0 = (blockIdx.x % p.m_tiles) * BM;
  const int co0 = blockIdx.y * BN;
  const int wtile = p.K * BN * 8;  // floats of one weight tile (hi or lo) of a chunk
  if (tid == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(&full[i], PRODUCERS + 1);
      mbar_init(&empty[i], CONSUMERS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer warpgroup: chunk c (input channels 8c ... 8c + 7) into
    // slot c % stages; neighbouring threads copy neighbouring positions
    regs_shrink<PRODUCER_REGS>();
    const int pt = tid - CONSUMERS;
    const int q0 = j0 * p.stride - p.pad_low;  // input position of window entry 0
    const float* xb = p.x + static_cast<size_t>(b) * p.Cin * p.L;
    const float* wb = p.w + static_cast<size_t>(blockIdx.y) * p.n_chunks * 2 * wtile;
    for (int c = 0; c < p.n_chunks; ++c) {
      const int slot = c % p.stages;
      mbar_wait(&empty[slot], ((c / p.stages) & 1) ^ 1);
      float* xs = smem + slot * p.stage_floats;
      if (pt == 0)
        bulk_load(xs + 8 * p.xw, wb + static_cast<size_t>(c) * 2 * wtile, 8 * wtile, &full[slot]);
      const int rows = min(8, p.Cin - 8 * c);
      for (int q = pt; q < p.win; q += PRODUCERS) {
        const int pos = q0 + q;
        const bool in = pos >= 0 && pos < p.L;
        const float* src = xb + static_cast<size_t>(8 * c) * p.L + pos;
        float* dst = xs + (q % p.stride) * p.wph + q / p.stride;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const bool ok = in && r < rows;
          cp_async4(dst + r * p.xw, ok ? src + static_cast<size_t>(r) * p.L : p.x, ok);
        }
      }
      cp_async_arrive(&full[slot]);
    }
    cp_async_wait_all();
    return;
  }

  // ---- consumer warpgroups
  regs_grow<CONSUMER_REGS>();
  const int lane = tid & 31, warp = (tid >> 5) & 3, wg = tid >> 7;
  float acc[MT][R], total[MT][R];  // wgmma partial sums of a chunk; float32 totals
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int i = 0; i < R; ++i) acc[t][i] = total[t][i] = 0.f;
  SplitA a0[MT], a1[MT];
  const int mrow = wg * 64 * MT + warp * 16 + (lane >> 2);
  const int kcol = lane & 3;
  const int xw4 = 4 * p.xw;
  for (int c = 0; c < p.n_chunks; ++c) {
    const int slot = c % p.stages;
    mbar_wait(&full[slot], (c / p.stages) & 1);
    const float* xs = smem + slot * p.stage_floats + kcol * p.xw + mrow;
    uint64_t dh = kmajor_desc(smem + slot * p.stage_floats + 8 * p.xw, BN);
    uint64_t dl = dh + desc_step(BN) * p.K;
    // tap k reads window entry m*s + k, stored at (k % s) * wph + m + k / s
    int phase = 0, shift = 0;
    for (int k = 0; k < p.K; k += 2) {
      conv_tap<BN, MT>(acc, a0, xs + phase * p.wph + shift, xw4, dh, dl, k == 0);
      if (++phase == p.stride) phase = 0, ++shift;
      if (k + 1 < p.K) {
        conv_tap<BN, MT>(acc, a1, xs + phase * p.wph + shift, xw4, dh + desc_step(BN),
                         dl + desc_step(BN), false);
        if (++phase == p.stride) phase = 0, ++shift;
      }
      dh += 2 * desc_step(BN);
      dl += 2 * desc_step(BN);
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&empty[slot]);  // this warp is done with the stage
#pragma unroll
    for (int t = 0; t < MT; ++t) promote(total[t], acc[t]);
  }

#pragma unroll
  for (int t = 0; t < MT; ++t) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int co = co0 + 8 * (i >> 2) + 2 * kcol + (i & 1);
      const int j = j0 + mrow + t * 64 + 8 * ((i >> 1) & 1);
      if (co < p.Cout && j < p.L_out)
        p.out[(static_cast<size_t>(b) * p.Cout + co) * p.L_out + j] =
            apply_act(total[t][i] + (p.bias ? p.bias[co] : 0.f), p.act, p.slope);
    }
  }
}

// The N tiles the kernel is built for.
bool valid_tile(int BN) { return BN == 8 || BN == 16 || BN == 32 || BN == 64 || BN == 128; }

template <int BN, int MT>
int launch(Conv p, int B, cudaStream_t stream) {
  constexpr int BM = 128 * MT;
  p.m_tiles = (p.L_out + BM - 1) / BM;
  p.win = (BM - 1) * p.stride + p.K;
  p.wph = (p.win + p.stride - 1) / p.stride;
  p.xw = p.stride * p.wph;
  p.xw += (40 - p.xw % 32) % 32;  // row stride = 8 mod 32: fragment reads hit 32 banks
  p.stage_floats = 8 * p.xw + 2 * p.K * BN * 8;
  const int stage_bytes = 4 * p.stage_floats + 16;  // and its two barriers
  p.stages = SMEM_LIMIT / stage_bytes < MAX_STAGES ? SMEM_LIMIT / stage_bytes : MAX_STAGES;
  if (p.stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = p.stages * stage_bytes;
  cudaError_t err = cudaFuncSetAttribute(conv1d_kernel<BN, MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(B) * p.m_tiles;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), (p.Cout + BN - 1) / BN);
  conv1d_kernel<BN, MT><<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Two 64-row tiles per warpgroup where the registers allow and that still
// gives every SM a block: twice the reuse of each staged weight tile.
template <int BN>
int launch_fitted(const Conv& p, int B, cudaStream_t stream) {
  if constexpr (BN < 128) {
    const long long wide = static_cast<long long>(B) * ((p.L_out + 255) / 256) *
                           ((p.Cout + BN - 1) / BN);
    if (wide >= sm_count()) return launch<BN, 2>(p, B, stream);
  }
  return launch<BN, 1>(p, B, stream);
}

// hi, lo of x as ops/tf32.py::split_tf32 makes them, on the bit pattern.
__device__ __forceinline__ void split_bits(float x, float& hi, float& lo) {
  const uint32_t bits = __float_as_uint(x);
  float h = __uint_as_float((bits + 0x1000u) & 0xFFFFE000u);
  if (isfinite(x) && !isfinite(h)) h = __uint_as_float(bits & 0xFFFFE000u);
  if (isnan(x)) h = x;
  hi = h;
  lo = isfinite(x) ? x - h : 0.f;
}

// The weight pack, one thread per element of a hi tile: element `in` of
// chunk `chunk` (= N tile * n_chunks + c) is (tap k, half kh of the 8
// channels, row group g, row r, channel q) of the layout in the header.
__global__ void pack_weight_kernel(const float* __restrict__ w, float* __restrict__ out,
                                   int Cout, int Cin, int K, int BN, int transposed,
                                   int n_chunks, long long total) {
  const int tile = K * BN * 8;  // floats of one half (hi or lo) of a chunk
  const int rows = transposed ? Cin : Cout, chans = transposed ? Cout : Cin;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < total;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long chunk = e / tile;
    const int in = static_cast<int>(e - chunk * tile);
    const int q = in & 3, r = (in >> 2) & 7, rest = in >> 5;
    const int g = rest % (BN / 8), kh = (rest / (BN / 8)) & 1, k = rest / (BN / 8) >> 1;
    const int n = static_cast<int>(chunk / n_chunks) * BN + 8 * g + r;
    const int ci = static_cast<int>(chunk % n_chunks) * 8 + 4 * kh + q;
    float v = 0.f;
    if (n < rows && ci < chans)  // the dx form: taps flipped, channels swapped
      v = transposed ? w[(static_cast<size_t>(ci) * Cin + n) * K + (K - 1 - k)]
                     : w[(static_cast<size_t>(n) * Cin + ci) * K + k];
    float* o = out + chunk * 2 * tile + in;
    split_bits(v, o[0], o[tile]);
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments the kernel does
// not take. All pointers are float32, contiguous: x (B, Cin, L); w the
// packed weight (ops/conv1d.py::pack_weight at tile width BN, one of 8, 16,
// 32, 64, 128); bias (Cout), or null for none; out (B, Cout, L_out). K is
// any odd tap count up to 9.
extern "C" int conv1d_same_f32(const float* x, const float* w, const float* bias, float* out,
                               int B, int L, int Cin, int Cout, int K, int stride, int pad_low,
                               int L_out, int BN, int act, float slope, void* stream) {
  if (B <= 0 || L <= 0 || Cin <= 0 || Cout <= 0 || L_out <= 0 || stride <= 0 || K <= 0 ||
      K > 9 || K % 2 == 0 || pad_low < 0 || act < ACT_NONE || act > ACT_RELU)
    return static_cast<int>(cudaErrorInvalidValue);
  Conv p{};
  p.x = x;
  p.w = w;
  p.bias = bias;
  p.out = out;
  p.L = L;
  p.Cin = Cin;
  p.Cout = Cout;
  p.K = K;
  p.stride = stride;
  p.pad_low = pad_low;
  p.L_out = L_out;
  p.cin8 = (Cin + 7) / 8 * 8;
  p.n_chunks = p.cin8 / 8;
  p.act = act;
  p.slope = slope;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (BN) {
    case 8: return launch_fitted<8>(p, B, s);
    case 16: return launch_fitted<16>(p, B, s);
    case 32: return launch_fitted<32>(p, B, s);
    case 64: return launch_fitted<64>(p, B, s);
    case 128: return launch_fitted<128>(p, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Writes the packed weight conv1d_same_f32 takes (ops/conv1d.py::
// pack_weight(w, transposed), bit for bit) in one launch on `stream`: w
// (Cout, Cin, K) contiguous float32; out as many floats as that pack has at
// tile width BN (the tile of Cin with `transposed`, of Cout without).
extern "C" int conv1d_pack_weight_f32(const float* w, float* out, int Cout, int Cin, int K,
                                      int BN, int transposed, void* stream) {
  if (Cout <= 0 || Cin <= 0 || K <= 0 || !valid_tile(BN))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = transposed ? Cin : Cout, chans = transposed ? Cout : Cin;
  const int n_chunks = (chans + 7) / 8;
  const long long total = static_cast<long long>((rows + BN - 1) / BN) * n_chunks * K * BN * 8;
  const long long want = (total + 255) / 256;
  pack_weight_kernel<<<static_cast<unsigned>(want < 4096 ? want : 4096), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(w, out, Cout, Cin, K, BN, transposed,
                                                           n_chunks, total);
  return static_cast<int>(cudaGetLastError());
}
