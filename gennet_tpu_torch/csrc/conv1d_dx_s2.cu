// Input gradient (dx) of a stride-2 1-D convolution, hand-written for Hopper
// (sm_90a) as a 3xTF32 implicit GEMM on wgmma.
//
// It replaces no TPU kernel: the JAX package leaves this gradient to XLA.
// It was added because cuDNN's float32 dgrad for stride 2, under the
// deterministic algorithms the port pins, runs the PE's q branch at ~2.5%
// of its bound (models/layers.py::Conv1d routes its stride-2 float32 layers
// here on a card). For y = conv1d(x, w, stride 2), x of length L (the input
// F.conv1d saw: padded for SAME) and dy of length Ly = (L - K) / 2 + 1,
//
//   dx[b, ci, t] = sum_{co, k : t - k even} w[co, ci, k] * dy[b, co, (t - k) / 2]
//
// with dy zero outside [0, Ly). Split by the parity p of t = 2m + p, each
// half is a dense stride-1 correlation over dy, with no zero-stuffed dy and
// no zero tap:
//
//   dx[b, ci, 2m + p] = sum_{co} sum_{u < Kp} Wp[ci, co, u] * dy[b, co, m - (Kp - 1) + u]
//   Wp[ci, co, u] = w[co, ci, p + 2 (Kp - 1 - u)],   Kp = (K + 1 - p) / 2
//
// (3 taps for the even half and 2 for the odd one at K 5).
//
// What bounds it on the card: 2*B*Cin*Cout*(M0*K0 + M1*K1) flops (Mp the
// outputs of parity p in a batch row) against 4*(B*(Cout*Ly + Cin*L) +
// Cout*Cin*K) bytes, compute-bound at every layer the port routes here.
// The products run on TF32 tensor cores, three per float32 product
// (tf32_wgmma.cuh), so the ceiling is 165 TFLOP/s of float32 work, not the
// 67 of the FP32 pipes cuDNN's FP32 dgrad is held to.
//
// Design: conv1d_same.cu's implicit GEMM, once per parity. The grid's z is
// the parity; M = the outputs m of one batch row and parity in tiles of BM =
// 128 * MT; N = Cin in a tile of BN in {8, ..., 128} chosen by the wrapper;
// the reduction runs over 8-channel chunks of Cout and, within a chunk, over
// the parity's Kp taps, one m64nBNk8 step each. A producer warpgroup fills a
// ring of stages: the chunk's weight tiles (hi and lo) with one bulk copy,
// from a pack that holds the two parities' tap sets one after the other
// (ops/conv1d_dx.py::pack_weight), and the dy window of the tile (positions
// m0 - (Kp - 1) ... m0 + BM - 1, zero outside [0, Ly)) with 4-byte cp.async.
// Tap u of row m reads window entry m + u, so each tap's A fragment is a
// shifted read of the same window. The consumers sum a chunk in the wgmma
// accumulator and add it into float32 totals (tf32_wgmma.cuh says why), and
// store each total at dx[b, ci, 2m + p]: the two parities' blocks interleave
// straight into dx. Every element of dx is written once (zero where no dy
// reaches it), so the wrapper's torch.empty needs no fill. No atomics: each
// output is summed by one thread in a fixed order, so a call is bitwise
// reproducible, in a CUDA graph as outside one.

#include "tf32_wgmma.cuh"

namespace {

using namespace tf32x3;

constexpr int SMEM_LIMIT = 232448;  // bytes of shared memory a block may use
constexpr int MAX_STAGES = 4;
constexpr int MAX_K = 9;

struct Dx {
  const float* dy;
  const float* w;  // packed, see above
  float* dx;
  int L, Ly, Cin, Cout, K;
  int n_chunks, m_tiles;  // chunks of 8 output channels; M tiles of the even half
  int xw;                 // window row stride, floats
  int stage_floats, stages;
};

template <int BN, int MT>
__global__ void __launch_bounds__(THREADS, 1) conv1d_dx_s2_kernel(const Dx p) {
  constexpr int BM = 128 * MT;
  constexpr int R = BN / 2;
  extern __shared__ __align__(128) float smem[];
  const int par = blockIdx.z;
  const int taps = (p.K + 1 - par) / 2;
  const int M = (p.L + 1 - par) / 2;  // outputs of this parity in a batch row
  const int b = blockIdx.x / p.m_tiles;
  const int m0 = (blockIdx.x % p.m_tiles) * BM;
  if (m0 >= M) return;  // the odd half is one shorter, and may need a tile less
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.stages * p.stage_floats);
  uint64_t* empty = full + p.stages;
  const int tid = threadIdx.x;
  const int ci0 = blockIdx.y * BN;
  const int wtile = taps * BN * 8;  // floats of one weight half (hi or lo) of a chunk
  if (tid == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(&full[i], PRODUCERS + 1);
      mbar_init(&empty[i], CONSUMERS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer warpgroup: chunk c (output channels 8c ... 8c + 7) into
    // slot c % stages; neighbouring threads copy neighbouring positions
    regs_shrink<PRODUCER_REGS>();
    const int pt = tid - CONSUMERS;
    const int q0 = m0 - (taps - 1);  // dy position of window entry 0
    const int win = BM + taps - 1;
    const float* yb = p.dy + static_cast<size_t>(b) * p.Cout * p.Ly;
    // the odd half's pack follows the even half's (K0 = (K + 1) / 2 taps)
    const size_t half0 =
        static_cast<size_t>(gridDim.y) * p.n_chunks * 2 * ((p.K + 1) / 2) * BN * 8;
    const float* wb = p.w + (par ? half0 : 0) +
                      static_cast<size_t>(blockIdx.y) * p.n_chunks * 2 * wtile;
    for (int c = 0; c < p.n_chunks; ++c) {
      const int slot = c % p.stages;
      mbar_wait(&empty[slot], ((c / p.stages) & 1) ^ 1);
      float* ys = smem + slot * p.stage_floats;
      if (pt == 0)
        bulk_load(ys + 8 * p.xw, wb + static_cast<size_t>(c) * 2 * wtile, 8 * wtile, &full[slot]);
      const int rows = min(8, p.Cout - 8 * c);
      for (int q = pt; q < win; q += PRODUCERS) {
        const int pos = q0 + q;
        const bool in = pos >= 0 && pos < p.Ly;
        const float* src = yb + static_cast<size_t>(8 * c) * p.Ly + pos;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const bool ok = in && r < rows;
          cp_async4(ys + r * p.xw + q, ok ? src + static_cast<size_t>(r) * p.Ly : p.dy, ok);
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
    const float* ys = smem + slot * p.stage_floats + kcol * p.xw + mrow;
    uint64_t dh = kmajor_desc(smem + slot * p.stage_floats + 8 * p.xw, BN);
    uint64_t dl = dh + desc_step(BN) * taps;
    for (int u = 0; u < taps; u += 2) {  // tap u reads window entry m + u
      conv_tap<BN, MT>(acc, a0, ys + u, xw4, dh, dl, u == 0);
      if (u + 1 < taps)
        conv_tap<BN, MT>(acc, a1, ys + u + 1, xw4, dh + desc_step(BN), dl + desc_step(BN),
                         false);
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
      const int ci = ci0 + 8 * (i >> 2) + 2 * kcol + (i & 1);
      const int m = m0 + mrow + t * 64 + 8 * ((i >> 1) & 1);
      if (ci < p.Cin && m < M)
        p.dx[(static_cast<size_t>(b) * p.Cin + ci) * p.L + 2 * m + par] = total[t][i];
    }
  }
}

bool valid_tile(int BN) { return BN == 8 || BN == 16 || BN == 32 || BN == 64 || BN == 128; }

template <int BN, int MT>
int launch(Dx p, int B, cudaStream_t stream) {
  constexpr int BM = 128 * MT;
  const int K0 = (p.K + 1) / 2;  // the even half's taps, the larger stage
  p.m_tiles = ((p.L + 1) / 2 + BM - 1) / BM;
  p.xw = BM + K0 - 1;
  p.xw += (40 - p.xw % 32) % 32;  // row stride = 8 mod 32: fragment reads hit 32 banks
  p.stage_floats = 8 * p.xw + 2 * K0 * BN * 8;
  const int stage_bytes = 4 * p.stage_floats + 16;  // and its two barriers
  p.stages = SMEM_LIMIT / stage_bytes < MAX_STAGES ? SMEM_LIMIT / stage_bytes : MAX_STAGES;
  if (p.stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = p.stages * stage_bytes;
  cudaError_t err = cudaFuncSetAttribute(conv1d_dx_s2_kernel<BN, MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(B) * p.m_tiles;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), (p.Cin + BN - 1) / BN, 2);
  conv1d_dx_s2_kernel<BN, MT><<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Two 64-row tiles per warpgroup where the registers allow and that still
// gives every SM a block: twice the reuse of each staged weight tile.
template <int BN>
int launch_fitted(const Dx& p, int B, cudaStream_t stream) {
  if constexpr (BN < 128) {
    const long long wide = 2LL * B * (((p.L + 1) / 2 + 255) / 256) * ((p.Cin + BN - 1) / BN);
    if (wide >= sm_count()) return launch<BN, 2>(p, B, stream);
  }
  return launch<BN, 1>(p, B, stream);
}

// The pack, one thread per element of a hi tile. The even half's chunks
// come first (`half0` elements of hi tiles), then the odd half's; element
// `in` of a chunk is (tap u, half kh of the 8 channels, row group g, row r,
// channel q) of tf32_wgmma.cuh's B tile layout, rows ci, channels co.
__global__ void pack_dx_kernel(const float* __restrict__ w, float* __restrict__ out, int Cout,
                               int Cin, int K, int BN, int n_chunks, long long half0,
                               long long total) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < total;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int par = e >= half0;
    const long long ep = par ? e - half0 : e;
    const int taps = (K + 1 - par) / 2;
    const int tile = taps * BN * 8;  // floats of one half (hi or lo) of a chunk
    const long long chunk = ep / tile;
    const int in = static_cast<int>(ep - chunk * tile);
    const int q = in & 3, r = (in >> 2) & 7, rest = in >> 5;
    const int g = rest % (BN / 8), kh = (rest / (BN / 8)) & 1, u = rest / (BN / 8) >> 1;
    const int ci = static_cast<int>(chunk / n_chunks) * BN + 8 * g + r;
    const int co = static_cast<int>(chunk % n_chunks) * 8 + 4 * kh + q;
    float v = 0.f;
    if (ci < Cin && co < Cout)
      v = w[(static_cast<size_t>(co) * Cin + ci) * K + par + 2 * (taps - 1 - u)];
    float* o = out + (par ? 2 * half0 : 0) + chunk * 2 * tile + in;
    split_bits(v, o[0], o[tile]);
  }
}

}  // namespace

// dx (B, Cin, L) of a stride-2 conv from dy (B, Cout, Ly), Ly = (L - K) / 2 + 1,
// and w packed by ops/conv1d_dx.py::pack_weight at tile width BN (8, 16,
// 32, 64 or 128); 2 <= K <= 9. Launches on `stream` (PyTorch's current
// stream) and returns cudaGetLastError(), or cudaErrorInvalidValue for
// arguments the kernel does not take. All float32, contiguous.
extern "C" int conv1d_dx_s2_f32(const float* dy, const float* w, float* dx, int B, int L, int Ly,
                                int Cin, int Cout, int K, int BN, void* stream) {
  if (B <= 0 || Cin <= 0 || Cout <= 0 || K < 2 || K > MAX_K || L < K ||
      Ly != (L - K) / 2 + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Dx p{};
  p.dy = dy;
  p.w = w;
  p.dx = dx;
  p.L = L;
  p.Ly = Ly;
  p.Cin = Cin;
  p.Cout = Cout;
  p.K = K;
  p.n_chunks = (Cout + 7) / 8;
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

// Writes the pack conv1d_dx_s2_f32 takes (ops/conv1d_dx.py::pack_weight(w,
// BN), bit for bit) in one launch on `stream`: w (Cout, Cin, K) contiguous
// float32; out as many floats as that pack has.
extern "C" int conv1d_dx_s2_pack_f32(const float* w, float* out, int Cout, int Cin, int K, int BN,
                                     void* stream) {
  if (Cout <= 0 || Cin <= 0 || K < 2 || K > MAX_K || !valid_tile(BN))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = (Cout + 7) / 8;
  const long long per_tap = static_cast<long long>((Cin + BN - 1) / BN) * n_chunks * BN * 8;
  const long long half0 = per_tap * ((K + 1) / 2), total = per_tap * K;
  const long long want = (total + 255) / 256;
  pack_dx_kernel<<<static_cast<unsigned>(want < 4096 ? want : 4096), 256, 0,
                   static_cast<cudaStream_t>(stream)>>>(w, out, Cout, Cin, K, BN, n_chunks, half0,
                                                        total);
  return static_cast<int>(cudaGetLastError());
}
