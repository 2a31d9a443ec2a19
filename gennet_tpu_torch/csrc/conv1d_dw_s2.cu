// Weight gradient (dw) of a stride-2 1-D convolution, hand-written for
// Hopper (sm_90a) as a 3xTF32 GEMM on wgmma.
//
// It replaces no TPU kernel: the JAX package leaves this gradient to XLA.
// It was added because cuDNN's float32 wgrad, under the deterministic
// algorithms the port pins, runs the PE's strided layers at ~0.2 of their
// bound and the narrow-input ones (Cin 1 and 2) through a slow direct
// engine (models/layers.py::Conv1d routes its stride-2 float32 layers here
// on a card; ops/conv1d_dw.py is the wrapper). For y = conv1d(x, w,
// stride 2), x of length L (the input F.conv1d saw: padded for SAME) and dy
// of length Ly = (L - K) / 2 + 1,
//
//   dw[co, ci, k] = sum_{b, j < Ly} dy[b, co, j] * x[b, ci, 2j + k].
//
// By the parity of the tap, x[b, ci, 2j + k] = x_{k%2}[b, ci, j + k/2] with
// x_p[b, ci, t] = x[b, ci, 2t + p]: each tap is a shifted read of one
// parity's window. The windows stay interleaved as x holds them (tap k of
// position j is entry 2j + k of a row's copy), with no zero-stuffing and no
// im2col, in device or shared memory.
//
// What bounds it on the card: 2*B*Cout*Cin*K*Ly flops against
// 4*(B*(Cout*Ly + Cin*L) + Cout*Cin*K) bytes, compute-bound at the wide
// layers (q_convs.4: 84 GFLOP, 0.51 ms at 165 TFLOP/s; three TF32 products
// per float32 product, tf32_wgmma.cuh, so 495 / 3 TFLOP/s of float32 work,
// not the 67 of the FP32 pipes cuDNN's FP32 wgrad is held to). The
// narrow-input layers are a few MFLOP over a long reduction (B*Ly up to
// 32k): they are bound by reading dy once and by the launch.
//
// Design: the GEMM dw^T (M x N) = X (M x R) * dy^T (R x N), with
//   M = (ci, k) in groups of 8 channels, m = (ci / 8) * 8K + 8k + ci % 8,
//   N = Cout in a tile of BN in {8, ..., 128},
//   R = (b, j) in stages of J = 32 positions of one batch row.
// X is the A operand, read into registers from the stage's raw x rows (tap
// k of position j is entry 2j + k from the row's shift), so a tap's shift
// is only an address and the taps share one copy of x; dy is the B
// operand: its tile (BN x J) is split into hi and lo once per stage and read
// by every row of the block, every tap included. The wrapper's plan picks
// the block tile: 256 x 64 (MT = 2 64-row tiles per consumer warpgroup)
// where M has two such tiles or more, else 128 x BN (a thread holds 2 * MT
// * BN / 2 partial sums and totals, so MT = 2 only with BN <= 64).
//
// The reduction is long and the output small (64 x 1 x 5 to 1024 x 512 x
// 5), so the grid's z splits R into `splits` contiguous ranges of stages,
// chosen by the plan from the shape so that the blocks fill the SMs in
// whole waves. Each block writes its totals to a scratch (splits, Cout, M),
// and a second kernel sums the splits in a fixed order into dw (Cout, Cin,
// K). No atomics: a call is bitwise reproducible, in a CUDA graph as
// outside one.
//
// A producer warpgroup fills a ring of shared-memory stages (tf32_wgmma.cuh
// has the roles). A producer thread owns whole rows: x rows of the block's
// channels (positions 2 j0 ... 2 j0 + 2J + K - 2) and one dy row
// (positions j0 ... j0 + J - 1), each copied raw as the 16-byte pieces that
// cover it from the aligned one before its start (rows of any length are
// not 16-byte aligned), zero past the positions the conv reads. Once its
// cp.async group of the previous stage has landed, the thread splits that
// stage's dy row, from the row's shift, into the K-major core-matrix tiles
// wgmma reads (a 16-byte core-matrix row is 4 positions of one dy row),
// fences them to the async proxy and arrives on the stage's full barrier:
// one stage of copies stays in flight while the other is split. Measured
// on an H100, this producer was the limit twice: with 4-byte copies and 40
// registers it took 4x the consumers' time; with the split spread over
// threads that had not copied the rows, a barrier among them. The consumers
// build each 8-position step's A fragments from the raw x rows and split
// them in registers, the next step's while this step's products run, sum
// two steps in the wgmma accumulator and add them into float32 totals
// (tf32_wgmma.cuh says why).

#include "tf32_wgmma.cuh"

namespace {

using namespace tf32x3;

constexpr int SMEM_LIMIT = 232448;  // bytes of shared memory a block may use
constexpr int MAX_STAGES = 4;
constexpr int MAX_K = 9;
constexpr int J = 32;  // positions of a stage: four m64nBNk8 steps
// Steps summed in the wgmma accumulator before each add into the float32
// totals: each step adds three truncated products into it, and at D Conv_0
// (Cin 1-2, 4096 positions, where cuDNN's FP32 wgrad is near exact) four
// steps read up to 2.3x cuDNN's error against float64, two 1.5x, one 1.6x;
// two cost 1-2.5% of the wide layers' time (H100, three seeds).
constexpr int STEPS = 2;
static_assert((J / 8) % STEPS == 0, "whole runs of steps a stage");
constexpr int DR = 36;  // raw dy row of a stage: its 32 positions from their 16-byte piece
constexpr int XR = 76;  // raw x row: 2 * (J + (K - 1) / 2) <= 72 positions from theirs; 12 mod 32
// The producer copies up to 28 16-byte pieces and splits a 36-float row a
// thread and stage, so it gets more than tf32_wgmma.cuh's 40 registers;
// the consumers need at most 200: 2 * 128 * 200 + 128 * 104 = 64512.
constexpr int DW_CONSUMER_REGS = 200;
constexpr int DW_PRODUCER_REGS = 104;

struct Dw {
  const float* dy;  // 16-byte aligned, as is x
  const float* x;
  float* part;  // (splits, Cout, Mp)
  int L, Ly, Cin, Cout, K;
  int Mp;                 // GEMM rows: Cin rounded up to 8, times K
  int row_stages;         // stages of a batch row, ceil(Ly / J)
  int items, splits;      // stages of the call (B * row_stages), and their ranges
  int reach;              // x positions the conv reads, 2 (Ly - 1) + K
  int wch;                // x rows (channels) of a block's stage
  int stage_floats, stages;
};

// split_tf32 on the integer pipes: hi = x rounded to TF32 (nearest, ties
// away from zero) on the bit pattern, and lo = x - hi rounded the same way
// (the tensor cores would otherwise truncate it, a biased 2^-21 of x that
// took the narrow layers past twice cuDNN's error against float64).
__device__ __forceinline__ uint32_t round_tf32(uint32_t bits) {
  return (bits + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_fast(float x, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(__float_as_uint(x));
  lo = round_tf32(__float_as_uint(x - __uint_as_float(hi)));
}

template <int BN, int MT>
__global__ void __launch_bounds__(THREADS, 1) conv1d_dw_s2_kernel(const Dw p) {
  constexpr int BM = 128 * MT;
  constexpr int R = BN / 2;
  constexpr int HI = 0, LO = J * BN, DYR = 2 * J * BN, XRAW = DYR + BN * DR;  // stage layout
  extern __shared__ __align__(128) float smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.stages * p.stage_floats);
  uint64_t* empty = full + p.stages;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, co0 = blockIdx.y * BN;
  const int g_lo = m0 / (8 * p.K);  // the block's first channel group
  const int it0 = static_cast<int>(static_cast<long long>(blockIdx.z) * p.items / p.splits);
  const int n = static_cast<int>(static_cast<long long>(blockIdx.z + 1) * p.items / p.splits) - it0;
  if (tid == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(&full[i], 2 * PRODUCERS);  // each producer: its copies landed, its split stored
      mbar_init(&empty[i], CONSUMERS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer warpgroup: stage s (item it0 + s) into slot s % stages.
    // A thread copies whole rows: x rows pt and pt + 128 (of wch), and dy
    // row (pt + 64) % 128 (of BN), which it splits itself, so its own
    // cp.async groups say when that row has landed.
    regs_shrink<DW_PRODUCER_REGS>();
    const int pt = tid - CONSUMERS;
    const int chs = min(p.wch, p.Cin - 8 * g_lo);  // x rows past Cin stay zero
    const int yr = (pt + 64) % PRODUCERS;
    const bool has_y = yr < BN && co0 + yr < p.Cout;  // rows past Cout stay zero
    for (int s = 0; s <= n; ++s) {
      if (s < n) {
        const int slot = s % p.stages;
        mbar_wait(&empty[slot], ((s / p.stages) & 1) ^ 1);
        float* st = smem + slot * p.stage_floats;
        const int it = it0 + s, b = it / p.row_stages, j0 = (it - b * p.row_stages) * J;
        // x row ch, positions 2 j0 ... as the 19 16-byte pieces from the one
        // holding 2 j0; zero from `reach` on
        for (int ch = pt; ch < p.wch; ch += PRODUCERS) {
          const long long row = (static_cast<long long>(b) * p.Cin + 8 * g_lo + ch) * p.L;
          const long long a0 = (row + 2 * j0) & ~3LL;
          const long long left = ch < chs ? 4 * (row + p.reach - a0) : 0;  // bytes from a0
          const int lim = static_cast<int>(left < 4 * XR ? left : 4 * XR);
#pragma unroll
          for (int pc = 0; pc < XR / 4; ++pc) {
            const int bytes = min(max(lim - 16 * pc, 0), 16);
            cp_async16(st + XRAW + ch * XR + 4 * pc, bytes ? p.x + a0 + 4 * pc : p.x, bytes);
          }
        }
        // dy row yr, positions j0 ... j0 + 31, the same way
        if (yr < BN) {
          const long long row = (static_cast<long long>(b) * p.Cout + co0 + yr) * p.Ly;
          const long long a0 = (row + j0) & ~3LL;
          const long long left = has_y ? 4 * (row + p.Ly - a0) : 0;
          const int lim = static_cast<int>(left < 4 * DR ? left : 4 * DR);
#pragma unroll
          for (int pc = 0; pc < DR / 4; ++pc) {
            const int bytes = min(max(lim - 16 * pc, 0), 16);
            cp_async16(st + DYR + yr * DR + 4 * pc, bytes ? p.dy + a0 + 4 * pc : p.dy, bytes);
          }
        }
        cp_async_arrive(&full[slot]);
      }
      cp_async_commit();  // group s (empty past the last stage)
      if (s > 0) {
        // split stage s - 1's dy row into the K-major core-matrix tiles wgmma
        // reads: positions 4u ... 4u + 3 (from the row's shift in its raw
        // copy) are one 16-byte row of step u / 2, half u % 2
        cp_async_wait_group<1>();
        const int slot = (s - 1) % p.stages;
        float* st = smem + slot * p.stage_floats;
        if (yr < BN) {
          const int it = it0 + s - 1, b = it / p.row_stages, j0 = (it - b * p.row_stages) * J;
          const int shift =
              static_cast<int>(((static_cast<long long>(b) * p.Cout + co0 + yr) * p.Ly + j0) & 3);
          float raw[DR];
#pragma unroll
          for (int pc = 0; pc < DR / 4; ++pc)
            *reinterpret_cast<float4*>(raw + 4 * pc) =
                *reinterpret_cast<const float4*>(st + DYR + yr * DR + 4 * pc);
#pragma unroll
          for (int u = 0; u < J / 4; ++u) {
            uint32_t hi[4], lo[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int e = 4 * u + i;
              split_fast(shift == 0 ? raw[e] : shift == 1 ? raw[e + 1] : shift == 2 ? raw[e + 2]
                                                                                      : raw[e + 3],
                         hi[i], lo[i]);
            }
            const int off =
                (u >> 1) * 8 * BN + ((u & 1) * (BN / 8) + yr / 8) * 32 + (yr % 8) * 4;
            *reinterpret_cast<uint4*>(st + HI + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
            *reinterpret_cast<uint4*>(st + LO + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
          }
        }
        fence_async_shared();
        mbar_arrive(&full[slot]);
      }
    }
    cp_async_wait_all();
    return;
  }

  // ---- consumer warpgroups
  regs_grow<DW_CONSUMER_REGS>();
  const int lane = tid & 31, warp = (tid >> 5) & 3, wg = tid >> 7;
  float acc[MT][R], total[MT][R];  // wgmma partial sums of a stage; float32 totals
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int i = 0; i < R; ++i) acc[t][i] = total[t][i] = 0.f;
  // this thread's two rows of each tile (A fragment rows r and r + 8): the
  // offset in the raw x rows of tap k at its first position, less the
  // row's shift, and (ci L) mod 4, from which each stage's shift follows;
  // rows past M read row 0
  int row[MT][2], cil[MT][2];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + (wg * MT + t) * 64 + warp * 16 + (lane >> 2) + 8 * h;
      const int g = m / (8 * p.K), rem = m - g * 8 * p.K, k = rem >> 3;
      const int ch = (g - g_lo) * 8 + (rem & 7);
      const bool in = m < p.Mp;
      row[t][h] = (in ? ch * XR + k : 0) + 2 * (lane & 3);
      cil[t][h] = in ? static_cast<int>((static_cast<long long>(8 * g + (rem & 7)) * p.L) & 3) : 0;
    }
  const int cinl = static_cast<int>((static_cast<long long>(p.Cin) * p.L) & 3);
  SplitA a[2][MT];
  for (int s = 0; s < n; ++s) {
    const int slot = s % p.stages;
    const int b = (it0 + s) / p.row_stages;
    int at[MT][2];  // x row (b, ci) starts at shift ((b Cin + ci) L) mod 4 of its first piece
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) at[t][h] = row[t][h] + ((b * cinl + cil[t][h]) & 3);
    mbar_wait(&full[slot], (s / p.stages) & 1);
    const float* st = smem + slot * p.stage_floats;
    const float* xs = st + XRAW;
    const uint64_t dh = kmajor_desc(st + HI, BN), dl = kmajor_desc(st + LO, BN);
#pragma unroll
    for (int q = 0; q < J / 8; ++q) {
      wgmma_wait<1>();  // the products that last read a[q & 1]
#pragma unroll
      for (int t = 0; t < MT; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i)  // row + 8 (i & 1), position + 4 (i >> 1): x at 2 j + k
          split_fast(xs[at[t][i & 1] + 16 * q + 8 * (i >> 1)], a[q & 1][t].hi[i],
                     a[q & 1][t].lo[i]);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < MT; ++t)
        mma_3xtf32<BN>(acc[t], a[q & 1][t], dh + q * desc_step(BN), dl + q * desc_step(BN),
                       q % STEPS == 0);
      wgmma_commit();
      if ((q + 1) % STEPS == 0) {
        wgmma_wait<0>();
        if (q == J / 8 - 1 && lane == 0) mbar_arrive(&empty[slot]);  // this warp is done with it
#pragma unroll
        for (int t = 0; t < MT; ++t) promote(total[t], acc[t]);
      }
    }
  }

  float* out = p.part + static_cast<size_t>(blockIdx.z) * p.Cout * p.Mp;
#pragma unroll
  for (int t = 0; t < MT; ++t) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int m = m0 + (wg * MT + t) * 64 + warp * 16 + (lane >> 2) + 8 * ((i >> 1) & 1);
      const int co = co0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      if (m < p.Mp && co < p.Cout) out[static_cast<size_t>(co) * p.Mp + m] = total[t][i];
    }
  }
}

// dw[co, ci, k] = sum over splits of part[split, co, m(ci, k)], in split order.
__global__ void sum_splits_kernel(const float* __restrict__ part, float* __restrict__ dw,
                                  int Cout, int Cin, int K, int Mp, int splits) {
  const long long total = static_cast<long long>(Cout) * Cin * K;
  const size_t plane = static_cast<size_t>(Cout) * Mp;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < total;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int co = static_cast<int>(e / (Cin * K)), rem = static_cast<int>(e - co * Cin * K);
    const int ci = rem / K, k = rem - ci * K;
    const float* src = part + static_cast<size_t>(co) * Mp + (ci >> 3) * 8 * K + 8 * k + (ci & 7);
    float s = src[0];
    for (int z = 1; z < splits; ++z) s += src[z * plane];
    dw[e] = s;
  }
}

template <int BN, int MT>
int launch(Dw p, float* dw, cudaStream_t stream) {
  constexpr int BM = 128 * MT;
  const int m_tiles = (p.Mp + BM - 1) / BM;
  int groups = 1;  // the most channel groups a block's rows touch
  for (int t = 0; t < m_tiles; ++t) {
    const int last = (t + 1) * BM < p.Mp ? (t + 1) * BM - 1 : p.Mp - 1;
    const int gs = last / (8 * p.K) - t * BM / (8 * p.K) + 1;
    groups = gs > groups ? gs : groups;
  }
  p.wch = 8 * groups;
  p.stage_floats = (2 * J * BN + BN * DR + p.wch * XR + 31) / 32 * 32;  // 128-byte aligned stages
  const int stage_bytes = 4 * p.stage_floats + 16;                  // and its two barriers
  p.stages = SMEM_LIMIT / stage_bytes < MAX_STAGES ? SMEM_LIMIT / stage_bytes : MAX_STAGES;
  if (p.stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = p.stages * stage_bytes;
  cudaError_t err = cudaFuncSetAttribute(conv1d_dw_s2_kernel<BN, MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(m_tiles, (p.Cout + BN - 1) / BN, p.splits);
  conv1d_dw_s2_kernel<BN, MT><<<grid, THREADS, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(p.Cout) * p.Cin * p.K;
  const long long want = (n + 255) / 256;
  sum_splits_kernel<<<static_cast<unsigned>(want < 4096 ? want : 4096), 256, 0, stream>>>(
      p.part, dw, p.Cout, p.Cin, p.K, p.Mp, p.splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dw (Cout, Cin, K) of a stride-2 conv from dy (B, Cout, Ly) and x (B, Cin,
// L), Ly = (L - K) / 2 + 1, 2 <= K <= 9; `part` is scratch of splits * Cout *
// (Cin rounded up to 8) * K floats. Tile width BN (8, 16, 32, 64 or 128),
// MT (1, or 2 with BN <= 64) and splits (1 to B * ceil(Ly / 32)) come from
// ops/conv1d_dw.py::plan. Launches the GEMM and the sum of its splits on
// `stream` (PyTorch's current stream) and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the kernel does not take. All
// float32, contiguous.
extern "C" int conv1d_dw_s2_f32(const float* dy, const float* x, float* part, float* dw, int B,
                                int L, int Ly, int Cin, int Cout, int K, int BN, int MT,
                                int splits, void* stream) {
  if (B <= 0 || Cin <= 0 || Cout <= 0 || K < 2 || K > MAX_K || L < K ||
      Ly != (L - K) / 2 + 1 || reinterpret_cast<uintptr_t>(dy) % 16 ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  Dw p{};
  p.dy = dy;
  p.x = x;
  p.part = part;
  p.L = L;
  p.Ly = Ly;
  p.Cin = Cin;
  p.Cout = Cout;
  p.K = K;
  p.Mp = (Cin + 7) / 8 * 8 * K;
  p.row_stages = (Ly + J - 1) / J;
  const long long items = static_cast<long long>(B) * p.row_stages;
  if (items > 2147483647LL || splits < 1 || splits > items || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  p.items = static_cast<int>(items);
  p.splits = splits;
  p.reach = 2 * (Ly - 1) + K;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (MT * 1000 + BN) {
    case 1008: return launch<8, 1>(p, dw, s);
    case 1016: return launch<16, 1>(p, dw, s);
    case 1032: return launch<32, 1>(p, dw, s);
    case 1064: return launch<64, 1>(p, dw, s);
    case 1128: return launch<128, 1>(p, dw, s);
    case 2008: return launch<8, 2>(p, dw, s);
    case 2016: return launch<16, 2>(p, dw, s);
    case 2032: return launch<32, 2>(p, dw, s);
    case 2064: return launch<64, 2>(p, dw, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
