// 3xTF32 warpgroup matrix multiply for Hopper (sm_90a), shared by the
// port's kernels (conv1d_same.cu, conv1d_dx_s2.cu, conv1d_dw_s2.cu,
// phasor_irdft.cu).
//
// A float32 product a*b is taken as three TF32 tensor-core products,
//
//   a*b ~ a_lo*b_hi + a_hi*b_lo + a_hi*b_hi,   hi = tf32(x), lo = x - hi,
//
// summed in float32, small terms first. The dropped
// a_lo*b_lo term and the TF32 rounding of the lo parts leave an error of
// about 2^-22 of |a*b|, float32-class, at three times the TF32 work: up to
// 495 / 3 = 165 TFLOP/s of float32 products on an H100 (one TF32 product
// alone keeps about 5e-4 relative, too little for the port's parity).
//
// The products run on wgmma.mma_async m64nNk8 (N a multiple of 8 up to
// 256; the kernels use 8, 16, 32, 64 and 128): a warpgroup of 128 threads multiplies a 64 x 8 A tile held in
// registers by an N x 8 B tile in shared memory and accumulates a 64 x N
// float32 tile in registers. TF32 operands in shared memory must be
// K-major (the transpose immediates exist only for 16-bit types), so B is
// stored with the reduction index contiguous, in the no-swizzle layout of
// 8-row x 16-byte core matrices that kmajor_desc() describes. A is made on
// chip by each kernel and split in registers (split_tf32); the constant B
// operands are split once by the wrappers, which lay hi and lo out as the
// exact image of each pipeline stage, so one bulk copy moves a stage.
//
// Register fragments of one warpgroup (w = warp in the group, l = lane):
//   A a[i]: row 16w + l/4 + 8(i&1), column (l%4) + 4(i>>1), i < 4;
//   D d[i]: row 16w + l/4 + 8((i>>1)&1), column 8(i/4) + 2(l%4) + (i&1).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tf32x3 {

// hi = x rounded to TF32 (nearest, ties away), lo = the rest rounded too.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// An N x 8 K-major B tile in shared memory is laid out as 2 x N/8 core
// matrices of 8 rows x 4 floats: element (n, k) at float offset
// ((k / 4) * N/8 + n / 8) * 32 + (n % 8) * 4 + k % 4. The wrappers pack the
// constant operands in this order (ops/conv1d.py, ops/phasor_dft.py).
//
// Its wgmma descriptor: the two core matrices along K are N/8 * 128 bytes
// apart (leading byte offset), neighbouring 8-row groups 128 bytes (stride
// byte offset); no swizzle. The tile k8 steps further along a packed
// stage is kmajor_desc(tile, N) + desc_step(N) * steps.
__device__ __forceinline__ uint64_t kmajor_desc(const float* tile, int N) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  const uint64_t lbo = static_cast<uint64_t>(N / 8 * 128) >> 4;
  const uint64_t sbo = 128 >> 4;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (lbo << 16) | (sbo << 32);
}

__host__ __device__ constexpr uint64_t desc_step(int N) { return N * 8 * 4 / 16; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- warp specialisation and the rings of shared-memory stages -------
// The kernels run two consumer warpgroups (the products) and one producer
// warpgroup (the copies). The producer hands most of its registers to the
// consumers: 2 * 128 * CONSUMER_REGS + 128 * PRODUCER_REGS <= 65536.
// Each stage has a `full` mbarrier (its copies have landed) and an `empty`
// one (every consumer warp is done with it). A stage of a packed constant
// operand is one bulk copy, issued by one producer thread and counted in
// bytes on `full`; a stage of an operand made on chip is 4-byte cp.async
// by every producer thread, each of which arrives on `full` when its
// copies land.
constexpr int CONSUMERS = 256;
constexpr int PRODUCERS = 128;
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int CONSUMER_REGS = 232;
constexpr int PRODUCER_REGS = 40;

template <int R>
__device__ __forceinline__ void regs_grow() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

template <int R>
__device__ __forceinline__ void regs_shrink() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_addr(bar)) : "memory");
}

// Wait for the completion of the barrier's phase with this parity (use u
// of a stage completes the phase of parity u & 1).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(a), "r"(parity) : "memory");
}

// One lane: arrive on `bar` expecting `bytes`, and copy them from global
// memory into shared memory; the copy counts the bytes off as they land.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// 4-byte asynchronous copy into shared memory, zero-filled when !ok.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

// 16-byte asynchronous copy into shared memory of `bytes` (0-16) bytes,
// the rest zero-filled. Both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}

// Arrive on `bar` once this thread's cp.async copies so far have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Close this thread's group of cp.async copies issued since the last one
// (an empty group where none were), and wait until all but the newest N
// groups have landed; their data is then visible to this thread.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Makes this thread's shared-memory stores visible to the async proxy
// (wgmma's operand reads): a B operand that threads store themselves is
// fenced before the stage's barrier is arrived on.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- wgmma issue and completion ----
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads of the accumulators above a wait.
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = A * B^T + (scale_d ? d : 0) for a 64 x 8 TF32 A fragment and an
// N x 8 K-major B tile.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t desc_b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32<8>(float (&d)[4], const uint32_t (&a)[4],
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[8], const uint32_t (&a)[4],
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], const uint32_t (&a)[4],
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64], const uint32_t (&a)[4],
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// The A operand of one 64 x 8 step, split: hi and lo fragments.
struct SplitA {
  uint32_t hi[4];
  uint32_t lo[4];
};

// d += A * B over float32 values by three TF32 products, small terms
// first; with `fresh`, d starts from zero instead.
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (&d)[N / 2], const SplitA& a, uint64_t b_hi,
                                           uint64_t b_lo, bool fresh) {
  wgmma_tf32<N>(d, a.lo, b_hi, fresh ? 0 : 1);
  wgmma_tf32<N>(d, a.hi, b_lo, 1);
  wgmma_tf32<N>(d, a.hi, b_hi, 1);
}

// The tensor cores add into their float32 accumulator with truncation, so
// its error grows with the length of the sum (measured on an H100: 5e-5 of
// the maximum over 10240 products, against 2e-6 for IEEE float32). The
// kernels therefore sum a few steps at a time in the wgmma accumulator and
// add each partial sum into a float32 total with IEEE rounding.
template <int R>
__device__ __forceinline__ void promote(float (&total)[R], float (&partial)[R]) {
  fence_operands(partial);
#pragma unroll
  for (int i = 0; i < R; ++i) total[i] += partial[i];
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

// hi, lo of x as ops/tf32.py::split_tf32 makes them, on the bit pattern.
__device__ __forceinline__ void split_bits(float x, float& hi, float& lo) {
  const uint32_t bits = __float_as_uint(x);
  float h = __uint_as_float((bits + 0x1000u) & 0xFFFFE000u);
  if (isfinite(x) && !isfinite(h)) h = __uint_as_float(bits & 0xFFFFE000u);
  if (isnan(x)) h = x;
  hi = h;
  lo = isfinite(x) ? x - h : 0.f;
}

// SMs of the current device (132 on an H100 SXM), read once: the kernels
// size their grids to fill them.
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

}  // namespace tf32x3
