// w8a8 int8 GEMM with per-row / per-column dequant scales, for Hopper (sm_90a).
//
//   out[m, n] = float(sum_k x_q[m, k] * w_q[k, n]) * (x_scale[m] * w_scale[n])
//
// Replaces the Pallas TPU kernel src/repro/kernels/npu_matmul/kernel.py
// (int8_matmul, body _kernel): int8 x int8 products accumulate exactly in
// int32 and the f32 scale is applied once, after the last K step, in the same
// order as kernel.py:45-46.
//
// What bounds it on an H100: at the serving shapes (batch 1, one frame per
// NPU forward) the GEMMs are thin -- M is 1 for the classifier head and at
// most a few thousand rows for the convs -- so the time floor is the bytes
// moved (int8 operands + f32 output at 3.35 TB/s), not int8 tensor-core
// throughput (1979 TOP/s).  This first version is the simple, exact one:
// one block owns a 64x64 output tile and walks K in 32-wide steps through
// shared memory, accumulating 4-byte dot products with __dp4a.  Blocks mask
// the ragged M, N and K edges themselves, so the caller pads nothing (M=1 and
// K=27 or K=147 are ordinary inputs).  wgmma, TMA and multi-stage pipelining
// are later work.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC \
//        -o libint8_matmul.so int8_matmul.cu

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;       // output rows per block
constexpr int BN = 64;       // output columns per block
constexpr int BK = 32;       // K step held in shared memory (bytes per row)
constexpr int TM = 4;        // rows per thread
constexpr int TN = 4;        // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int LDS = BK + 4;  // padded shared row stride, keeps 4-byte alignment

__global__ void __launch_bounds__(THREADS)
int8_matmul_kernel(const int8_t* __restrict__ xq,   // [M, K] row-major
                   const int8_t* __restrict__ wq,   // [K, N] row-major
                   const float* __restrict__ xs,    // [M]
                   const float* __restrict__ ws,    // [N]
                   float* __restrict__ out,         // [M, N] row-major
                   int M, int N, int K) {
  // Both tiles are stored K-contiguous per output row/column, so one 32-bit
  // shared load feeds __dp4a four consecutive k of each operand.
  __shared__ __align__(16) int8_t As[BM][LDS];
  __shared__ __align__(16) int8_t Bs[BN][LDS];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // 0..15: column lane
  const int ty = tid / (BN / TN);  // 0..15: row lane
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile: BM x BK bytes, 8 per thread; consecutive threads read
    // consecutive bytes of one row.  Out-of-range elements load as 0, which
    // adds nothing to the integer sum.
#pragma unroll
    for (int e = 0; e < (BM * BK) / THREADS; ++e) {
      const int idx = tid + e * THREADS;
      const int r = idx / BK, c = idx % BK;
      const int gm = m0 + r, gk = k0 + c;
      As[r][c] = (gm < M && gk < K) ? xq[(size_t)gm * K + gk] : int8_t(0);
    }
    // B tile: BK x BN bytes, read along N (coalesced) and stored transposed.
#pragma unroll
    for (int e = 0; e < (BK * BN) / THREADS; ++e) {
      const int idx = tid + e * THREADS;
      const int r = idx / BN, c = idx % BN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[c][r] = (gk < K && gn < N) ? wq[(size_t)gk * N + gn] : int8_t(0);
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      int a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const int*>(&As[ty + i * (BM / TM)][kk]);
#pragma unroll
      for (int j = 0; j < TN; ++j)
        b[j] = *reinterpret_cast<const int*>(&Bs[tx + j * (BN / TN)][kk]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue, in the order of the TPU kernel: acc.astype(f32) * (xs * ws).
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * (BM / TM);
    if (gm >= M) continue;
    const float sx = xs[gm];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * (BN / TN);
      if (gn >= N) continue;
      const float scale = __fmul_rn(sx, ws[gn]);
      out[(size_t)gm * N + gn] = __fmul_rn(__int2float_rn(acc[i][j]), scale);
    }
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream); returns cudaGetLastError()
// so the Python wrapper can raise on a refused launch.
extern "C" int repro_int8_matmul(const void* xq, const void* wq, const void* xs,
                                 const void* ws, void* out, int M, int N, int K,
                                 void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_matmul_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq),
      static_cast<const float*>(xs), static_cast<const float*>(ws),
      static_cast<float*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
