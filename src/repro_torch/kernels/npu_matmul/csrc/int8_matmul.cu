// w8a8 int8 GEMM with per-row / per-column dequant scales, for Hopper (sm_90a).
//
//   out[m, n] = float(sum_k x_q[m, k] * w_q[k, n]) * (x_scale[m] * w_scale[n])
//
// Replaces the Pallas TPU kernel src/repro/kernels/npu_matmul/kernel.py
// (int8_matmul, body _kernel): int8 x int8 products accumulate exactly in
// int32 and the f32 scale is applied once, after the last K step, in the same
// order as kernel.py:45-46: __fmul_rn(__int2float_rn(acc), __fmul_rn(xs, ws)).
// |sum| <= 127^2 * 4608 < 2^31 at the widest K of the serving models, so the
// result is bitwise equal to the plain version whatever the summation order.
//
// What bounds it on an H100.  The serving shapes are thin (batch 1: M = 1 for
// the classifier head, 49 to 12544 rows for the convs), so the floor is the
// bytes moved (int8 operands + f32 output at 3.35 TB/s), far above the int8
// tensor-core time (1979 TOP/s); one frame's 80 GEMMs need 32 us of bytes.
// What a call really waits on is the launch, how many blocks are in flight
// and how long each walks K: 64x64 tiles alone give 49x4608x512 only 8
// blocks, each walking all of K.  So the design:
//
//   * Tensor cores: mma.sync.m16n8k32 s8 x s8 -> s32, fed by ldmatrix from
//     shared memory, 4 warps a block.  A block owns BM x 64 outputs; the row
//     tile BM is 16, 64 or 128 (warps 1x4, 2x2 or 4x1; a warp 16x16, 32x32
//     or 32x64 outputs), chosen per shape by ops.plan: 16 up to 256 rows, so
//     that M = 1 wastes 15 rows and not 63, 128 where that alone fills the
//     card, else 64.
//   * Split-K in one launch: where the tiles are fewer than the 132 SMs,
//     ops.plan splits K so that a call puts about one wave of blocks on the
//     card (49x4608x512: 32 tiles x 4 splits = 128 blocks).  Each split
//     writes its int32 partial tile to a workspace, accumulator-major so that
//     every warp access is 512 contiguous bytes; the last block to arrive at
//     a tile (an atomic counter per tile) sums the partials in split order,
//     several splits' loads in flight at a time, runs the epilogue and resets
//     the counter to 0.  Workspace and counters are allocated once per device
//     by the wrapper: no memset per call.  Integer addition makes the result
//     independent of arrival order.
//   * B is [K, N] row-major, but the s8 mma wants it K-contiguous per column.
//     It is transposed while staged: 4x4 byte blocks through __byte_perm into
//     a [n][k] tile that ldmatrix reads.
//   * Loads: where K % 16 == 0 and x_q is 16-byte aligned, A is copied with
//     16-byte cp.async; where N % 16 == 0 and w_q is 16-byte aligned, so is
//     B, and each thread transposes the bytes it copied itself, so no extra
//     barrier is needed.  K moves in steps of 128 bytes, 3 steps in flight
//     (2 at BM = 64 and 128) while one is multiplied.  A ragged operand
//     (ResNet conv1 K = 147, SqueezeNet conv1 K = 27, the head's N = 1000,
//     the smoke models' N = 10) takes a masked narrow path instead: 4-byte
//     words where its row stride and pointer are multiples of 4 (N = 1000),
//     else bytes, loaded into registers before the current step's products
//     and stored to shared memory after them.  The wrapper picks each
//     operand's path at launch.
//   * The f32 output tile is staged through shared memory and stored along
//     rows, 16 bytes a thread where N % 4 == 0.
//   * Ragged M, N and K edges load as 0, which adds nothing to the integer
//     sums, and are never stored: the caller pads nothing.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC \
//        -o libint8_matmul.so int8_matmul.cu

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BN = 64;        // output columns per block
constexpr int BK = 128;       // K bytes per pipeline step
constexpr int THREADS = 128;  // 4 warps
constexpr int LDS = BK + 16;  // bytes per staged A / B^T row: a 16-byte pad keeps ldmatrix conflict-free
constexpr int LDC = BN + 4;   // f32 per row of the staged output tile

template <int BM> struct Tile {
  static constexpr int WM = BM == 16 ? 1 : BM == 64 ? 2 : 4;  // warps along M
  static constexpr int WN = 4 / WM;                            // warps along N
  static constexpr int MT = BM / WM / 16;                      // m16 tiles per warp
  static constexpr int NT = BN / WN / 8;                       // n8 tiles per warp
  static constexpr int NQ = MT * NT;                           // int4 accumulators per thread
  static constexpr int STAGES = BM == 16 ? 4 : 3;              // cp.async stages: K steps in flight + 1
  static constexpr int A_STAGE = BM * LDS;                     // A tile [BM][LDS]
  static constexpr int B_RAW = BK * BN;                        // B tile as copied, [BK][BN]
  static constexpr int B_T = BN * LDS;                         // B tile transposed, [BN][LDS]
  static constexpr int SMEM = STAGES * (A_STAGE + B_RAW) + 2 * B_T;
  static constexpr int A_WORDS = BM * (BK / 4) / THREADS;      // narrow A: 4-byte words per thread
  static constexpr int B_BLOCKS = (BK / 4) * (BN / 4) / THREADS;  // narrow B: 4x4 blocks per thread
  static constexpr int UNROLL = NQ <= 2 ? 8 : NQ <= 4 ? 4 : NQ <= 8 ? 2 : 1;  // split-K partials in flight per thread
  static_assert(MT >= 1 && NT % 2 == 0 && A_WORDS >= 1 && B_BLOCKS >= 1, "tile shape");
  static_assert(BM * LDC * 4 <= SMEM, "the output tile is staged in the pipeline's shared memory");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 fills the destination with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c[16x8 s32] += a[16x32 s8, row] . b[32x8 s8, col]
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows r0..r3 of a 4x4 byte block in, its columns out: c[j] byte i = r_i byte j.
__device__ __forceinline__ void transpose4x4(uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3,
                                             uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
  const uint32_t t1 = __byte_perm(r0, r1, 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
  const uint32_t t2 = __byte_perm(r2, r3, 0x5140);  // r2.b0 r3.b0 r2.b1 r3.b1
  const uint32_t t3 = __byte_perm(r2, r3, 0x7362);  // r2.b2 r3.b2 r2.b3 r3.b3
  c[0] = __byte_perm(t0, t2, 0x5410);               // r0.b0 r1.b0 r2.b0 r3.b0
  c[1] = __byte_perm(t0, t2, 0x7632);               // r0.b1 r1.b1 r2.b1 r3.b1
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

// VA / VB: A / B are copied with 16-byte cp.async; else narrow loads, of
// 4-byte words where a4 / b4 (else bytes).
// Grid: x = N tiles, y = M tiles, z = K splits of k_per steps of BK each.
template <int BM, bool VA, bool VB>
__global__ void __launch_bounds__(THREADS)
int8_mma_kernel(const int8_t* __restrict__ xq,  // [M, K] row-major
                const int8_t* __restrict__ wq,  // [K, N] row-major
                const float* __restrict__ xs,   // [M]
                const float* __restrict__ ws,   // [N]
                float* __restrict__ out,        // [M, N] row-major
                int M, int N, int K, int k_per, bool a4, bool b4, int* __restrict__ partials,
                int* __restrict__ counters) {
  using TL = Tile<BM>;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int STAGES = TL::STAGES;
  unsigned char* As = smem;                            // [STAGES][BM][LDS]
  unsigned char* Braw = smem + STAGES * TL::A_STAGE;   // [STAGES][BK][BN]
  unsigned char* Bt = Braw + STAGES * TL::B_RAW;       // [2][BN][LDS]
  float* Cs = reinterpret_cast<float*>(smem);          // [BM][LDC], after the K loop
  __shared__ int last_block;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, t4 = lane & 3;  // mma fragment row group, thread in group
  const int wm = warp / TL::WN, wn = warp % TL::WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int splits = gridDim.z, split = blockIdx.z;
  const int k_steps = (K + BK - 1) / BK;
  const int kt0 = split * k_per;
  const int nk = k_per < k_steps - kt0 ? k_per : k_steps - kt0;  // >= 1: ops.plan leaves no split empty

  uint32_t areg[VA ? 1 : TL::A_WORDS];
  uint32_t breg[VB ? 1 : TL::B_BLOCKS][4];
  constexpr int B_COPIERS = (BK / 4) * (BN / 16);  // vector B: threads that copy 4 rows x 16 bytes each

  // Vector operands: 16-byte cp.async copies of step kt into stage st.
  auto issue = [&](int kt, int st) {
    const int kb = (kt0 + kt) * BK;
    if (VA) {
      unsigned char* dst = As + st * TL::A_STAGE;
      for (int c = tid; c < BM * (BK / 16); c += THREADS) {
        const int r = c / (BK / 16), kc = (c % (BK / 16)) * 16;
        const int gm = m0 + r, gk = kb + kc;
        const bool ok = gm < M && gk < K;  // K % 16 == 0: a chunk is wholly in or out
        cp_async16(dst + r * LDS + kc, ok ? xq + (size_t)gm * K + gk : xq, ok ? 16 : 0);
      }
    }
    if (VB && tid < B_COPIERS) {
      unsigned char* dst = Braw + st * TL::B_RAW;
      const int kq = tid / (BN / 16), nc = (tid % (BN / 16)) * 16;
      const int gn = n0 + nc;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gk = kb + 4 * kq + i;
        const bool ok = gk < K && gn < N;  // N % 16 == 0: likewise
        cp_async16(dst + (4 * kq + i) * BN + nc, ok ? wq + (size_t)gk * N + gn : wq, ok ? 16 : 0);
      }
    }
  };

  // Narrow operands: masked loads of step kt into registers, as 4-byte words
  // where the row stride and pointer allow (a4 / b4: K % 4 == 0 / N % 4 == 0,
  // so a word is wholly in or out), else as bytes.
  auto fetch = [&](int kt) {
    const int kb = (kt0 + kt) * BK;
    if (!VA) {
#pragma unroll
      for (int i = 0; i < TL::A_WORDS; ++i) {
        const int u = tid + i * THREADS;
        const int r = u / (BK / 4), gk = kb + 4 * (u % (BK / 4));
        const int gm = m0 + r;
        uint32_t word = 0;
        if (gm < M) {
          const int8_t* row = xq + (size_t)gm * K;
          if (a4) {
            if (gk < K) word = *reinterpret_cast<const uint32_t*>(row + gk);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (gk + e < K) word |= (uint32_t)(uint8_t)row[gk + e] << (8 * e);
          }
        }
        areg[i] = word;
      }
    }
    if (!VB) {
#pragma unroll
      for (int i = 0; i < TL::B_BLOCKS; ++i) {
        const int u = tid + i * THREADS;
        const int gk = kb + 4 * (u / (BN / 4)), gn = n0 + 4 * (u % (BN / 4));
        if (b4) {  // rows gk .. gk + 3 of columns gn .. gn + 3, transposed
          uint32_t r[4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            r[kk] = gk + kk < K && gn < N ? *reinterpret_cast<const uint32_t*>(wq + (size_t)(gk + kk) * N + gn) : 0u;
          transpose4x4(r[0], r[1], r[2], r[3], breg[i]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) breg[i][e] = 0;  // breg[i][e]: column gn + e, rows gk .. gk + 3
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            if (gk + kk < K) {
              const int8_t* row = wq + (size_t)(gk + kk) * N;
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (gn + e < N) breg[i][e] |= (uint32_t)(uint8_t)row[gn + e] << (8 * kk);
            }
          }
        }
      }
    }
  };

  // Step kt's operands into the layouts ldmatrix reads: narrow A from
  // registers into stage st; B transposed into buffer bt, from this thread's
  // own cp.async copies (vector) or from registers (narrow).
  auto prepare = [&](int st, int bt) {
    if (!VA) {
      unsigned char* dst = As + st * TL::A_STAGE;
#pragma unroll
      for (int i = 0; i < TL::A_WORDS; ++i) {
        const int u = tid + i * THREADS;
        *reinterpret_cast<uint32_t*>(dst + (u / (BK / 4)) * LDS + 4 * (u % (BK / 4))) = areg[i];
      }
    }
    unsigned char* bdst = Bt + bt * TL::B_T;
    if (VB) {
      if (tid < B_COPIERS) {
        const unsigned char* src = Braw + st * TL::B_RAW;
        const int kq = tid / (BN / 16), nc = (tid % (BN / 16)) * 16;
        uint32_t rw[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint4 v = *reinterpret_cast<const uint4*>(src + (4 * kq + i) * BN + nc);
          rw[i][0] = v.x, rw[i][1] = v.y, rw[i][2] = v.z, rw[i][3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t c[4];
          transpose4x4(rw[0][j], rw[1][j], rw[2][j], rw[3][j], c);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            *reinterpret_cast<uint32_t*>(bdst + (nc + 4 * j + e) * LDS + 4 * kq) = c[e];
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < TL::B_BLOCKS; ++i) {
        const int u = tid + i * THREADS;
        const int kq = u / (BN / 4), nq = u % (BN / 4);
#pragma unroll
        for (int e = 0; e < 4; ++e) *reinterpret_cast<uint32_t*>(bdst + (4 * nq + e) * LDS + 4 * kq) = breg[i][e];
      }
    }
  };

  int acc[TL::MT][TL::NT][4];
#pragma unroll
  for (int mt = 0; mt < TL::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < TL::NT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;

  auto compute = [&](const unsigned char* a_s, const unsigned char* b_s) {
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t af[TL::MT][4], bf[TL::NT][2];
#pragma unroll
      for (int mt = 0; mt < TL::MT; ++mt)
        ldmatrix_x4(af[mt], a_s + ((wm * TL::MT + mt) * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS + ks +
                                (lane >> 4) * 16);
#pragma unroll
      for (int np = 0; np < TL::NT / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, b_s + (wn * TL::NT * 8 + np * 16 + (lane & 7) + (lane >> 4) * 8) * LDS + ks +
                           ((lane >> 3) & 1) * 16);
        bf[2 * np][0] = r[0], bf[2 * np][1] = r[1], bf[2 * np + 1][0] = r[2], bf[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < TL::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < TL::NT; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }
  };

  // Pipeline: steps kt + 1 .. kt + STAGES - 1 are in flight while step kt
  // multiplies.  Group g holds step g's copies; every iteration commits one,
  // so "all but the newest STAGES - 2 groups" means "up to step kt + 1".
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) issue(st, st);
    cp_async_commit();
  }
  fetch(0);
  cp_async_wait<STAGES - 2>();
  prepare(0, 0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + STAGES - 1 < nk) issue(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();
    if (kt + 1 < nk) fetch(kt + 1);
    compute(As + (kt % STAGES) * TL::A_STAGE, Bt + (kt & 1) * TL::B_T);
    if (kt + 1 < nk) {
      cp_async_wait<STAGES - 2>();  // this thread's copies of step kt + 1 have landed
      prepare((kt + 1) % STAGES, (kt + 1) & 1);
    }
    __syncthreads();
  }
  cp_async_wait<0>();  // only empty groups remain; the output tile reuses the stages

  if (splits > 1) {
    // Partials are stored accumulator-major, [tile][split][q][thread] int4,
    // so every store and load of a warp covers 512 contiguous bytes.
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    int4* tile_parts = reinterpret_cast<int4*>(partials) + (size_t)tile * splits * TL::NQ * THREADS;
    int4* part = tile_parts + (size_t)split * TL::NQ * THREADS + tid;
#pragma unroll
    for (int mt = 0; mt < TL::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < TL::NT; ++nt)
        part[(mt * TL::NT + nt) * THREADS] = make_int4(acc[mt][nt][0], acc[mt][nt][1], acc[mt][nt][2], acc[mt][nt][3]);
    __threadfence();
    __syncthreads();
    if (tid == 0) last_block = atomicAdd(counters + tile, 1) == splits - 1;
    __syncthreads();
    if (!last_block) return;
    __threadfence();
#pragma unroll
    for (int mt = 0; mt < TL::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < TL::NT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;
    // Sum in split order, UNROLL splits' loads in flight at a time.
    for (int s0 = 0; s0 < splits; s0 += TL::UNROLL) {
      int4 v[TL::UNROLL][TL::NQ];
#pragma unroll
      for (int u = 0; u < TL::UNROLL; ++u)
#pragma unroll
        for (int q = 0; q < TL::NQ; ++q)
          v[u][q] = s0 + u < splits ? __ldcg(tile_parts + ((size_t)(s0 + u) * TL::NQ + q) * THREADS + tid)
                                    : make_int4(0, 0, 0, 0);
#pragma unroll
      for (int u = 0; u < TL::UNROLL; ++u)
#pragma unroll
        for (int mt = 0; mt < TL::MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < TL::NT; ++nt) {
            const int4 p = v[u][mt * TL::NT + nt];
            acc[mt][nt][0] += p.x, acc[mt][nt][1] += p.y, acc[mt][nt][2] += p.z, acc[mt][nt][3] += p.w;
          }
    }
    if (tid == 0) counters[tile] = 0;  // ready for the next launch
  }

  // Epilogue, in the order of the TPU kernel: acc.astype(f32) * (xs * ws),
  // staged through shared memory so the stores run along rows.
  const int lr0 = wm * TL::MT * 16 + gq, lc0 = wn * TL::NT * 8 + 2 * t4;
#pragma unroll
  for (int mt = 0; mt < TL::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = lr0 + mt * 16 + 8 * h;
      const float sx = m0 + lr < M ? xs[m0 + lr] : 0.f;
#pragma unroll
      for (int nt = 0; nt < TL::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int lc = lc0 + nt * 8 + e;
          const float sw = n0 + lc < N ? ws[n0 + lc] : 0.f;
          Cs[lr * LDC + lc] = __fmul_rn(__int2float_rn(acc[mt][nt][2 * h + e]), __fmul_rn(sx, sw));
        }
    }
  __syncthreads();
  const bool vec_out = (N & 3) == 0;  // rows of out start 16-byte aligned (out is a fresh allocation)
  for (int i = tid; i < BM * (BN / 4); i += THREADS) {
    const int lr = i / (BN / 4), lc = (i % (BN / 4)) * 4;
    const int gm = m0 + lr, gn = n0 + lc;
    if (gm >= M || gn >= N) continue;
    const float* src = Cs + lr * LDC + lc;
    float* dst = out + (size_t)gm * N + gn;
    if (vec_out) {
      *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2], src[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (gn + e < N) dst[e] = src[e];
    }
  }
}

// Raises a kernel's dynamic shared-memory limit once per device.
template <typename Kern> cudaError_t allow_smem(Kern kernel, int bytes, unsigned& done_mask) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && (done_mask >> dev) & 1u) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 32) done_mask |= 1u << dev;
  return err;
}

struct Args {
  const int8_t* xq;
  const int8_t* wq;
  const float* xs;
  const float* ws;
  float* out;
  int M, N, K, splits, k_per, x_width, w_width;
  int* partials;
  int* counters;
};

template <int BM, bool VA, bool VB> cudaError_t launch(const Args& a, cudaStream_t stream) {
  static unsigned configured = 0;
  auto kernel = int8_mma_kernel<BM, VA, VB>;
  const cudaError_t err = allow_smem(kernel, Tile<BM>::SMEM, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM, a.splits);
  kernel<<<grid, THREADS, Tile<BM>::SMEM, stream>>>(a.xq, a.wq, a.xs, a.ws, a.out, a.M, a.N, a.K, a.k_per,
                                                    a.x_width == 4, a.w_width == 4, a.partials, a.counters);
  return cudaGetLastError();
}

template <int BM> cudaError_t dispatch(const Args& a, cudaStream_t st) {
  const bool va = a.x_width == 16, vb = a.w_width == 16;
  if (va && vb) return launch<BM, true, true>(a, st);
  if (va) return launch<BM, true, false>(a, st);
  if (vb) return launch<BM, false, true>(a, st);
  return launch<BM, false, false>(a, st);
}

}  // namespace

// bm: the row tile (16, 64 or 128); splits, k_per: the K splits and the BK
// steps each covers; x_width, w_width: the load width of x_q and w_q in bytes
// (16: cp.async, 4: narrow words, 1: narrow bytes; the wrapper has checked K,
// N and the pointers); partials, counters: the wrapper's per-device split-K
// workspace and per-tile arrival counters (zero between launches).  Launches
// on `stream` (PyTorch's current stream); returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch, and cudaErrorInvalidValue for
// a row tile it does not take.
extern "C" int repro_int8_matmul(const void* xq, const void* wq, const void* xs, const void* ws, void* out,
                                 int M, int N, int K, int bm, int splits, int k_per, int x_width, int w_width,
                                 void* partials, void* counters, void* stream) {
  const Args a{static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq), static_cast<const float*>(xs),
               static_cast<const float*>(ws), static_cast<float*>(out), M, N, K, splits, k_per, x_width, w_width,
               static_cast<int*>(partials), static_cast<int*>(counters)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case 16: return static_cast<int>(dispatch<16>(a, st));
    case 64: return static_cast<int>(dispatch<64>(a, st));
    case 128: return static_cast<int>(dispatch<128>(a, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
