// Flash attention forward, GQA-aware, for Hopper (sm_90a).
//
//   out[b, s, h, :] = softmax_t(q[b, s, h, :] . k[b, t, h / G, :] * sm_scale + mask) . v[b, t, h / G, :]
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention, body _kernel) and keeps its arithmetic (kernel.py:44-71):
//   * s = dot(q, k) accumulated in f32, THEN multiplied by sm_scale;
//   * invalid columns (col >= T, and col > row + T - S when causal: the mask
//     is bottom-right aligned) are set to -1e30, never -inf, and the running
//     max m starts at -1e30;
//   * l <- l * alpha + sum(p) over the unrounded f32 p;
//   * acc <- acc * alpha + (p cast to v's dtype) . v, accumulated in f32;
//   * out = acc / max(l, 1e-30), cast to q's dtype.
//
// Row layout (both kernels).  The G = H / KH query heads of one KV head are
// folded into one row axis of G * S rows ordered (s, g), s slowest, so one
// block's rows cover a few consecutive positions with all G heads of one KV
// head: every K/V tile staged in shared memory serves all of them (the
// reference's GQA fold), and the block's causal bound is tight.  Grid:
// x = 16-row tiles of that axis, y = b * KH + kh.  q is read in place from
// [B, S, H, hd] and k, v from [B, T, KH, hd]: the host transposes and pads
// nothing.  Rows past G * S and columns past T load as 0 and are never
// stored; columns past T get p = 0 outright (the TPU kernel gives them
// exp(-1e30 - m), which is 0 for every row that has a valid column).  So a
// row with no valid column at all (causal with S > T) sees -1e30 on all T
// columns and comes out as the mean of v over T, as in the plain version's
// softmax; a block holding such a row sweeps every tile.  KV tiles wholly
// above the causal bound of every row of the block are skipped: for every
// row that has a valid column their contribution is exactly zero.
//
// What bounds it on an H100.  At ViT-S/16's shape (S = T = 197, H = KH = 6,
// hd 64, bf16, batch 1) one call moves ~0.6 MB and does ~60 MFLOP: the
// floor is the bytes, ~0.18 us at 3.35 TB/s, far below a launch.  What a
// call really waits on is latency: the dependent chain of loads, products
// and the softmax of one block.  So the design cuts the chain:
//
// bf16, tensor cores (mma_attention_kernel).  One block of 4 warps owns one
// 16-row tile (one m16 mma tile) and the 4 warps split the KV tiles among
// themselves, round robin: a split-KV inside one block, with no second
// launch.  ViT-S/16 at batch 1 runs ceil(197 / 16) * 6 = 78 blocks, each
// warp walking 2 of the 7 KV tiles of 32 columns rather than all 7, and 624
// blocks at batch 8.
//   * q.k^T and p.v run on mma.sync.m16n8k16 (bf16 in, f32 accumulate), fed
//     by ldmatrix: non-transposed for q and k ([t][hd] is k^T's column-major
//     layout), .trans for v.  p goes from the q.k accumulators straight into
//     the p.v A operand, rounded to bf16.
//   * Each warp stages its K/V tiles with 16-byte cp.async copies into its
//     own two buffers, so the next tile's load overlaps this tile's math and
//     warps never wait on each other until the merge.  ldmatrix reads are
//     free of bank conflicts: at hd >= 64 the 16-byte chunks of a row are
//     XOR-swizzled by the row (no padding: 68 KB a block at hd 64, so 3
//     blocks fit an SM), below it rows are padded by 16 bytes.
//   * At the end each warp's (m_w, l_w, acc_w) is merged through shared
//     memory: m = max_w m_w, l = sum_w l_w exp(m_w - m), acc = sum_w acc_w
//     exp(m_w - m).  A warp whose columns are all masked for a row holds
//     m_w = -1e30 there and drops out exactly through exp(m_w - m) = 0; a
//     warp with no tile holds l_w = 0 and acc_w = 0; a row with no valid
//     column anywhere has every m_w = m = -1e30 and sums p = 1 over all T.
//   * KV tiles are 32 columns for hd <= 64 and 16 for hd = 128, which keeps
//     the staging at 64 KB a block and hd = 128 at 64 f32 accumulators a
//     thread.
//   * It needs q, k and v 16-byte aligned (every row then is, since
//     hd * 2 >= 32 bytes); the wrapper sends a misaligned view to the
//     CUDA-core kernel below.
//
// f32 keeps the CUDA-core kernel (fma_attention_kernel): the reference's f32
// tolerance (rtol 1e-4, atol 2e-5, tests/test_kernels.py:154) rules out
// TF32, the only f32 input the tensor cores take, and f32 is not on the
// serving path.  There one block of 4 warps owns 16 rows for the whole KV
// sweep (4 rows a warp, online-softmax state in registers) over 32-column
// tiles in shared memory, with CUDA-core f32 FMAs.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC \
//        -o libflash_attention.so flash_attention.cu

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NW = 4;            // warps per block
constexpr int ROWS = 16;         // query rows per block
constexpr int THREADS = NW * 32;
constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// CUDA-core kernel: f32, and bf16 views that are not 16-byte aligned.
// ---------------------------------------------------------------------------

constexpr int R = ROWS / NW;     // query rows per warp
constexpr int BKV = 32;          // KV columns per tile: one per lane

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// p cast to v's dtype, as the TPU kernel does before its p.v product.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The last KV column (exclusive) any row of the block starting at fr0 sees.
// Causal: no row sees a column past last_s + T - S, unless the block's first
// row sees none at all (then that row averages all T columns).
template <bool CAUSAL>
__device__ __forceinline__ int kv_end(long long fr0, long long rows_total, int G, int S, int Tk) {
  if (!CAUSAL || fr0 / G + Tk - S < 0) return Tk;
  const long long last_fr = fr0 + ROWS - 1 < rows_total ? fr0 + ROWS - 1 : rows_total - 1;
  const long long lim = last_fr / G + Tk - S + 1;
  return lim < Tk ? (int)lim : Tk;
}

template <typename T, int HD, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
fma_attention_kernel(const T* __restrict__ q,   // [B, S, H, HD]
                     const T* __restrict__ k,   // [B, T, KH, HD]
                     const T* __restrict__ v,   // [B, T, KH, HD]
                     T* __restrict__ out,       // [B, S, H, HD]
                     int S, int Tk, int H, int KH, float sm_scale) {
  constexpr int NE = (HD + 31) / 32;  // output elements per lane
  constexpr int KLD = HD + 1;         // padded K row: lanes read distinct banks
  __shared__ float qs[ROWS][HD];
  __shared__ float ks[BKV * KLD];
  __shared__ float vs[BKV][HD];
  __shared__ float ps[NW][R][BKV];

  const int G = H / KH;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int bkh = blockIdx.y;
  const int b = bkh / KH, kh = bkh % KH;
  const long long rows_total = (long long)G * S;
  const long long fr0 = (long long)blockIdx.x * ROWS;

  // Stage the block's query rows (row fr = s * G + g is head kh * G + g).
  for (int idx = tid; idx < ROWS * HD; idx += THREADS) {
    const int r = idx / HD, d = idx % HD;
    const long long fr = fr0 + r;
    float x = 0.f;
    if (fr < rows_total) {
      const long long s = fr / G, g = fr % G;
      x = to_float(q[(((long long)b * S + s) * H + (long long)kh * G + g) * HD + d]);
    }
    qs[r][d] = x;
  }

  int srow[R];  // query position of each of this warp's rows
  float m[R], l[R], acc[R][NE];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long fr = fr0 + warp * R + r;
    srow[r] = (int)((fr < rows_total ? fr : rows_total - 1) / G);
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < NE; ++e) acc[r][e] = 0.f;
  }

  const int t_end = kv_end<CAUSAL>(fr0, rows_total, G, S, Tk);
  const long long kv_base = (long long)b * Tk * KH + kh;  // (b, t=0, kh) in rows of HD
  for (int t0 = 0; t0 < t_end; t0 += BKV) {
    __syncthreads();  // the previous tile is no longer read
    for (int idx = tid; idx < BKV * HD; idx += THREADS) {
      const int j = idx / HD, d = idx % HD;
      const int t = t0 + j;
      float kx = 0.f, vx = 0.f;
      if (t < Tk) {
        const long long off = (kv_base + (long long)t * KH) * HD + d;
        kx = to_float(k[off]);
        vx = to_float(v[off]);
      }
      ks[j * KLD + d] = kx;
      vs[j][d] = vx;
    }
    __syncthreads();

    // s = q . k for column t0 + lane of each of the warp's rows.
    float sc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) sc[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float kd = ks[lane * KLD + d];
#pragma unroll
      for (int r = 0; r < R; ++r) sc[r] = fmaf(qs[warp * R + r][d], kd, sc[r]);
    }

    const int col = t0 + lane;
    float alpha[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      bool valid = col < Tk;
      if (CAUSAL) valid = valid && (col <= srow[r] + Tk - S);
      const float s = valid ? sc[r] * sm_scale : NEG_INF;
      const float m_new = fmaxf(m[r], warp_max(s));
      alpha[r] = expf(m[r] - m_new);
      const float p = col < Tk ? expf(s - m_new) : 0.f;
      l[r] = l[r] * alpha[r] + warp_sum(p);
      m[r] = m_new;
      ps[warp][r][lane] = round_to<T>(p);
    }
    __syncwarp();

    // acc = acc * alpha + p . v, each lane on its own output elements.
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int d = lane + 32 * e;
      if (d < HD) {
        float pv[R];
#pragma unroll
        for (int r = 0; r < R; ++r) pv[r] = 0.f;
#pragma unroll 8
        for (int j = 0; j < BKV; ++j) {
          const float vj = vs[j][d];
#pragma unroll
          for (int r = 0; r < R; ++r) pv[r] = fmaf(ps[warp][r][j], vj, pv[r]);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r][e] = acc[r][e] * alpha[r] + pv[r];
      }
    }
    __syncwarp();  // ps is rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long fr = fr0 + warp * R + r;
    if (fr >= rows_total) continue;
    const long long s = fr / G, g = fr % G;
    T* dst = out + (((long long)b * S + s) * H + (long long)kh * G + g) * HD;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int d = lane + 32 * e;
      if (d < HD) dst[d] = from_float<T>(acc[r][e] / denom);
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core kernel: bf16.
// ---------------------------------------------------------------------------

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
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c[16x8 f32] += a[16x16 bf16, row] . b[16x8 bf16, col]
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int HD> struct MmaCfg {
  static constexpr int KV = HD <= 64 ? 32 : 16;       // KV columns per tile
  static constexpr bool SWIZZLE = HD >= 64;           // rows of >= 8 16-byte chunks: XOR-swizzled, else padded
  static constexpr int LD = SWIZZLE ? HD : HD + 8;    // bf16 per staged row
  static constexpr int TILE = KV * LD;                 // bf16 per K or V tile
  // Offset of element `col` (a multiple of 8) of staged row `row`.  The 8
  // rows one ldmatrix phase reads land on 8 distinct 16-byte bank groups:
  // by the XOR of the chunk with the row where a row holds 8 chunks or more,
  // by a 16-byte pad otherwise.
  static __device__ __forceinline__ int at(int row, int col) {
    return SWIZZLE ? row * LD + ((((col >> 3) ^ (row & 7))) << 3) : row * LD + col;
  }
  static constexpr int Q_BYTES = ROWS * LD * 2;
  static constexpr int KV_BYTES = NW * 2 * 2 * TILE * 2;  // per warp: 2 stages of K and V
  static constexpr int RED_LD = HD + 4;                // f32 per row of the merge buffer
  static constexpr int RED_BYTES = NW * ROWS * RED_LD * 4;
  static constexpr int ML_BYTES = NW * 2 * ROWS * 4;
  static constexpr int SMEM = Q_BYTES + (KV_BYTES > RED_BYTES ? KV_BYTES : RED_BYTES) + ML_BYTES;
  static_assert(RED_BYTES <= KV_BYTES, "the merge buffer reuses the K/V stages");
};

template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
mma_attention_kernel(const __nv_bfloat16* __restrict__ q,   // [B, S, H, HD]
                     const __nv_bfloat16* __restrict__ k,   // [B, T, KH, HD]
                     const __nv_bfloat16* __restrict__ v,   // [B, T, KH, HD]
                     __nv_bfloat16* __restrict__ out,       // [B, S, H, HD]
                     int S, int Tk, int H, int KH, float sm_scale) {
  using C = MmaCfg<HD>;
  constexpr int KV = C::KV, CH = HD / 8;  // CH: 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);                   // [ROWS] rows of LD
  __nv_bfloat16* kvs = reinterpret_cast<__nv_bfloat16*>(smem + C::Q_BYTES);    // [NW][2][K, V][KV] rows of LD
  float* red = reinterpret_cast<float*>(smem + C::Q_BYTES);                     // [NW][ROWS][RED_LD], after the sweep
  float* ml = reinterpret_cast<float*>(smem + C::SMEM - C::ML_BYTES);           // [NW][m, l][ROWS]

  const int G = H / KH;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, t4 = lane & 3;  // mma fragment row group, thread in group
  const int b = blockIdx.y / KH, kh = blockIdx.y % KH;
  const long long rows_total = (long long)G * S;
  const long long fr0 = (long long)blockIdx.x * ROWS;

  // Stage the block's 16 query rows (one cp.async group).
  for (int c = tid; c < ROWS * CH; c += THREADS) {
    const int r = c / CH, d = (c % CH) * 8;
    const long long fr = fr0 + r;
    const __nv_bfloat16* src = q;
    int bytes = 0;
    if (fr < rows_total) {
      const long long s = fr / G, g = fr % G;
      src = q + (((long long)b * S + s) * H + (long long)kh * G + g) * HD + d;
      bytes = 16;
    }
    cp_async16(qs + C::at(r, d), src, bytes);
  }
  cp_async_commit();

  const int n_tiles = (kv_end<CAUSAL>(fr0, rows_total, G, S, Tk) + KV - 1) / KV;
  const long long kv_base = (long long)b * Tk * KH + kh;  // (b, t=0, kh) in rows of HD
  __nv_bfloat16* mine = kvs + warp * 2 * 2 * C::TILE;     // this warp's two stages
  auto load_tile = [&](int j, int stage) {
    __nv_bfloat16* ks = mine + stage * 2 * C::TILE;
    __nv_bfloat16* vs = ks + C::TILE;
    for (int c = lane; c < KV * CH; c += 32) {
      const int r = c / CH, d = (c % CH) * 8;
      const int t = j * KV + r;
      const long long off = (kv_base + (long long)(t < Tk ? t : Tk - 1) * KH) * HD + d;
      const int bytes = t < Tk ? 16 : 0;
      cp_async16(ks + C::at(r, d), k + off, bytes);
      cp_async16(vs + C::at(r, d), v + off, bytes);
    }
  };
  if (warp < n_tiles) load_tile(warp, 0);
  cp_async_commit();
  cp_async_wait<1>();  // this thread's q copies have landed
  __syncthreads();     // ... and every thread's

  uint32_t qf[HD / 16][4];  // q as mma A fragments, for the whole sweep
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldmatrix_x4(qf[kk], qs + C::at((lane & 7) + ((lane >> 3) & 1) * 8, kk * 16 + (lane >> 4) * 8));

  // Rows gq and gq + 8 of the tile: their query positions, and state.
  int srow[2];
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[HD / 8][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long fr = fr0 + gq + 8 * h;
    srow[h] = (int)((fr < rows_total ? fr : rows_total - 1) / G);
  }
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;

  int stage = 0;
  for (int j = warp; j < n_tiles; j += NW, stage ^= 1) {
    if (j + NW < n_tiles) load_tile(j + NW, stage ^ 1);  // the next tile's copy overlaps this tile's math
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    const __nv_bfloat16* ks = mine + stage * 2 * C::TILE;
    const __nv_bfloat16* vs = ks + C::TILE;

    // s = q . k^T over this tile's KV columns, f32 accumulators.
    float sc[KV / 8][4];
#pragma unroll
    for (int nt = 0; nt < KV / 8; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < KV / 16; ++np) {
        uint32_t kb[4];
        ldmatrix_x4(kb, ks + C::at(np * 16 + (lane & 7) + (lane >> 4) * 8, kk * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16(sc[2 * np], qf[kk], kb[0], kb[1]);
        mma_bf16(sc[2 * np + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // Online softmax on rows gq (h = 0) and gq + 8 (h = 1); a row's 32 (or
    // 16) columns lie on the 4 threads of one quad.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = NEG_INF;
#pragma unroll
      for (int nt = 0; nt < KV / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = j * KV + nt * 8 + 2 * t4 + e;
          bool valid = col < Tk;
          if (CAUSAL) valid = valid && (col <= srow[h] + Tk - S);
          const float s = valid ? sc[nt][2 * h + e] * sm_scale : NEG_INF;
          sc[nt][2 * h + e] = s;
          mx = fmaxf(mx, s);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const float alpha = __expf(m[h] - m_new);
      float ls = 0.f;
#pragma unroll
      for (int nt = 0; nt < KV / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = j * KV + nt * 8 + 2 * t4 + e;
          const float p = col < Tk ? __expf(sc[nt][2 * h + e] - m_new) : 0.f;
          sc[nt][2 * h + e] = p;
          ls += p;
        }
      l[h] = l[h] * alpha + ls;  // this thread's share of the row; summed over the quad at the end
      m[h] = m_new;
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        o[dt][2 * h] *= alpha;
        o[dt][2 * h + 1] *= alpha;
      }
    }

    // acc += bf16(p) . v: the accumulators of n-tiles 2kk, 2kk+1 are the A
    // fragment of k-step kk.
#pragma unroll
    for (int kk = 0; kk < KV / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]), pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vs + C::at(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, dp * 16 + (lane >> 4) * 8));
        mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
    __syncwarp();  // this stage is refilled two tiles on
  }
  cp_async_wait<0>();

  // Merge the 4 warps' (m, l, acc) through shared memory.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  __syncthreads();  // every warp is done with its K/V stages, which red reuses
  if (t4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ml[(warp * 2) * ROWS + gq + 8 * h] = m[h];
      ml[(warp * 2 + 1) * ROWS + gq + 8 * h] = l[h];
    }
  }
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* dst = red + (warp * ROWS + gq + 8 * h) * C::RED_LD + dt * 8 + 2 * t4;
      dst[0] = o[dt][2 * h];
      dst[1] = o[dt][2 * h + 1];
    }
  __syncthreads();

  // 8 threads a row, HD / 8 consecutive outputs each.
  constexpr int PER = HD / 8;
  const int r = tid / 8, c0 = (tid % 8) * PER;
  const long long fr = fr0 + r;
  if (fr >= rows_total) return;
  float mw[NW], mmax = NEG_INF;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    mw[w] = ml[(w * 2) * ROWS + r];
    mmax = fmaxf(mmax, mw[w]);
  }
  float wt[NW], lsum = 0.f;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    wt[w] = __expf(mw[w] - mmax);
    lsum += ml[(w * 2 + 1) * ROWS + r] * wt[w];
  }
  const float denom = fmaxf(lsum, 1e-30f);
  const long long s = fr / G, g = fr % G;
  __nv_bfloat16* dst = out + (((long long)b * S + s) * H + (long long)kh * G + g) * HD + c0;
#pragma unroll
  for (int e = 0; e < PER; e += 2) {
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float* src = red + (w * ROWS + r) * C::RED_LD + c0 + e;
      a0 += src[0] * wt[w];
      a1 += src[1] * wt[w];
    }
    *reinterpret_cast<__nv_bfloat162*>(dst + e) = __floats2bfloat162_rn(a0 / denom, a1 / denom);
  }
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------

// Raises a kernel's dynamic shared-memory limit once per device.
template <typename K> cudaError_t allow_smem(K kernel, int bytes, unsigned& done_mask) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && (done_mask >> dev) & 1u) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 32) done_mask |= 1u << dev;
  return err;
}

template <typename T, int HD, bool CAUSAL>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* out, dim3 grid, int S, int Tk,
                       int H, int KH, float sm_scale, cudaStream_t stream) {
  fma_attention_kernel<T, HD, CAUSAL><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(out), S,
      Tk, H, KH, sm_scale);
  return cudaGetLastError();
}

template <int HD, bool CAUSAL>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out, dim3 grid, int S, int Tk, int H,
                       int KH, float sm_scale, cudaStream_t stream) {
  static unsigned configured = 0;
  auto kernel = mma_attention_kernel<HD, CAUSAL>;
  const cudaError_t err = allow_smem(kernel, MmaCfg<HD>::SMEM, configured);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, MmaCfg<HD>::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), S, Tk, H, KH, sm_scale);
  return cudaGetLastError();
}

template <int HD, bool CAUSAL>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, dim3 grid, int S, int Tk, int H,
                     int KH, int dtype, int path, float sm_scale, cudaStream_t stream) {
  if (dtype == 0 && path == 0) return launch_fma<float, HD, CAUSAL>(q, k, v, out, grid, S, Tk, H, KH, sm_scale, stream);
  if (dtype == 1 && path == 0)
    return launch_fma<__nv_bfloat16, HD, CAUSAL>(q, k, v, out, grid, S, Tk, H, KH, sm_scale, stream);
  if (dtype == 1 && path == 1) return launch_mma<HD, CAUSAL>(q, k, v, out, grid, S, Tk, H, KH, sm_scale, stream);
  return cudaErrorInvalidValue;
}

template <int HD>
cudaError_t dispatch_causal(const void* q, const void* k, const void* v, void* out, dim3 grid, int S, int Tk,
                            int H, int KH, bool causal, int dtype, int path, float sm_scale, cudaStream_t stream) {
  return causal ? dispatch<HD, true>(q, k, v, out, grid, S, Tk, H, KH, dtype, path, sm_scale, stream)
                : dispatch<HD, false>(q, k, v, out, grid, S, Tk, H, KH, dtype, path, sm_scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  path: 0 = the CUDA-core kernel (f32, or
// bf16 views that are not 16-byte aligned), 1 = the tensor-core kernel (bf16,
// 16-byte aligned q, k, v).  Launches on `stream` (PyTorch's current stream);
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch, and cudaErrorInvalidValue for a combination it does not take.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out, int B, int S,
                                     int T, int H, int KH, int hd, int causal, int dtype, int path,
                                     float sm_scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)(H / KH) * S;
  const dim3 grid((unsigned)((rows + ROWS - 1) / ROWS), (unsigned)(B * KH));
  const bool c = causal != 0;
  cudaError_t err;
  switch (hd) {
    case 16: err = dispatch_causal<16>(q, k, v, out, grid, S, T, H, KH, c, dtype, path, sm_scale, st); break;
    case 32: err = dispatch_causal<32>(q, k, v, out, grid, S, T, H, KH, c, dtype, path, sm_scale, st); break;
    case 64: err = dispatch_causal<64>(q, k, v, out, grid, S, T, H, KH, c, dtype, path, sm_scale, st); break;
    case 128: err = dispatch_causal<128>(q, k, v, out, grid, S, T, H, KH, c, dtype, path, sm_scale, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
