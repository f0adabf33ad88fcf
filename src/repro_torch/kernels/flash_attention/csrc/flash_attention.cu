// Flash attention forward, GQA-aware, for Hopper (sm_90a).
//
//   out[b, s, h, :] = softmax_t(q[b, s, h, :] . k[b, t, h / G, :] * sm_scale + mask) . v[b, t, h / G, :]
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention, body _kernel) and keeps its arithmetic:
//   * s = dot(q, k) accumulated in f32, THEN multiplied by sm_scale;
//   * invalid columns (col >= T, and col > row + T - S when causal: the mask
//     is bottom-right aligned) are set to -1e30, never -inf, and the running
//     max m starts at -1e30;
//   * l <- l * alpha + sum(p) over the unrounded f32 p;
//   * acc <- acc * alpha + (p cast to v's dtype) . v, accumulated in f32;
//   * out = acc / max(l, 1e-30), cast to q's dtype.
//
// Layout.  The G = H / KH query heads of one KV head are folded into one row
// axis of G * S rows ordered (s, g), s slowest, so one block's rows cover a
// few consecutive positions with all G heads of one KV head: every K/V tile
// staged in shared memory serves all of them (the reference's GQA fold), and
// the causal bound of the block is tight.  Grid: x = row tiles of ROWS rows,
// y = b * KH + kh.  Each of the NW warps owns R rows for the whole KV sweep;
// its online-softmax state (m, l, acc) lives in registers.  A KV tile is 32
// columns: for q.k each lane owns one column and walks hd; for p.v each lane
// owns hd / 32 output elements (hd = 16 leaves half the lanes idle there).
// KV tiles that lie wholly above the causal bound of every row of the block
// are skipped: their contribution is exactly zero (alpha = 1, p = 0) for
// every row that has a valid column.  The TPU kernel runs them anyway.
// Columns past T get p = 0 outright (the TPU kernel gives them
// exp(-1e30 - m), which is 0 for every row that has a valid column).  So a
// row with no valid column at all (causal with S > T; self-attention never
// has one) sees -1e30 on all T columns and comes out as the mean of v over
// T, as in the plain version's softmax; a block holding such a row sweeps
// every tile.  The TPU kernel averages the zero-padded V there instead.
//
// What bounds it on an H100: at ViT-S/16's shape (S = T = 197, hd 64, bf16)
// one call moves ~0.6 MB per image and does ~60 MFLOP, so the floor is the
// bytes (~0.18 us at 3.35 TB/s).  This first version is the simple, right
// one: CUDA-core f32 FMAs out of shared memory, no tensor cores, no TMA, no
// pipelining of the K/V loads.  mma/wgmma and cp.async/TMA are later work.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC \
//        -o libflash_attention.so flash_attention.cu

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NW = 4;            // warps per block
constexpr int R = 4;             // query rows per warp
constexpr int ROWS = NW * R;     // query rows per block
constexpr int BKV = 32;          // KV columns per tile: one per lane
constexpr int THREADS = NW * 32;
constexpr float NEG_INF = -1e30f;

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

template <typename T, int HD, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q,   // [B, S, H, HD]
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

  // Causal: no row of this block sees a column past last_s + T - S, unless
  // its first row sees none at all (then that row averages all T columns).
  int t_end = Tk;
  if (CAUSAL && fr0 / G + Tk - S >= 0) {
    const long long last_fr = fr0 + ROWS - 1 < rows_total ? fr0 + ROWS - 1 : rows_total - 1;
    const long long lim = last_fr / G + Tk - S + 1;
    t_end = lim < Tk ? (int)lim : Tk;
  }

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

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int S,
                   int Tk, int H, int KH, bool causal, float sm_scale, cudaStream_t stream) {
  const long long rows = (long long)(H / KH) * S;
  const dim3 grid((unsigned)((rows + ROWS - 1) / ROWS), (unsigned)(B * KH));
  auto kernel = causal ? flash_attention_kernel<T, HD, true> : flash_attention_kernel<T, HD, false>;
  kernel<<<grid, THREADS, 0, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                       static_cast<const T*>(v), static_cast<T*>(out), S, Tk, H,
                                       KH, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* out, int B, int S,
                        int Tk, int H, int KH, int hd, bool causal, float sm_scale,
                        cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, out, B, S, Tk, H, KH, causal, sm_scale, stream);
    case 32: return launch<T, 32>(q, k, v, out, B, S, Tk, H, KH, causal, sm_scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, B, S, Tk, H, KH, causal, sm_scale, stream);
    case 128: return launch<T, 128>(q, k, v, out, B, S, Tk, H, KH, causal, sm_scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Launches on `stream` (PyTorch's current
// stream); returns cudaGetLastError() so the Python wrapper can raise on a
// refused launch, and cudaErrorInvalidValue for a dtype or hd it does not take.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int B, int S, int T, int H, int KH, int hd, int causal,
                                     int dtype, float sm_scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_hd<float>(q, k, v, out, B, S, T, H, KH, hd, causal != 0, sm_scale, st);
  else if (dtype == 1)
    err = dispatch_hd<__nv_bfloat16>(q, k, v, out, B, S, T, H, KH, hd, causal != 0, sm_scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
