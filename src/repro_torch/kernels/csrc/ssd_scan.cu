// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py `ssd_scan_bhsd`
// (`_ssd_kernel`, entry `ssd_scan`).  Same function, for batch row b and
// head h, chunk by chunk (chunk starts at multiples of `chunk`, the last
// chunk may be short), with the state H [hd, N] carried across chunks:
//   s     = cumsum(dt * A)                                  (per chunk)
//   y_i   = sum_{j <= i} (C_i . B_j) exp(s_i - s_j) dt_j x_j
//           + exp(s_i) (C_i . H_in)
//   H_out = exp(s_last) H_in + sum_j exp(s_last - s_j) dt_j x_j (x) B_j
// (no D term: the model adds it).  Inputs in the model layout, read in
// place: x [B, S, nh, hd] and B/C [B, S, N] in f32 or bf16, dt [B, S, nh]
// post-softplus f32, A [nh] f32, h0 [B, nh, hd, N] f32; outputs y in x's
// type and the final state in f32.  All arithmetic is f32.
//
// The TPU kernel pads S to a chunk multiple with dt = 0; here a short
// last chunk simply stops at its real rows.  A row with dt = 0 has decay
// 1 and injects nothing, and this kernel keeps that exact to the bit
// (the cumsum's order is fixed per row, `scan_chunk`): a serving chunk
// padded with dt = 0 rows leaves the same state and real rows' y as the
// unpadded chunk, so a session's tokens cannot depend on its padding.
//
// What bounds it on the H100: at the serving shapes (Q <= 256 rows,
// hd 64, N 128) bytes.  The least work per (b, chunk) is C B^T over the
// causal triangle once (B and C are shared by the heads), then per head
// the triangle's product with x, C H_in^T and the state update: with
// T = Q(Q+1)/2, 2TN + nh (2T hd + 4Q hd N) flops, against x, dt, B, C,
// h0 and A read once and y, h written once.  This first version is neither: it is a
// simple CUDA-core kernel, one block of 256 threads per (head, batch
// row) looping over the chunks in order (the TPU's sequential chunk grid
// axis becomes that loop), so a 160-token chunk of mamba2-780m runs 48
// blocks on 132 SMs.  What the design does:
//   * the [hd, N] f32 state stays in shared memory across the whole
//     chunk loop and is read from and written to device memory once;
//   * a chunk of up to 256 rows does not fit shared memory as a
//     [Q, Q] f32 score tile (256 KB), so query rows are taken 32 at a
//     time against key tiles j <= i of 32 rows, and only a [32, 32]
//     score tile is ever held;
//   * the causal decay is a select, never a 0/1 mask times exp: for
//     j > i the exponent s_i - s_j is positive and exp may overflow, and
//     inf * 0 is NaN;
//   * B and C are shared by all heads (ngroups = 1): the 48 blocks of a
//     batch row read the same tiles, which L2 serves after the first.
// Known limits: the score, state and output products run on CUDA cores
// (no mma / wgmma), and each query tile reloads its key tiles; both are
// the next kernel work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTQ = 32;            // rows per query / key tile
constexpr int kMaxChunk = 256;     // chunk rows the cumsum covers
constexpr int kSRows = kMaxChunk + kTQ;   // s / dt rows incl. tile overhang

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int HD, int N>
constexpr int smem_floats() {
  return N * HD                 // Ht   [N][HD]   carried state, transposed
         + 2 * kSRows           // s, dt
         + kTQ * N              // Ct   [kTQ][N]  query-tile C rows
         + kTQ * (N + 1)        // Bt   [kTQ][N+1] key-tile B rows (padded)
         + kTQ * HD             // Xt   [kTQ][HD] key-tile x rows
         + kTQ * (kTQ + 1)      // Mt   [kTQ][kTQ+1] score tile (padded)
         + kTQ;                 // w    state-update weights of a key tile
}

// Load rows [r0, r0 + kTQ) of a [rows, width] slab (row stride `stride`
// elements) into a shared tile with row pitch `pitch`; rows >= q are 0.
template <typename T, int W>
__device__ __forceinline__ void load_tile(float* dst, int pitch, const T* src,
                                          long long stride, int r0, int q) {
  for (int e = threadIdx.x; e < kTQ * W; e += kThreads) {
    const int r = e / W, c = e % W;
    dst[r * pitch + c] = (r0 + r < q) ? to_f(src[(long long)(r0 + r) * stride + c]) : 0.f;
  }
}

// In-place inclusive prefix sum of s[0, kMaxChunk) by one warp, in f64
// and rounded once to f32: lane l sums its 8 rows in order, then adds
// the lanes before it in order.  f64 makes each s_i the f32 rounding of
// its exact sum (|s| reaches ~10^3 over a 256-row chunk, where an f32
// running sum drifts by several ulp), so the kernel and its plain
// version (an f64 cumsum too) see the same decays.  The association of
// s[i] depends on i alone, and a run of trailing zeros adds exact zeros,
// so s[last] of a chunk padded with dt = 0 rows equals, bit for bit,
// s[last real row] of the unpadded chunk: padding cannot change the
// carried state by even a rounding.
__device__ __forceinline__ void scan_chunk(float* s, int lane) {
  constexpr int kPer = kMaxChunk / 32;
  double loc[kPer];
  double run = 0.0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    run += (double)s[lane * kPer + k];
    loc[k] = run;
  }
  double before = 0.0;
  for (int l = 0; l < 31; ++l) {
    const double t = __shfl_sync(0xffffffffu, run, l);
    if (l < lane) before += t;
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) s[lane * kPer + k] = (float)(before + loc[k]);
}

template <typename T, int HD, int N>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ h0,
                T* __restrict__ y, float* __restrict__ hout, int S, int nh,
                int chunk) {
  static_assert(kThreads % HD == 0 && kTQ % (kThreads / HD) == 0, "HD");
  static_assert((N * HD) % kThreads == 0 && N % (kThreads / HD) == 0, "N");
  constexpr int IG = kThreads / HD;      // row groups of the HD-wide maps
  constexpr int KY = kTQ / IG;           // output rows per thread
  constexpr int KH = N / IG;             // state columns per thread

  extern __shared__ float smem[];
  float* Ht = smem;
  float* s_cum = Ht + N * HD;
  float* s_dt = s_cum + kSRows;
  float* Ct = s_dt + kSRows;
  float* Bt = Ct + kTQ * N;
  float* Xt = Bt + kTQ * (N + 1);
  float* Mt = Xt + kTQ * HD;
  float* wv = Mt + kTQ * (kTQ + 1);

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int d = tid % HD, ig = tid / HD;
  const float a = A[h];
  const long long xs = (long long)nh * HD;           // x / y row stride
  const float* h0p = h0 + ((long long)b * nh + h) * HD * N;
  for (int e = tid; e < HD * N; e += kThreads) Ht[(e % N) * HD + e / N] = h0p[e];

  for (int c0 = 0; c0 < S; c0 += chunk) {
    const int q = min(chunk, S - c0);
    const T* xc = x + ((long long)b * S + c0) * xs + (long long)h * HD;
    const T* bc = Bm + ((long long)b * S + c0) * N;
    const T* cc = Cm + ((long long)b * S + c0) * N;
    T* yc = y + ((long long)b * S + c0) * xs + (long long)h * HD;

    // s = cumsum(dt * A) over the chunk (see scan_chunk)
    __syncthreads();                   // the previous chunk is done with s
    for (int i = tid; i < kSRows; i += kThreads) {
      const float v = (i < q) ? dt[((long long)b * S + c0 + i) * nh + h] : 0.f;
      s_dt[i] = v;
      s_cum[i] = v * a;
    }
    __syncthreads();
    if (tid < 32) scan_chunk(s_cum, tid);
    __syncthreads();
    const float s_last = s_cum[q - 1];

    // y, 32 query rows at a time
    for (int i0 = 0; i0 < q; i0 += kTQ) {
      __syncthreads();                 // Ct is free
      load_tile<T, N>(Ct, N, cc, N, i0, q);
      __syncthreads();
      float yacc[KY];
      // carried-in state: exp(s_i) * (C_i . H_in[d, :])
#pragma unroll
      for (int k = 0; k < KY; ++k) {
        const int r = ig + IG * k;
        float sacc = 0.f;
#pragma unroll 8
        for (int n = 0; n < N; ++n) sacc += Ct[r * N + n] * Ht[n * HD + d];
        yacc[k] = (i0 + r < q) ? expf(s_cum[i0 + r]) * sacc : 0.f;
      }
      // intra-chunk: key tiles j0 <= i0
      for (int j0 = 0; j0 <= i0; j0 += kTQ) {
        __syncthreads();               // Bt / Xt / Mt are free
        load_tile<T, N>(Bt, N + 1, bc, N, j0, q);
        load_tile<T, HD>(Xt, HD, xc, xs, j0, q);
        __syncthreads();
        {
          const int jj = tid & 31, ib = tid >> 5;   // 8 warps x 4 rows
          float sc[kTQ / 8];
#pragma unroll
          for (int k = 0; k < kTQ / 8; ++k) sc[k] = 0.f;
#pragma unroll 8
          for (int n = 0; n < N; ++n) {
            const float bv = Bt[jj * (N + 1) + n];
#pragma unroll
            for (int k = 0; k < kTQ / 8; ++k) sc[k] += Ct[(ib + 8 * k) * N + n] * bv;
          }
          const int jg = j0 + jj;
          const float sj = s_cum[jg], dtj = s_dt[jg];
#pragma unroll
          for (int k = 0; k < kTQ / 8; ++k) {
            const int r = ib + 8 * k, igl = i0 + r;
            // select, not mask * exp: exp(s_i - s_j) overflows for j > i
            const float dec = (igl >= jg && igl < q) ? expf(s_cum[igl] - sj) : 0.f;
            Mt[r * (kTQ + 1) + jj] = sc[k] * dec * dtj;
          }
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < KY; ++k) {
          const int r = ig + IG * k;
#pragma unroll 8
          for (int jj = 0; jj < kTQ; ++jj) yacc[k] += Mt[r * (kTQ + 1) + jj] * Xt[jj * HD + d];
        }
      }
#pragma unroll
      for (int k = 0; k < KY; ++k) {
        const int r = i0 + ig + IG * k;
        if (r < q) yc[(long long)r * xs + d] = from_f<T>(yacc[k]);
      }
    }

    // end-of-chunk state: H = exp(s_last) H + sum_j w_j x_j (x) B_j
    __syncthreads();                   // every y row has read H_in
    float hacc[KH];
    const float carry = expf(s_last);
#pragma unroll
    for (int k = 0; k < KH; ++k) hacc[k] = Ht[(ig + IG * k) * HD + d] * carry;
    for (int j0 = 0; j0 < q; j0 += kTQ) {
      __syncthreads();
      load_tile<T, N>(Bt, N + 1, bc, N, j0, q);
      load_tile<T, HD>(Xt, HD, xc, xs, j0, q);
      if (tid < kTQ) {
        const int jg = j0 + tid;
        wv[tid] = (jg < q) ? expf(s_last - s_cum[jg]) * s_dt[jg] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int jj = 0; jj < kTQ; ++jj) {
        const float xw = Xt[jj * HD + d] * wv[jj];
#pragma unroll
        for (int k = 0; k < KH; ++k) hacc[k] += xw * Bt[jj * (N + 1) + ig + IG * k];
      }
    }
#pragma unroll
    for (int k = 0; k < KH; ++k) Ht[(ig + IG * k) * HD + d] = hacc[k];
  }
  __syncthreads();
  float* hp = hout + ((long long)b * nh + h) * HD * N;
  for (int e = tid; e < HD * N; e += kThreads) hp[e] = Ht[(e % N) * HD + e / N];
}

template <typename T, int HD, int N>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* h0, void* y, void* hout, int B, int S,
           int nh, int chunk, cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD, N>() * (int)sizeof(float);
  auto kern = ssd_scan_kernel<T, HD, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(nh, B), kThreads, bytes, stream>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)Bm,
      (const T*)Cm, (const float*)h0, (T*)y, (float*)hout, S, nh, chunk);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_shape(const void* x, const void* dt, const void* A, const void* Bm,
                   const void* Cm, const void* h0, void* y, void* hout, int B,
                   int S, int nh, int hd, int N, int chunk, cudaStream_t st) {
  if (hd == 64 && N == 128)
    return launch<T, 64, 128>(x, dt, A, Bm, Cm, h0, y, hout, B, S, nh, chunk, st);
  if (hd == 32 && N == 16)
    return launch<T, 32, 16>(x, dt, A, Bm, Cm, h0, y, hout, B, S, nh, chunk, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Every tensor contiguous in the layout above; dtype 0 = f32, 1 = bf16
// (x, B, C, y).  Returns a CUDA error code (0 on a successful launch).
extern "C" int ssd_scan(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, const void* h0, void* y,
                        void* hout, int dtype, int B, int S, int nh, int hd, int N,
                        int chunk, void* stream) {
  if (B <= 0 || S <= 0 || nh <= 0) return 0;
  if (chunk < 1 || chunk > kMaxChunk) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_shape<float>(x, dt, A, Bm, Cm, h0, y, hout, B, S, nh, hd, N,
                                 chunk, st);
  if (dtype == 1)
    return dispatch_shape<__nv_bfloat16>(x, dt, A, Bm, Cm, h0, y, hout, B, S, nh,
                                         hd, N, chunk, st);
  return (int)cudaErrorInvalidValue;
}
