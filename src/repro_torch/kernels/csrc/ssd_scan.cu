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
// type and the final state in f32.
//
// The TPU kernel pads S to a chunk multiple with dt = 0; here a short
// last chunk simply stops at its real rows.  A row with dt = 0 has decay
// 1 and injects nothing, and both bodies keep that exact to the bit (the
// cumsum's order is fixed per row, `scan_chunk`; tile boundaries depend on
// the chunk start alone; rows past the chunk's end are never read and
// enter every product as exact zeros): a serving chunk padded with dt = 0
// rows leaves the same state and real rows' y as the unpadded chunk, so a
// session's tokens cannot depend on its padding.
//
// What bounds it on the H100: at the serving shapes (Q <= 256 rows,
// hd 64, N 128) bytes.  The least work per (b, chunk) is C B^T over the
// causal triangle once (B and C are shared by the heads), then per head
// the triangle's product with x, C H_in^T and the state update: with
// T = Q(Q+1)/2, 2TN + nh (2T hd + 4Q hd N) flops, against x, dt, B, C,
// h0 and A read once and y, h written once.
//
// bf16 (`ssd_scan_tc_kernel`): the products run on the tensor cores.
//   * grid (hd / 16, nh, B): a block owns 16 columns of hd of one (batch
//     row, head).  y[:, d] and H[d, :] depend only on x[:, d] and
//     H_in[d, :], so the blocks share nothing.  A mamba2-780m cold chunk
//     (B 1, nh 48, hd 64) runs 192 blocks, two resident an SM (90 KB of
//     shared memory, at most 128 registers a thread): one wave on 132 SMs.
//     The plan comes from static shapes alone (`tc_plan` in ssd_scan.py);
//   * the chunks are a loop inside the block (the TPU's sequential chunk
//     axis), and the block's [16, N] f32 state stays in shared memory
//     across it, beside its bf16 hi and lo halves; the warps that own its
//     columns update it as mma accumulators at each chunk's end;
//   * a chunk's B rows [Q, N] and x slice [Q, 16] are copied into shared
//     memory once by 16-byte cp.async (rows past the chunk's end
//     zero-filled, never read), XOR-swizzled so that ldmatrix meets no
//     bank conflict, and serve y and the state update alike.  A query
//     tile's C rows go from device memory straight into the A fragments
//     of the warp that owns the tile.  B and C are the same for all
//     heads: L2 serves the blocks after the first.  Every load of a chunk
//     is issued before any is waited for, and the last warp (the least y
//     work) loads dt and runs the cumsum while the others wait for theirs;
//   * every product is `mma.sync` m16n8k16, bf16 in, f32 out.  Its 16-row
//     tiles fit Q of 1 to 256 and the 16-column slice; wgmma's 64-row
//     tiles would leave most of a 160-row chunk's last tile empty and
//     take four warps a tile:
//       - G = C B^T per (query tile, key tile <= it), recomputed by each
//         slice's block (6.5 MFLOP at Q = 160);
//       - decay and dt are applied to G's accumulator in registers by a
//         select, never a 0/1 mask times exp (exp(s_i - s_j) overflows
//         for j > i, and inf * 0 is NaN); the exponent is selected as
//         well, so every lane takes every exp and none branches;
//       - M becomes the A operand of M x without a trip through shared
//         memory, as two bf16 operands, hi = bf16(M) and lo =
//         bf16(M - hi).  One bf16 rounding of M moves y by about 2^-9 of
//         its size, a third of a bf16 ulp, enough to flip the rounding of
//         y in about a quarter of the outputs; where |y| >= 4 (the smoke
//         widths' N = 16) one flip is 0.031, over the bf16 tolerance of
//         2e-2.  Split, M keeps about 16 bits more, for 2 more products a
//         key tile beside G's 16;
//       - the carried state must stay close to f32 (it crosses chunks,
//         calls and every turn of a session), so C H_in^T takes H_in as
//         hi + lo too, and the update sum_j (w_j x_j) (x) B_j takes
//         w_j x_j likewise.  H_out = exp(s_last) H_in + dH is formed in
//         f32 in registers;
//   * 8 warps.  Query tiles go to the warps longest first, in a zigzag,
//     so that each warp's share of the causal triangle is about even;
//     the state's N columns are split evenly among the warps.
//
// f32 (`ssd_scan_kernel`): the products run on the CUDA cores (the f32
// identity checks hold engine streams to the oracle, and no tensor-core
// type is exact in f32).  One block of 256 threads per (head, batch row)
// loops over the chunks in order, all arithmetic in f32:
//   * the [hd, N] f32 state stays in shared memory across the whole
//     chunk loop and is read from and written to device memory once;
//   * a chunk of up to 256 rows does not fit shared memory as a
//     [Q, Q] f32 score tile (256 KB), so query rows are taken 32 at a
//     time against key tiles j <= i of 32 rows, and only a [32, 32]
//     score tile is ever held;
//   * the causal decay is a select, as above;
//   * B and C are shared by all heads (ngroups = 1): the blocks of a
//     batch row read the same tiles, which L2 serves after the first.
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

// ---------------------------------------------------------------------------
// bf16: the tensor-core body
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const int n = valid ? 16 : 0;   // 0 source bytes: the 16 bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give matrix i's row addresses
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a b: a 16x16 (row), b 16x8 (col), bf16 in, f32 out
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// hi = bf16(v), lo = bf16(v - hi), for a pair of adjacent values
__device__ __forceinline__ void split_bf16(float v0, float v1, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16(v0 - __low2float(h), v1 - __high2float(h));
}

namespace tc {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kDS = 16;     // hd columns of a block
constexpr int kT = 16;      // rows of a query or key tile

// Shared memory of a block, byte offsets, for chunks of up to kMaxChunk rows.
template <int N>
struct Layout {
  static constexpr int kB = 0;                              // [256][N] bf16
  static constexpr int kX = kB + kMaxChunk * N * 2;         // [256][16] bf16
  static constexpr int kHhi = kX + kMaxChunk * kDS * 2;     // [16][N] bf16
  static constexpr int kHlo = kHhi + kDS * N * 2;           // [16][N] bf16
  static constexpr int kHf = kHlo + kDS * N * 2;            // [16][N] f32
  static constexpr int kS = kHf + kDS * N * 4;              // [256] f32
  static constexpr int kDt = kS + kMaxChunk * 4;            // [256] f32
  static constexpr int kBytes = kDt + kMaxChunk * 4;
};

// Byte offset of 16-byte chunk c of row r in a tile whose rows hold P
// chunks, XOR-swizzled: the 8 rows one ldmatrix phase reads (8 aligned
// rows, one chunk each) fall on 8 distinct groups of 4 banks.
template <int P>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int kDiv = P >= 8 ? 1 : 8 / P;
  constexpr int kMod = P >= 8 ? 8 : P;
  return (r * P + (c ^ ((r / kDiv) % kMod))) * 16;
}

// The state into shared memory from the accumulator layout of `hs`: in
// f32 ([16][N], kept across chunks) and as hi and lo halves ([16][N] bf16
// each, the B operand of C H^T).
template <int P, int PW, int N>
__device__ __forceinline__ void put_state(unsigned char* hhi,
                                          unsigned char* hlo, float* hf,
                                          const float (&hs)[PW][2][4],
                                          int warp, int g, int t) {
#pragma unroll
  for (int p = 0; p < PW; ++p)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = g + 8 * half, n = (warp * PW + p) * 16 + u * 8 + 2 * t;
        unsigned hi, lo;
        split_bf16(hs[p][u][2 * half], hs[p][u][2 * half + 1], hi, lo);
        const int off = swz<P>(r, n / 8) + (n % 8) * 2;
        *reinterpret_cast<unsigned*>(hhi + off) = hi;
        *reinterpret_cast<unsigned*>(hlo + off) = lo;
        *reinterpret_cast<float2*>(hf + r * N + n) =
            make_float2(hs[p][u][2 * half], hs[p][u][2 * half + 1]);
      }
}

template <int HD, int N>
__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_tc_kernel(const __nv_bfloat16* __restrict__ x,
                   const float* __restrict__ dt, const float* __restrict__ A,
                   const __nv_bfloat16* __restrict__ Bm,
                   const __nv_bfloat16* __restrict__ Cm,
                   const float* __restrict__ h0, __nv_bfloat16* __restrict__ y,
                   float* __restrict__ hout, int S, int nh, int chunk) {
  static_assert(HD % kDS == 0 && N % 16 == 0, "shape");
  constexpr int P = N / 8;          // 16-byte chunks in a row of B, C or H
  constexpr int KN = N / 16;        // k16 steps over N
  constexpr int SW = KN < kWarps ? KN : kWarps;   // warps holding state
  constexpr int PW = KN / SW;       // 16-column groups of state a warp holds
  using L = Layout<N>;
  extern __shared__ __align__(128) unsigned char smem[];
  const unsigned sB = smem_u32(smem + L::kB), sX = smem_u32(smem + L::kX);
  const unsigned sHhi = smem_u32(smem + L::kHhi);
  const unsigned sHlo = smem_u32(smem + L::kHlo);
  float* s_cum = reinterpret_cast<float*>(smem + L::kS);
  float* s_dt = reinterpret_cast<float*>(smem + L::kDt);

  const int d0 = blockIdx.x * kDS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // ldmatrix row / chunk of this lane: fragments of a [16 n][16 k] tile
  // (no transpose), and of a [16 k][16 n] tile (transposed)
  const int lr = (lane & 7) + ((lane >> 4) << 3), lc = (lane >> 3) & 1;
  const int tr = (lane & 7) + (((lane >> 3) & 1) << 3), tcol = lane >> 4;
  const float a = A[h];
  const long long xs = (long long)nh * HD;          // x / y row stride

  // the state, [16, N] f32 in shared memory across the chunks; warp w < SW
  // updates columns [16 PW w, 16 PW (w + 1)) as mma accumulators (rows g
  // and g + 8)
  float* s_h = reinterpret_cast<float*>(smem + L::kHf);
  float hs[PW][2][4];
  const long long hoff = (((long long)b * nh + h) * HD + d0) * N;
  // query tiles of 16 rows go to the warps the longest first, in a zigzag:
  // round k deals tiles nt-1-8k .. nt-8-8k, to warps 0..7 or 7..0
  auto tile_of = [&](int k, int nt) {
    const int idx = k * kWarps + ((k & 1) ? kWarps - 1 - warp : warp);
    return idx < nt ? nt - 1 - idx : -1;
  };

  for (int c0 = 0; c0 < S; c0 += chunk) {
    const int q = min(chunk, S - c0);
    const int nt = (q + kT - 1) / kT;     // tiles of the chunk, from its start
    const long long row0 = (long long)b * S + c0;
    const __nv_bfloat16* bc = Bm + row0 * N;
    const __nv_bfloat16* cc = Cm + row0 * N;
    const __nv_bfloat16* xc = x + row0 * xs + (long long)h * HD + d0;
    __nv_bfloat16* yc = y + row0 * xs + (long long)h * HD + d0;

    __syncthreads();                   // the previous chunk is done with smem
    // the chunk's loads are issued before any is waited for: dt (by the
    // last warp, which has the least y work: 8 rows a lane, as scan_chunk
    // reads them), B and x (cp.async), the state (first chunk), then each
    // warp's first C tile
    constexpr int kPer = kMaxChunk / 32;
    float dtv[kPer];
    if (warp == kWarps - 1) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int i = lane * kPer + k;
        dtv[k] = (i < q) ? dt[(row0 + i) * nh + h] : 0.f;
      }
    }
    for (int e = tid; e < nt * kT * P; e += kThreads) {
      const int r = e / P, c = e % P;
      cp_async16(smem + L::kB + swz<P>(r, c),
                 r < q ? bc + (long long)r * N + c * 8 : bc, r < q);
    }
    for (int e = tid; e < nt * kT * 2; e += kThreads) {
      const int r = e >> 1, c = e & 1;
      cp_async16(smem + L::kX + swz<2>(r, c), r < q ? xc + r * xs + c * 8 : xc,
                 r < q);
    }
    if (c0 == 0 && warp < SW) {
#pragma unroll
      for (int p = 0; p < PW; ++p)
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float2 v = *reinterpret_cast<const float2*>(
                h0 + hoff + (long long)(g + 8 * half) * N +
                (warp * PW + p) * 16 + u * 8 + 2 * t);
            hs[p][u][2 * half] = v.x;
            hs[p][u][2 * half + 1] = v.y;
          }
    }
    // the C rows of a query tile as A fragments (rows past the chunk's end: 0)
    unsigned ca[KN][4];
    auto load_c = [&](int it) {
      const int r0 = it * kT + g, r1 = r0 + 8;
      const unsigned* c0p =
          reinterpret_cast<const unsigned*>(cc + (long long)r0 * N + 2 * t);
      const unsigned* c1p =
          reinterpret_cast<const unsigned*>(cc + (long long)r1 * N + 2 * t);
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) {
        ca[kk][0] = r0 < q ? __ldg(c0p + kk * 8) : 0u;
        ca[kk][1] = r1 < q ? __ldg(c1p + kk * 8) : 0u;
        ca[kk][2] = r0 < q ? __ldg(c0p + kk * 8 + 4) : 0u;
        ca[kk][3] = r1 < q ? __ldg(c1p + kk * 8 + 4) : 0u;
      }
    };
    // the carried-in state's term C_i . H_in[d, :], H_in as hi + lo
    float ys[2][4];
    auto state_term = [&]() {
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) ys[u][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) {
        unsigned hb[4];
        ldsm_x4(hb, sHhi + swz<P>(lr, 2 * kk + lc));
        mma_bf16(ys[0], ca[kk], hb[0], hb[1]);
        mma_bf16(ys[1], ca[kk], hb[2], hb[3]);
        ldsm_x4(hb, sHlo + swz<P>(lr, 2 * kk + lc));
        mma_bf16(ys[0], ca[kk], hb[0], hb[1]);
        mma_bf16(ys[1], ca[kk], hb[2], hb[3]);
      }
    };
    // s = cumsum(dt * A) over the chunk (see scan_chunk)
    if (warp == kWarps - 1) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        s_dt[lane * kPer + k] = dtv[k];
        s_cum[lane * kPer + k] = dtv[k] * a;
      }
      __syncwarp();
      scan_chunk(s_cum, lane);
    }
    // this warp's first C tile: after the last warp's scan, so that dt's
    // and C's registers are never live together
    int it = tile_of(0, nt);
    if (it >= 0) load_c(it);
    if (c0 == 0 && warp < SW)
      put_state<P, PW, N>(smem + L::kHhi, smem + L::kHlo, s_h, hs, warp, g,
                          t);
    __syncthreads();                   // s, dt and the state's halves
    if (it >= 0) state_term();
    cp_async_commit_wait();
    __syncthreads();
    const float s_last = s_cum[q - 1];

    // y, one query tile at a time
    for (int k = 0; it >= 0; it = tile_of(++k, nt)) {
      if (k > 0) {
        load_c(it);
        state_term();
      }
      const int r0 = it * kT + g, r1 = r0 + 8;
      const float si0 = s_cum[r0], si1 = s_cum[r1];
      float yi[2][4] = {};
      // M = select(i >= j, G exp(s_i - s_j) dt_j, 0) of key tile j0 from its
      // G = C B^T accumulator, as A fragments hi + lo, then yi += M x
      auto intra = [&](const float (&gs)[2][4], int j0) {
        unsigned mhi[4], mlo[4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = j0 + u * 8 + 2 * t;
          const float sj0 = s_cum[j], sj1 = s_cum[j + 1];
          const float dj0 = s_dt[j], dj1 = s_dt[j + 1];
          // the exponent is selected too (0 where j > i): every exp is
          // taken, none overflows, and no lane branches around one
          const bool c00 = r0 >= j, c01 = r0 > j, c10 = r1 >= j, c11 = r1 > j;
          const float e00 = expf(c00 ? si0 - sj0 : 0.f);
          const float e01 = expf(c01 ? si0 - sj1 : 0.f);
          const float e10 = expf(c10 ? si1 - sj0 : 0.f);
          const float e11 = expf(c11 ? si1 - sj1 : 0.f);
          const float m00 = c00 ? gs[u][0] * e00 * dj0 : 0.f;
          const float m01 = c01 ? gs[u][1] * e01 * dj1 : 0.f;
          const float m10 = c10 ? gs[u][2] * e10 * dj0 : 0.f;
          const float m11 = c11 ? gs[u][3] * e11 * dj1 : 0.f;
          split_bf16(m00, m01, mhi[2 * u], mlo[2 * u]);
          split_bf16(m10, m11, mhi[2 * u + 1], mlo[2 * u + 1]);
        }
        unsigned xb[4];
        ldsm_x4_t(xb, sX + swz<2>(j0 + tr, tcol));
        mma_bf16(yi[0], mhi, xb[0], xb[1]);
        mma_bf16(yi[1], mhi, xb[2], xb[3]);
        mma_bf16(yi[0], mlo, xb[0], xb[1]);
        mma_bf16(yi[1], mlo, xb[2], xb[3]);
      };
      // key tiles jt <= it
      for (int jt = 0; jt <= it; ++jt) {
        float gs[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < KN; ++kk) {
          unsigned bb[4];
          ldsm_x4(bb, sB + swz<P>(jt * kT + lr, 2 * kk + lc));
          mma_bf16(gs[0], ca[kk], bb[0], bb[1]);
          mma_bf16(gs[1], ca[kk], bb[2], bb[3]);
        }
        intra(gs, jt * kT);
      }
      const float e0 = expf(si0), e1 = expf(si1);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int col = u * 8 + 2 * t;
        if (r0 < q)
          *reinterpret_cast<__nv_bfloat162*>(yc + (long long)r0 * xs + col) =
              __floats2bfloat162_rn(yi[u][0] + e0 * ys[u][0],
                                    yi[u][1] + e0 * ys[u][1]);
        if (r1 < q)
          *reinterpret_cast<__nv_bfloat162*>(yc + (long long)r1 * xs + col) =
              __floats2bfloat162_rn(yi[u][2] + e1 * ys[u][2],
                                    yi[u][3] + e1 * ys[u][3]);
      }
    }

    // dH = sum_j (w_j x_j) (x) B_j, w_j x_j as hi + lo (one accumulator
    // each): A = (w x)^T from the x slice and B = the chunk's B rows, both
    // read transposed
    float dh[PW][2][4] = {}, dl[PW][2][4] = {};
    if (warp < SW) {
      for (int jt = 0; jt < nt; ++jt) {
        const int j0 = jt * kT;
        unsigned xa[4];
        ldsm_x4_t(xa, sX + swz<2>(j0 + lr, lc));
        // xa[0], xa[1]: keys j0 + 2t, +1; xa[2], xa[3]: keys j0 + 8 + 2t, +1
        float w[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int j = j0 + (v >> 1) * 8 + 2 * t + (v & 1);
          w[v] = expf(s_last - s_cum[j]) * s_dt[j];
        }
        unsigned ahi[4], alo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const __nv_bfloat162 xv =
              *reinterpret_cast<const __nv_bfloat162*>(&xa[r]);
          split_bf16(__low2float(xv) * w[(r >> 1) * 2],
                     __high2float(xv) * w[(r >> 1) * 2 + 1], ahi[r], alo[r]);
        }
#pragma unroll
        for (int p = 0; p < PW; ++p) {
          unsigned bb[4];
          ldsm_x4_t(bb, sB + swz<P>(j0 + tr, (warp * PW + p) * 2 + tcol));
          mma_bf16(dh[p][0], ahi, bb[0], bb[1]);
          mma_bf16(dh[p][1], ahi, bb[2], bb[3]);
          mma_bf16(dl[p][0], alo, bb[0], bb[1]);
          mma_bf16(dl[p][1], alo, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();                   // every warp is done reading H_in
    if (warp < SW) {
      const float carry = expf(s_last);
      const bool last = c0 + chunk >= S;
#pragma unroll
      for (int p = 0; p < PW; ++p)
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = g + 8 * half;
            const int n = (warp * PW + p) * 16 + u * 8 + 2 * t;
            const float2 v = *reinterpret_cast<const float2*>(s_h + r * N + n);
            const float* dhp = dh[p][u] + 2 * half;
            const float* dlp = dl[p][u] + 2 * half;
            const float2 hn = make_float2(v.x * carry + (dhp[0] + dlp[0]),
                                          v.y * carry + (dhp[1] + dlp[1]));
            hs[p][u][2 * half] = hn.x;
            hs[p][u][2 * half + 1] = hn.y;
            if (last)
              *reinterpret_cast<float2*>(hout + hoff + (long long)r * N + n) =
                  hn;
          }
      if (!last)
        put_state<P, PW, N>(smem + L::kHhi, smem + L::kHlo, s_h, hs, warp, g,
                            t);
    }
  }
}

}  // namespace tc

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

template <int HD, int N>
int launch_tc(const void* x, const void* dt, const void* A, const void* Bm,
              const void* Cm, const void* h0, void* y, void* hout, int B, int S,
              int nh, int chunk, cudaStream_t stream) {
  constexpr int bytes = tc::Layout<N>::kBytes;
  auto kern = tc::ssd_scan_tc_kernel<HD, N>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return (int)attr;
  kern<<<dim3(HD / tc::kDS, nh, B), tc::kThreads, bytes, stream>>>(
      (const __nv_bfloat16*)x, (const float*)dt, (const float*)A,
      (const __nv_bfloat16*)Bm, (const __nv_bfloat16*)Cm, (const float*)h0,
      (__nv_bfloat16*)y, (float*)hout, S, nh, chunk);
  return (int)cudaGetLastError();
}

template <int HD, int N>
int occupancy_tc(int* smem_bytes, int* blocks_per_sm) {
  constexpr int bytes = tc::Layout<N>::kBytes;
  auto kern = tc::ssd_scan_tc_kernel<HD, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  *smem_bytes = bytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kern, tc::kThreads, bytes);
}

}  // namespace

// Every tensor contiguous in the layout above; dtype 0 = f32 (the CUDA-core
// body), 1 = bf16 (x, B, C, y; the tensor-core body, which reads x, B and
// C with 16-byte copies: 16-byte aligned).  Returns a CUDA error code (0 on
// a successful launch).
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
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (hd == 64 && N == 128)
    return launch_tc<64, 128>(x, dt, A, Bm, Cm, h0, y, hout, B, S, nh, chunk, st);
  if (hd == 32 && N == 16)
    return launch_tc<32, 16>(x, dt, A, Bm, Cm, h0, y, hout, B, S, nh, chunk, st);
  return (int)cudaErrorInvalidValue;
}

// The bf16 body's dynamic shared memory a block and resident blocks an SM
// on the current device, for (hd, N).  Returns a CUDA error code.
extern "C" int ssd_scan_tc_occupancy(int hd, int N, int* smem_bytes,
                                     int* blocks_per_sm) {
  if (hd == 64 && N == 128) return occupancy_tc<64, 128>(smem_bytes, blocks_per_sm);
  if (hd == 32 && N == 16) return occupancy_tc<32, 16>(smem_bytes, blocks_per_sm);
  return (int)cudaErrorInvalidValue;
}
