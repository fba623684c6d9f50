// Flash attention over whole sequences (no cache) for Hopper (sm_90a):
// the attention forward of training and of the cold whole-prompt forward.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// `flash_attention_bhsd` (`_flash_kernel`), reached through
// src/repro/kernels/ops.py `flash_attention`.  Same function: query row i
// of head h (q [B, Sq, H, hd]) attends keys j of KV head h / G (k/v
// [B, Sk, Hk, hd], G = H / Hk) with
//     j < sk_valid,  and if causal:  j <= i,  j > i - window (window > 0)
// with an online softmax in f32 (scale 1/sqrt(hd) applied to q in f32,
// NEG_INF = -1e30 masking, max(l, 1e-30) denominator floor); the output has
// the input's type.  The kernel also writes each row's softmax statistics
// m (the max of the scaled scores) and l (the sum of exp(s - m)) in f32,
// [B, H, Sq], which the backward (a PyTorch port of the JAX package's
// `_flash_bwd`) reads instead of recomputing the forward.  A row with no
// unmasked key gets an undefined value, as in the TPU kernel.
//
// What bounds it on the H100: operations.  A causal call does
// 2 * B * H * Sq * Sk * hd flops on (2 * Sq * H + 2 * Sk * Hk) * hd
// elements read or written once: at training lengths (Sq = Sk = 2048,
// SmolLM-360M's heads 15/5/64 in bf16) about 1500 flops per byte, far
// above the card's ~295 flop/byte ridge.  Inside a block a query tile of
// 64 rows does 4 * 64 * hd flops per key for its 2 * hd K/V elements (64
// flops per byte in bf16), and the query tiles of a head share the K/V
// tiles through L2.  This first version runs its products on the CUDA
// cores in f32 (67 TFLOP/s peak, against 989 for bf16 on the tensor
// cores); `wgmma` tiles fed by TMA are the follow-up.
// What the design does:
//   * one block per (query tile of 64 rows, query head, batch row); the
//     TPU grid's sequential key dimension becomes a loop over key tiles
//     inside the block, with m, l and the 64 x hd accumulator in
//     registers and shared memory, so nothing leaves the block between
//     tiles;
//   * the loop visits live tiles only: up to the tile's last query row
//     (causal) and sk_valid, from the window's first key (causal with a
//     window), so a causal call does half the work of a full one and a
//     windowed call O(window) per row;
//   * scores are a 4 x 4 register tile per thread over q and K rows
//     staged in padded shared memory (conflict-free column reads); P @ V
//     keeps 16 rows x hd/32 columns per thread;
//   * K/V tiles move as 16-byte vectors, every load of a tile in flight
//     before the first is stored to shared memory, V rows stored as
//     float4s.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kBM = 64;      // query rows per block
constexpr int kBK = 32;      // keys per tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One 16-byte vector of T: 8 bf16 or 4 f32 elements, unpacked to floats.
template <typename T> struct Vec16;
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& r, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
};
template <> struct Vec16<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x); f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z); f[3] = __uint_as_float(r.w);
  }
};

template <int HD>
constexpr int smem_floats() {
  return kBM * (HD + 1) + kBK * (HD + 1) + kBK * HD + kBM * (kBK + 1) + 3 * kBM;
}

// grid (query tiles, H, B); block kThreads; dynamic shared memory
// smem_floats<HD>() * 4 bytes.  q/out: [B, Sq, H, hd] with strides
// (sb, ss, sh); k/v: [B, Sk, Hk, hd] with strides (sb, ss, sh), 16-byte
// aligned rows; every tensor has a unit stride on hd.  m/l: [B, H, Sq]
// f32, contiguous.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ m_out, float* __restrict__ l_out, int Sq,
                       int H, int G, int sk_valid, int causal, int window,
                       long long q_sb, long long q_ss, long long q_sh,
                       long long k_sb, long long k_ss, long long k_sh,
                       long long v_sb, long long v_ss, long long v_sh,
                       long long o_sb, long long o_ss, long long o_sh, float scale) {
  static_assert(kThreads == 128 && kBM == 64 && kBK == 32, "thread layout");
  constexpr int kDP = HD / 32;                   // output columns per lane
  static_assert(kDP == 2 || kDP == 4, "hd must be 64 or 128");
  extern __shared__ float4 smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  float* q_s = smem;                             // [kBM][HD + 1]
  float* k_s = q_s + kBM * (HD + 1);             // [kBK][HD + 1]
  float* v_s = k_s + kBK * (HD + 1);             // [kBK][HD] (16-byte rows)
  float* s_s = v_s + kBK * HD;                   // [kBM][kBK + 1]
  float* m_s = s_s + kBM * (kBK + 1);
  float* l_s = m_s + kBM;
  float* c_s = l_s + kBM;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z, t = threadIdx.x;
  const int hk = h / G;
  const int i_lo = qt * kBM;
  const int i_hi = min(i_lo + kBM, Sq);          // exclusive

  // live key tiles, as the TPU kernel's `live` guard: below sk_valid and,
  // causal, at or below the tile's last query row and above its first
  // row's window
  const int limit = causal ? min(sk_valid, i_hi) : sk_valid;
  const int last = (limit + kBK - 1) / kBK - 1;
  int first = 0;
  if (causal && window > 0) first = min(max(i_lo - window + 1, 0) / kBK, max(last, 0));

  for (int idx = t; idx < kBM * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD, i = i_lo + r;
    q_s[r * (HD + 1) + d] =
        i < Sq ? to_f(q[b * q_sb + i * q_ss + (long long)h * q_sh + d]) * scale : 0.f;
  }
  if (t < kBM) { m_s[t] = kNegInf; l_s[t] = 0.f; c_s[t] = 0.f; }

  const int warp = t / 32, lane = t % 32;
  float acc[16][kDP];
#pragma unroll
  for (int a = 0; a < 16; ++a)
#pragma unroll
    for (int c = 0; c < kDP; ++c) acc[a][c] = 0.f;
  const T* kb = k + b * k_sb + (long long)hk * k_sh;
  const T* vb = v + b * v_sb + (long long)hk * v_sh;
  // vector u of thread t holds tile elements (t + u * kThreads) * kV ...
  // (kV values of one key row: 4 f32 or 8 bf16, so kVecs is 8 or 4 at
  // hd 128 and half that at hd 64)
  constexpr int kV = Vec16<T>::N, kVecs = kBK * HD / kV / kThreads;
  static_assert(kVecs >= 1 && HD % kV == 0, "a vector stays in one key row");

  for (int kt = first; kt <= last; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                             // previous tile fully used
    uint4 kr[kVecs], vr[kVecs];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int e = (t + u * kThreads) * kV, pos = k0 + e / HD, d = e % HD;
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      kr[u] = pos < sk_valid ? *reinterpret_cast<const uint4*>(kb + pos * k_ss + d) : zero;
      vr[u] = pos < sk_valid ? *reinterpret_cast<const uint4*>(vb + pos * v_ss + d) : zero;
    }
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int e = (t + u * kThreads) * kV, j = e / HD, d = e % HD;
      float f[kV];
      Vec16<T>::unpack(kr[u], f);
#pragma unroll
      for (int c = 0; c < kV; ++c) k_s[j * (HD + 1) + d + c] = f[c];
      Vec16<T>::unpack(vr[u], f);
#pragma unroll
      for (int c = 0; c < kV; c += 4)
        *reinterpret_cast<float4*>(v_s + j * HD + d + c) =
            make_float4(f[c], f[c + 1], f[c + 2], f[c + 3]);
    }
    __syncthreads();

    // scores: thread -> rows rg + 16a, keys kg + 8c (4 x 4 register tile)
    {
      const int rg = t / 8, kg = t % 8;
      float s[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) qv[a] = q_s[(rg + 16 * a) * (HD + 1) + d];
#pragma unroll
        for (int c = 0; c < 4; ++c) kv[c] = k_s[(kg + 8 * c) * (HD + 1) + d];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[a][c] += qv[a] * kv[c];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = rg + 16 * a, i = i_lo + r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = kg + 8 * c, k_pos = k0 + j;
          bool ok = i < Sq && k_pos < sk_valid;
          if (causal) {
            ok = ok && k_pos <= i;
            if (window > 0) ok = ok && k_pos > i - window;
          }
          s_s[r * (kBK + 1) + j] = ok ? s[a][c] : kNegInf;
        }
      }
    }
    __syncthreads();

    // online softmax: two threads per row, 16 keys each
    {
      const int r = t / 2, half = t % 2;
      float* srow = s_s + r * (kBK + 1) + half * 16;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 16; ++j) mx = fmaxf(mx, srow[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float p = expf(srow[j] - m_new);
        srow[j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if (half == 0) {
        const float c = expf(m_old - m_new);
        c_s[r] = c;
        l_s[r] = l_s[r] * c + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc[r, d] = acc * corr + P @ V: warp -> 16 rows, lane -> kDP columns
#pragma unroll
    for (int a = 0; a < 16; ++a) {
      const float c = c_s[warp * 16 + a];
#pragma unroll
      for (int e = 0; e < kDP; ++e) acc[a][e] *= c;
    }
    for (int j = 0; j < kBK; ++j) {
      float vv[kDP];
      const float* vrow = v_s + j * HD + lane * kDP;
      if constexpr (kDP == 4) {
        const float4 x = *reinterpret_cast<const float4*>(vrow);
        vv[0] = x.x; vv[1] = x.y; vv[2] = x.z; vv[3] = x.w;
      } else {
        const float2 x = *reinterpret_cast<const float2*>(vrow);
        vv[0] = x.x; vv[1] = x.y;
      }
#pragma unroll
      for (int a = 0; a < 16; ++a) {
        const float p = s_s[(warp * 16 + a) * (kBK + 1) + j];
#pragma unroll
        for (int e = 0; e < kDP; ++e) acc[a][e] += p * vv[e];
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int a = 0; a < 16; ++a) {
    const int r = warp * 16 + a, i = i_lo + r;
    if (i < Sq) {
      const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
      T* orow = out + b * o_sb + i * o_ss + (long long)h * o_sh + lane * kDP;
#pragma unroll
      for (int e = 0; e < kDP; ++e) orow[e] = from_f<T>(acc[a][e] * inv);
    }
  }
  if (t < kBM && i_lo + t < Sq) {
    const long long row = ((long long)b * H + h) * Sq + i_lo + t;
    m_out[row] = m_s[t];
    l_out[row] = l_s[t];
  }
}

template <typename T, int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* out, float* m,
                      float* l, int B, int Sq, int H, int G, int sk_valid, int causal,
                      int window, const long long* st, float scale,
                      cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * (int)sizeof(float);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((Sq + kBM - 1) / kBM, H, B);
  flash_attention_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, m, l, Sq, H, G, sk_valid, causal,
      window, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/out [B, Sq, H, hd], k/v
// [B, Sk, Hk, hd] (keys at or past sk_valid are masked and never read),
// G = H / Hk; m/l [B, H, Sq] f32.  strides: q (sb, ss, sh), k (sb, ss,
// sh), v (sb, ss, sh), out (sb, ss, sh), in elements.  causal: 0 or 1;
// window > 0 limits a causal row to its last `window` keys.  Returns the
// launch's cudaError_t.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out,
                               void* m, void* l, int dtype, int B, int Sq, int H, int G,
                               int sk_valid, int hd, int causal, int window,
                               long long q_sb, long long q_ss, long long q_sh,
                               long long k_sb, long long k_ss, long long k_sh,
                               long long v_sb, long long v_ss, long long v_sh,
                               long long o_sb, long long o_ss, long long o_sh,
                               float scale, void* stream) {
  if (G < 1 || H % G) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return 0;
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  cudaStream_t s = (cudaStream_t)stream;
  float* mf = (float*)m;
  float* lf = (float*)l;
#define REPRO_FLASH_LAUNCH(T, HD)                                                 \
  return (int)launch_hd<T, HD>(q, k, v, out, mf, lf, B, Sq, H, G, sk_valid, causal, \
                               window, st, scale, s)
  if (dtype == 0 && hd == 128) REPRO_FLASH_LAUNCH(float, 128);
  if (dtype == 0 && hd == 64) REPRO_FLASH_LAUNCH(float, 64);
  if (dtype == 1 && hd == 128) REPRO_FLASH_LAUNCH(__nv_bfloat16, 128);
  if (dtype == 1 && hd == 64) REPRO_FLASH_LAUNCH(__nv_bfloat16, 64);
#undef REPRO_FLASH_LAUNCH
  return (int)cudaErrorInvalidValue;
}
