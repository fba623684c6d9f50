// Cache-aware chunk-prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/prefill_attention.py
// `flash_prefill_bhsd` (`_prefill_kernel` -> `_kernel_common`, tile bounds
// from `_tile_bounds`).  Same function: a query chunk q[m, i] at absolute
// position q_offset[m] + i attends the resident cache rows k_pos with
//     k_pos < lengths[m],  k_pos <= q_pos,  k_pos > q_pos - window (window > 0)
// with an online softmax in f32 (NEG_INF = -1e30 masking, max(l, 1e-30)
// denominator floor); GQA query head h*G + g reads KV head h.  Every query
// row must have at least one unmasked key (the serving path counts the
// chunk itself in `lengths`); a row without one gets an undefined value,
// as in the TPU kernel.
//
// What bounds it on the H100: bytes for short chunks, flops for long
// ones.  A chunk of Sq rows against L valid keys does 4 * Sq * H * L * hd
// flops and must read 2 * L * Hk * hd cache elements, so the arithmetic
// intensity grows with Sq * G: a 16..128-token resume chunk is
// byte-bound, a 160..320-token cold chunk at GQA group 8 is flop-bound.
// This first version runs its products on the CUDA cores in f32; the
// tensor cores (wgmma) and TMA are the follow-up.  What the design does:
//   * one block per (query tile, KV head, row m) folds the G query heads
//     of the KV head and the tile's query positions into one 64-row M
//     dimension, so each K/V tile is staged in shared memory once per
//     group and a chunk far below any tile size (Sq of 2..8) still fills
//     whole rows;
//   * the KV loop runs over tiles [first, last] only, computed as
//     `_tile_bounds` does: past-causal, never-written and below-window
//     tiles are neither read nor computed, so bytes stay O(valid length)
//     instead of O(S_max);
//   * K and V are read in place from the model's [B, S_max, Hk, hd]
//     layout through strides, and an optional slot_idx[m] picks the cache
//     row, so a batched resume reads the shared cache without gathering
//     whole slot stripes;
//   * tiles move as 16-byte vectors, all of a tile's loads in flight
//     before the first is stored to shared memory.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kBM = 64;      // folded (query position, head) rows per block
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

// grid (query tiles, Hk, M); block kThreads; dynamic shared memory
// smem_floats<HD>() * 4 bytes.  q/out: [M, Sq, H, hd] with strides
// (sm, ss, sh); caches: [B, S, Hk, hd] with strides (sb, ss, sh); all
// with a unit stride on hd, cache rows 16-byte aligned.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ slot_idx,
                     const int* __restrict__ q_offset,
                     const int* __restrict__ lengths, T* __restrict__ out,
                     int Sq, int G, int S, int window,
                     long long q_sm, long long q_ss, long long q_sh,
                     long long k_sb, long long k_ss, long long k_sh,
                     long long v_sb, long long v_ss, long long v_sh,
                     long long o_sm, long long o_ss, long long o_sh, float scale) {
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

  const int qt = blockIdx.x, h = blockIdx.y, m = blockIdx.z, t = threadIdx.x;
  const int qpt = kBM / G;                       // query positions per tile
  const int rows = qpt * G;
  const int slot = slot_idx ? slot_idx[m] : m;
  const int qoff = q_offset[m];
  const int len = min(lengths[m], S);
  const int i_lo = qt * qpt;
  const int i_hi = min(i_lo + qpt, Sq);          // exclusive

  // KV tile range, as `_tile_bounds`: keys <= the tile's last query and
  // < the valid length; with a window, tiles wholly below it are skipped
  const int limit = min(len, qoff + i_hi);
  const int last = (limit + kBK - 1) / kBK - 1;
  int first = 0;
  if (window > 0) first = min(max(qoff + i_lo - window + 1, 0) / kBK, last);

  for (int idx = t; idx < kBM * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int i = i_lo + r / G, g = r % G;
    float x = 0.f;
    if (r < rows && i < Sq)
      x = to_f(q[m * q_sm + i * q_ss + (long long)(h * G + g) * q_sh + d]) * scale;
    q_s[r * (HD + 1) + d] = x;
  }
  if (t < kBM) { m_s[t] = kNegInf; l_s[t] = 0.f; c_s[t] = 0.f; }

  const int warp = t / 32, lane = t % 32;
  float acc[16][kDP];
#pragma unroll
  for (int a = 0; a < 16; ++a)
#pragma unroll
    for (int c = 0; c < kDP; ++c) acc[a][c] = 0.f;
  const T* kb = k + slot * k_sb + h * k_sh;
  const T* vb = v + slot * v_sb + h * v_sh;

  for (int kt = first; kt <= last; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                             // previous tile fully used
    // the tile's 16-byte loads are all in flight before any of them is
    // unpacked into shared memory: one memory round trip per tile
    constexpr int kV = Vec16<T>::N, kVecs = kBK * HD / kV / kThreads;
    uint4 kr[kVecs], vr[kVecs];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int e = (t + u * kThreads) * kV, pos = k0 + e / HD, d = e % HD;
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      kr[u] = pos < len ? *reinterpret_cast<const uint4*>(kb + pos * k_ss + d) : zero;
      vr[u] = pos < len ? *reinterpret_cast<const uint4*>(vb + pos * v_ss + d) : zero;
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
      for (int c = 0; c < kV; ++c) v_s[j * HD + d + c] = f[c];
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
        const int r = rg + 16 * a;
        const int q_pos = qoff + i_lo + r / G;
        const bool row_ok = r < rows && i_lo + r / G < Sq;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = kg + 8 * c, k_pos = k0 + j;
          bool ok = row_ok && k_pos < len && k_pos <= q_pos;
          if (window > 0) ok = ok && k_pos > q_pos - window;
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
    const int r = warp * 16 + a;
    const int i = i_lo + r / G, g = r % G;
    if (r < rows && i < Sq) {
      const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
      T* orow = out + m * o_sm + i * o_ss + (long long)(h * G + g) * o_sh + lane * kDP;
#pragma unroll
      for (int e = 0; e < kDP; ++e) orow[e] = from_f<T>(acc[a][e] * inv);
    }
  }
}

template <typename T, int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, const int* slot_idx,
                      const int* q_offset, const int* lengths, void* out, int M,
                      int Sq, int Hk, int G, int S, int window, const long long* st,
                      float scale, cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * (int)sizeof(float);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_prefill_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int qpt = kBM / G;
  dim3 grid((Sq + qpt - 1) / qpt, Hk, M);
  flash_prefill_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, slot_idx, q_offset, lengths, (T*)out,
      Sq, G, S, window, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const int* slot_idx,
                   const int* q_offset, const int* lengths, void* out, int M, int Sq,
                   int Hk, int G, int S, int hd, int window, const long long* st,
                   float scale, cudaStream_t stream) {
  if (hd == 128)
    return launch_hd<T, 128>(q, k, v, slot_idx, q_offset, lengths, out, M, Sq, Hk, G,
                             S, window, st, scale, stream);
  if (hd == 64)
    return launch_hd<T, 64>(q, k, v, slot_idx, q_offset, lengths, out, M, Sq, Hk, G,
                            S, window, st, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  slot_idx may be null (row m reads
// cache row m).  strides: q (sm, ss, sh), k (sb, ss, sh), v (sb, ss, sh),
// out (sm, ss, sh), in elements.  Returns the launch's cudaError_t.
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             const void* slot_idx, const void* q_offset,
                             const void* lengths, void* out, int dtype, int M,
                             int Sq, int Hk, int G, int S, int hd, int window,
                             long long q_sm, long long q_ss, long long q_sh,
                             long long k_sb, long long k_ss, long long k_sh,
                             long long v_sb, long long v_ss, long long v_sh,
                             long long o_sm, long long o_ss, long long o_sh,
                             float scale, void* stream) {
  if (G < 1 || G > kBM) return (int)cudaErrorInvalidValue;
  if (M == 0 || Sq == 0) return 0;
  const long long st[12] = {q_sm, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, o_sm, o_ss, o_sh};
  cudaStream_t s = (cudaStream_t)stream;
  const int* si = (const int*)slot_idx;
  const int* qo = (const int*)q_offset;
  const int* ln = (const int*)lengths;
  if (dtype == 0)
    return (int)launch<float>(q, k, v, si, qo, ln, out, M, Sq, Hk, G, S, hd, window,
                              st, scale, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, si, qo, ln, out, M, Sq, Hk, G, S, hd,
                                      window, st, scale, s);
  return (int)cudaErrorInvalidValue;
}
