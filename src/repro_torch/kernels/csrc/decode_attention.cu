// Flash-decode attention for Hopper (sm_90a): one query token per
// sequence against the slab KV cache, or through a block table against
// the paged KV arena.
//
// Replaces the TPU kernels src/repro/kernels/decode_attention.py
// `flash_decode_bhgd` (`_decode_kernel`, entry `flash_decode`) and
// `flash_decode_paged_bhgd` (`_decode_kernel_paged`, entry
// `flash_decode_paged`).  Same function: for batch row b
// and KV head h, the G = H / Hk query heads of that KV head attend keys
// [0, lengths[b]) with an online softmax in f32 (NEG_INF = -1e30 masking,
// max(l, 1e-30) denominator floor); the output has the input's type.
//
// What bounds it on the H100: bytes.  One decode step reads each valid
// K/V row once (2 * lengths[b] * hd * sizeof(T) per (b, h)) and does
// about 4 * G * hd flops per row, far below the ~295 flop/byte ridge of
// the card.  The design therefore reads nothing it does not need:
//   * the tile loop stops at ceil(lengths[b] / BK) and never touches
//     rows past the valid length (the TPU kernel's revisit-block index
//     map becomes a length-bounded loop);
//   * K and V are read in place from the model's [B, S_max, Hk, hd]
//     layout through strides (no transpose or copy of the cache);
//   * the G query rows of one KV head share every K/V tile staged in
//     shared memory, so each row is read from HBM once per step;
//   * tiles move as 16-byte vectors, and the next tile is in flight in
//     registers while the current one is computed.
// Paged layout: the kernel body is the slab one; only the row
// addressing differs (the `Rows` functor).  Logical row pos of batch row
// b lives at physical page bt[b, pos / page], row pos % page, of the
// [P_phys, page, Hk, hd] arena, so each 16-byte vector finds its own page
// (one lookup serves K and V) and a 32-key tile may straddle pages of
// any power-of-two size.  The lookups are part of the next tile's
// register prefetch, so they overlap the current tile's compute.  Keys
// are bounded by min(lengths[b], P_max * page).
// Known limit: one block per (b, h) gives only B * Hk blocks (12 for
// Qwen2.5-3B at 6 slots), so most of the 132 SMs idle and one SM's
// bandwidth, not the card's, bounds a long row.  A split-K over live
// tiles is the follow-up.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kBK = 32;      // keys per tile (== warp size, see softmax step)
constexpr int kMaxG = 8;     // query heads per KV head (padded to 8)

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

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Where logical cache position `pos` of batch row b lives: element
// offset page(b, pos) * sp + within(pos) * ss (+ head and column).
// Slab [B, S, Hk, hd]: the page is the slab row and sp its stride.
// Paged [P_phys, page, Hk, hd]: the page comes from the block table
// bt [B, pmax], page size 1 << shift.
struct SlabRows {
  __device__ __forceinline__ int page(int b, int) const { return b; }
  __device__ __forceinline__ int within(int pos) const { return pos; }
};
struct PagedRows {
  const int* bt;
  int pmax, shift;
  __device__ __forceinline__ int page(int b, int pos) const {
    return bt[(long long)b * pmax + (pos >> shift)];
  }
  __device__ __forceinline__ int within(int pos) const {
    return pos & ((1 << shift) - 1);
  }
};

// grid (Hk, B); block kThreads.  q/out: [B, 1, H, hd] rows addressed by
// (b * q_sb + head * q_sh); K at addr.page(b, pos) * k_sp +
// addr.within(pos) * k_ss + h * k_sh (likewise V), a unit stride on hd,
// 16-byte aligned rows; keys [0, min(lengths[b], cap)).
template <typename T, int HD, typename Rows>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    T* __restrict__ out, int G, int cap,
                    long long q_sb, long long q_sh, Rows addr,
                    long long k_sp, long long k_ss, long long k_sh,
                    long long v_sp, long long v_ss, long long v_sh,
                    long long o_sb, long long o_sh, float scale) {
  static_assert(kBK == 32 && kThreads == 128 && kMaxG == 8, "thread layout");
  static_assert(kThreads % HD == 0 || HD % kThreads == 0, "thread layout");
  constexpr int kGStep = kThreads / HD;          // query heads per pass
  constexpr int kGPer = kMaxG / kGStep;          // (g, d) outputs per thread
  constexpr int kV = Vec16<T>::N;                // elements per 16-byte load
  constexpr int kVecs = kBK * HD / kV / kThreads;  // loads per thread per tile
  __shared__ float q_s[kMaxG][HD];
  __shared__ float k_s[kBK][HD + 1];             // +1: conflict-free row reads
  __shared__ float v_s[kBK][HD];
  __shared__ float p_s[kMaxG][kBK];
  __shared__ float m_s[kMaxG], l_s[kMaxG], c_s[kMaxG];

  const int h = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const int L = min(lengths[b], cap);  // keys past the cache do not exist
  for (int i = t; i < kMaxG * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    q_s[g][d] = g < G
        ? to_f(q[b * q_sb + (long long)(h * G + g) * q_sh + d]) * scale : 0.f;
  }
  if (t < kMaxG) { m_s[t] = kNegInf; l_s[t] = 0.f; c_s[t] = 0.f; }
  const int d0 = t % HD, g0 = t / HD;
  float acc[kGPer];
#pragma unroll
  for (int i = 0; i < kGPer; ++i) acc[i] = 0.f;
  const T* kb = k + h * k_sh;
  const T* vb = v + h * v_sh;

  // The next tile is loaded into registers (raw 16-byte vectors) while
  // the current tile is computed, so the loop does not wait on memory.
  // Vector u of thread t holds tile elements (t + u * kThreads) * kV ...
  uint4 kr[kVecs], vr[kVecs];
  auto load_tile = [&](int start) {
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int e = (t + u * kThreads) * kV, pos = start + e / HD, d = e % HD;
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      if (pos < L) {
        const long long pg = addr.page(b, pos), w = addr.within(pos);
        kr[u] = *reinterpret_cast<const uint4*>(kb + pg * k_sp + w * k_ss + d);
        vr[u] = *reinterpret_cast<const uint4*>(vb + pg * v_sp + w * v_ss + d);
      } else {
        kr[u] = zero;
        vr[u] = zero;
      }
    }
  };
  load_tile(0);
  __syncthreads();                               // q_s, m_s, l_s ready

  for (int start = 0; start < L; start += kBK) {
    __syncthreads();                             // previous tile fully used
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int e = (t + u * kThreads) * kV, j = e / HD, d = e % HD;
      float f[kV];
      Vec16<T>::unpack(kr[u], f);
#pragma unroll
      for (int c = 0; c < kV; ++c) k_s[j][d + c] = f[c];
      Vec16<T>::unpack(vr[u], f);
#pragma unroll
      for (int c = 0; c < kV; ++c) v_s[j][d + c] = f[c];
    }
    __syncthreads();
    if (start + kBK < L) load_tile(start + kBK);

    // scores: lane -> key, warp -> heads warp and warp + 4 (one K read
    // per two products; the q reads are warp-wide broadcasts)
    {
      const int j = lane, ga = warp, gb = warp + 4;
      float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; d += 2) {
        const float k0 = k_s[j][d], k1 = k_s[j][d + 1];
        a0 += q_s[ga][d] * k0;
        a1 += q_s[ga][d + 1] * k1;
        b0 += q_s[gb][d] * k0;
        b1 += q_s[gb][d + 1] * k1;
      }
      const bool key_ok = start + j < L;
      // rows of padded heads (g >= G) hold p = 0 and are never normalised
      p_s[ga][j] = ga < G ? (key_ok ? a0 + a1 : kNegInf) : 0.f;
      p_s[gb][j] = gb < G ? (key_ok ? b0 + b1 : kNegInf) : 0.f;
    }
    __syncthreads();
    // every tile holds >= 1 valid key, so m_new is finite and masked
    // scores underflow to p = 0
    for (int g = warp; g < G; g += kThreads / 32) {
      const float s = p_s[g][lane];
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = expf(s - m_new);
      const float sum = warp_sum(p);
      p_s[g][lane] = p;
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        c_s[g] = c;
        l_s[g] = l_s[g] * c + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // acc[g, d0] = acc * corr + sum_j p[g, j] v[j, d0]: each V element is
    // read once for all of the thread's heads
#pragma unroll
    for (int i = 0; i < kGPer; ++i) acc[i] *= c_s[g0 + i * kGStep];
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float vv = v_s[j][d0];
#pragma unroll
      for (int i = 0; i < kGPer; ++i) acc[i] += p_s[g0 + i * kGStep][j] * vv;
    }
  }
#pragma unroll
  for (int i = 0; i < kGPer; ++i) {
    const int g = g0 + i * kGStep;
    if (g < G)
      out[b * o_sb + (long long)(h * G + g) * o_sh + d0] =
          from_f<T>(acc[i] / fmaxf(l_s[g], 1e-30f));
  }
}

// st: q (sb, sh), k (sp, ss, sh), v (sp, ss, sh), out (sb, sh), in
// elements (sp: the slab row stride, or the page stride).
template <typename T, typename Rows>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lengths,
                   void* out, int B, int Hk, int G, int cap, int hd,
                   const long long* st, Rows addr, float scale, cudaStream_t stream) {
  dim3 grid(Hk, B);
  if (hd == 128)
    flash_decode_kernel<T, 128, Rows><<<grid, kThreads, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, lengths, (T*)out, G, cap, st[0], st[1],
        addr, st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], scale);
  else if (hd == 64)
    flash_decode_kernel<T, 64, Rows><<<grid, kThreads, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, lengths, (T*)out, G, cap, st[0], st[1],
        addr, st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], scale);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

template <typename Rows>
int dispatch(const void* q, const void* k, const void* v, const void* lengths,
             void* out, int dtype, int B, int Hk, int G, int cap, int hd,
             const long long* st, Rows addr, float scale, void* stream) {
  if (G < 1 || G > kMaxG) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int* lens = (const int*)lengths;
  if (dtype == 0)
    return (int)launch<float>(q, k, v, lens, out, B, Hk, G, cap, hd, st, addr, scale,
                              s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, lens, out, B, Hk, G, cap, hd, st, addr,
                                      scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
// Slab cache: k/v [B, S, Hk, hd] with strides (sb, ss, sh).
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const void* lengths, void* out, int dtype, int B,
                            int Hk, int G, int S, int hd, long long q_sb, long long q_sh,
                            long long k_sb, long long k_ss, long long k_sh,
                            long long v_sb, long long v_ss, long long v_sh,
                            long long o_sb, long long o_sh, float scale,
                            void* stream) {
  const long long st[10] = {q_sb, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, o_sb, o_sh};
  return dispatch(q, k, v, lengths, out, dtype, B, Hk, G, S, hd, st, SlabRows{},
                  scale, stream);
}

// Paged arena: k/v [P_phys, page, Hk, hd] with strides (sp, ss, sh);
// block_tables [B, pmax] int32 physical page ids; page = 1 << page_shift.
extern "C" int flash_decode_paged(const void* q, const void* k, const void* v,
                                  const void* lengths, const void* block_tables,
                                  void* out, int dtype, int B, int Hk, int G,
                                  int pmax, int page_shift, int hd, long long q_sb,
                                  long long q_sh, long long k_sp, long long k_ss,
                                  long long k_sh, long long v_sp, long long v_ss,
                                  long long v_sh, long long o_sb, long long o_sh,
                                  float scale, void* stream) {
  if (page_shift < 0 || page_shift > 16 || pmax < 1) return (int)cudaErrorInvalidValue;
  const long long st[10] = {q_sb, q_sh, k_sp, k_ss, k_sh,
                            v_sp, v_ss, v_sh, o_sb, o_sh};
  return dispatch(q, k, v, lengths, out, dtype, B, Hk, G, pmax << page_shift, hd, st,
                  PagedRows{(const int*)block_tables, pmax, page_shift}, scale,
                  stream);
}
