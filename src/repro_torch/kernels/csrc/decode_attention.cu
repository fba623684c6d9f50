// Flash-decode attention for Hopper (sm_90a): one query token per
// sequence against the slab KV cache, or through a block table against
// the paged KV arena, each in the model's type or in int8 with
// per-(position, head) scales.
//
// Replaces the TPU kernels src/repro/kernels/decode_attention.py
// `flash_decode_bhgd` (`_decode_kernel`, entry `flash_decode`) and
// `flash_decode_paged_bhgd` (`_decode_kernel_paged`, entry
// `flash_decode_paged`).  The int8 entries `flash_decode_quant` and
// `flash_decode_paged_quant` replace no TPU kernel: they are the
// hand-written counterpart of the XLA int8 branches of
// src/repro/models/attention.py `decode_attention` and
// `decode_attention_paged` (`blocked_attention_quant` over the cache,
// keys and values f32(int8) * f32(scale)).  Same function: for batch row b
// and KV head h, the G = H / Hk query heads of that KV head attend keys
// [lo, lengths[b]) with an online softmax in f32 (NEG_INF = -1e30 masking,
// max(l, 1e-30) denominator floor); the output has the input's type.  lo
// is 0, or max(0, lengths[b] - window) for a sliding window (window > 0):
// the XLA window branch of src/repro/models/attention.py
// `decode_attention`, which slices [max(0, len - window), len) and
// attends it, has no TPU kernel and is this kernel's window argument.
//
// What bounds it on the H100: bytes.  One decode step reads each valid
// K/V row once (2 * lengths[b] * hd * sizeof(T) per (b, h)) and does
// about 4 * G * hd flops per row, far below the ~295 flop/byte ridge of
// the card.  The design therefore reads nothing it does not need:
//   * the tile loop stops at ceil(lengths[b] / BK) and never touches
//     rows past the valid length (the TPU kernel's revisit-block index
//     map becomes a length-bounded loop); with a window it starts at the
//     tile holding lo and loads no row below lo, so bytes are O(window)
//     and the paged entries look up no page below the first live tile;
//   * K and V are read in place from the model's [B, S_max, Hk, hd]
//     layout through strides (no transpose or copy of the cache);
//   * the G query rows of one KV head share every K/V tile staged in
//     shared memory, so each row is read from HBM once per step;
//   * tiles move as 16-byte vectors, and the next tile is in flight in
//     registers while the current one is computed.
// int8 cache: the same body with int8 values (16 to a 16-byte vector, so
// 2 vectors per thread and tile at hd 128 and 1 at hd 64) and scales
// [.., Hk, 1] in q's type, read as scalars through their own strides
// beside the values of their row and applied as the row is stored to
// shared memory.  Bytes per step halve against bf16 (plus 2 scale bytes
// per row and head), which an occupancy-bound kernel (below) does not
// turn into time.
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
#include <cstdint>
#include <type_traits>

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
// 16 int8 values, with no conversion instruction (those run at a
// quarter of the FMA rate): with its sign bit flipped, byte b holds
// b + 128, which one byte permute makes the low byte of the float
// 2^23 + b + 128; subtracting 2^23 + 128 leaves b exactly.
template <> struct Vec16<int8_t> {
  static constexpr int N = 16;
  __device__ static void unpack(const uint4& r, float* f) {
    const unsigned w[4] = {r.x ^ 0x80808080u, r.y ^ 0x80808080u,
                           r.z ^ 0x80808080u, r.w ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        f[4 * i + b] =
            __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7540u | b)) - 8388736.f;
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
// 16-byte aligned rows; keys [lo, min(lengths[b], cap)) with lo as in the
// header (window 0: lo = 0).  C: the cache
// values' type, T or int8_t; with int8 the scales ks/vs (type T) sit at
// the same (page, row, head) through their own strides.
template <typename T, typename C, int HD, typename Rows>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const C* __restrict__ k,
                    const C* __restrict__ v, const T* __restrict__ ks,
                    const T* __restrict__ vs, const int* __restrict__ lengths,
                    T* __restrict__ out, int G, int cap, int window,
                    long long q_sb, long long q_sh, Rows addr,
                    long long k_sp, long long k_ss, long long k_sh,
                    long long v_sp, long long v_ss, long long v_sh,
                    long long o_sb, long long o_sh,
                    long long ks_sp, long long ks_ss, long long ks_sh,
                    long long vs_sp, long long vs_ss, long long vs_sh, float scale) {
  static_assert(kBK == 32 && kThreads == 128 && kMaxG == 8, "thread layout");
  static_assert(kThreads % HD == 0 || HD % kThreads == 0, "thread layout");
  constexpr bool kQuant = std::is_same<C, int8_t>::value;
  constexpr int kGStep = kThreads / HD;          // query heads per pass
  constexpr int kGPer = kMaxG / kGStep;          // (g, d) outputs per thread
  constexpr int kV = Vec16<C>::N;                // elements per 16-byte load
  constexpr int kVecs = kBK * HD / kV / kThreads;  // loads per thread per tile
  static_assert(kVecs >= 1 && HD % kV == 0, "a vector stays in one key row");
  __shared__ float q_s[kMaxG][HD];
  __shared__ float k_s[kBK][HD + 1];             // +1: conflict-free row reads
  __shared__ __align__(16) float v_s[kBK][HD];   // 16-byte rows: float4 stores
  __shared__ float p_s[kMaxG][kBK];
  __shared__ float m_s[kMaxG], l_s[kMaxG], c_s[kMaxG];

  const int h = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const int L = min(lengths[b], cap);  // keys past the cache do not exist
  const int lo = window > 0 ? max(0, L - window) : 0;   // first live key
  const int start0 = lo / kBK * kBK;                      // its tile
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
  const C* kb = k + h * k_sh;
  const C* vb = v + h * v_sh;
  const T* ksb = kQuant ? ks + h * ks_sh : nullptr;
  const T* vsb = kQuant ? vs + h * vs_sh : nullptr;

  // The next tile is loaded into registers (raw 16-byte vectors) while
  // the current tile is computed, so the loop does not wait on memory.
  // Vector u of thread t holds tile elements (t + u * kThreads) * kV ...
  // (kV values of one key row); int8: ksc/vsc hold that row's scales.
  uint4 kr[kVecs], vr[kVecs];
  float ksc[kVecs], vsc[kVecs];
  auto load_tile = [&](int start) {
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int e = (t + u * kThreads) * kV, pos = start + e / HD, d = e % HD;
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      if (pos >= lo && pos < L) {
        const long long pg = addr.page(b, pos), w = addr.within(pos);
        kr[u] = *reinterpret_cast<const uint4*>(kb + pg * k_sp + w * k_ss + d);
        vr[u] = *reinterpret_cast<const uint4*>(vb + pg * v_sp + w * v_ss + d);
        if constexpr (kQuant) {
          ksc[u] = to_f(ksb[pg * ks_sp + w * ks_ss]);
          vsc[u] = to_f(vsb[pg * vs_sp + w * vs_ss]);
        }
      } else {
        kr[u] = zero;
        vr[u] = zero;
        if constexpr (kQuant) {
          ksc[u] = 0.f;
          vsc[u] = 0.f;
        }
      }
    }
  };
  load_tile(start0);
  __syncthreads();                               // q_s, m_s, l_s ready

  for (int start = start0; start < L; start += kBK) {
    __syncthreads();                             // previous tile fully used
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int e = (t + u * kThreads) * kV, j = e / HD, d = e % HD;
      float f[kV];
      // int8: dequantised on the way in, f32(int8) * f32(scale)
      const float kf = kQuant ? ksc[u] : 1.f, vf = kQuant ? vsc[u] : 1.f;
      Vec16<C>::unpack(kr[u], f);
#pragma unroll
      for (int c = 0; c < kV; ++c) k_s[j][d + c] = kQuant ? f[c] * kf : f[c];
      Vec16<C>::unpack(vr[u], f);
      // a V row is 16-byte aligned, so the vector goes in as float4s: a
      // quarter of the store instructions, and a warp's scalar stores,
      // kV floats apart, would meet on few banks
#pragma unroll
      for (int c = 0; c < kV; c += 4)
        *reinterpret_cast<float4*>(&v_s[j][d + c]) =
            kQuant ? make_float4(f[c] * vf, f[c + 1] * vf, f[c + 2] * vf, f[c + 3] * vf)
                   : make_float4(f[c], f[c + 1], f[c + 2], f[c + 3]);
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
      const bool key_ok = start + j >= lo && start + j < L;
      // rows of padded heads (g >= G) hold p = 0 and are never normalised
      p_s[ga][j] = ga < G ? (key_ok ? a0 + a1 : kNegInf) : 0.f;
      p_s[gb][j] = gb < G ? (key_ok ? b0 + b1 : kNegInf) : 0.f;
    }
    __syncthreads();
    // every tile holds >= 1 valid key (the first holds lo), so m_new is
    // finite and masked
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

// st: q (sb, sh), k (sp, ss, sh), v (sp, ss, sh), out (sb, sh), ks (sp,
// ss, sh), vs (sp, ss, sh), in elements (sp: the slab row stride, or the
// page stride).  C: the values' type (int8_t: with scales ks/vs).
template <typename T, typename C, typename Rows>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ks,
                   const void* vs, const int* lengths, void* out, int B, int Hk, int G,
                   int cap, int hd, int window, const long long* st, Rows addr,
                   float scale, cudaStream_t stream) {
  dim3 grid(Hk, B);
#define REPRO_DECODE_LAUNCH(HD)                                                         \
  flash_decode_kernel<T, C, HD, Rows><<<grid, kThreads, 0, stream>>>(                   \
      (const T*)q, (const C*)k, (const C*)v, (const T*)ks, (const T*)vs, lengths,       \
      (T*)out, G, cap, window, st[0], st[1], addr, st[2], st[3], st[4], st[5], st[6], st[7],    \
      st[8], st[9], st[10], st[11], st[12], st[13], st[14], st[15], scale)
  if (hd == 128)
    REPRO_DECODE_LAUNCH(128);
  else if (hd == 64)
    REPRO_DECODE_LAUNCH(64);
  else
    return cudaErrorInvalidValue;
#undef REPRO_DECODE_LAUNCH
  return cudaGetLastError();
}

template <bool kQuant, typename Rows>
int dispatch(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* lengths, void* out, int dtype, int B, int Hk,
             int G, int cap, int hd, int window, const long long* st, Rows addr,
             float scale, void* stream) {
  if (G < 1 || G > kMaxG) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int* lens = (const int*)lengths;
  if (dtype == 0)
    return (int)launch<float, std::conditional_t<kQuant, int8_t, float>>(
        q, k, v, ks, vs, lens, out, B, Hk, G, cap, hd, window, st, addr, scale, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16, std::conditional_t<kQuant, int8_t, __nv_bfloat16>>(
        q, k, v, ks, vs, lens, out, B, Hk, G, cap, hd, window, st, addr, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
// Slab cache: k/v [B, S, Hk, hd] with strides (sb, ss, sh).
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const void* lengths, void* out, int dtype, int B,
                            int Hk, int G, int S, int hd, int window, long long q_sb,
                            long long q_sh,
                            long long k_sb, long long k_ss, long long k_sh,
                            long long v_sb, long long v_ss, long long v_sh,
                            long long o_sb, long long o_sh, float scale,
                            void* stream) {
  const long long st[16] = {q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                            o_sb, o_sh, 0,    0,    0,    0,    0,    0};
  return dispatch<false>(q, k, v, nullptr, nullptr, lengths, out, dtype, B, Hk, G, S,
                         hd, window, st, SlabRows{}, scale, stream);
}

// Paged arena: k/v [P_phys, page, Hk, hd] with strides (sp, ss, sh);
// block_tables [B, pmax] int32 physical page ids; page = 1 << page_shift.
extern "C" int flash_decode_paged(const void* q, const void* k, const void* v,
                                  const void* lengths, const void* block_tables,
                                  void* out, int dtype, int B, int Hk, int G,
                                  int pmax, int page_shift, int hd, int window,
                                  long long q_sb,
                                  long long q_sh, long long k_sp, long long k_ss,
                                  long long k_sh, long long v_sp, long long v_ss,
                                  long long v_sh, long long o_sb, long long o_sh,
                                  float scale, void* stream) {
  if (page_shift < 0 || page_shift > 16 || pmax < 1) return (int)cudaErrorInvalidValue;
  const long long st[16] = {q_sb, q_sh, k_sp, k_ss, k_sh, v_sp, v_ss, v_sh,
                            o_sb, o_sh, 0,    0,    0,    0,    0,    0};
  return dispatch<false>(q, k, v, nullptr, nullptr, lengths, out, dtype, B, Hk, G,
                         pmax << page_shift, hd, window, st,
                         PagedRows{(const int*)block_tables, pmax, page_shift}, scale,
                         stream);
}

// int8 slab cache: values k/v int8 [B, S, Hk, hd] with strides (sb, ss,
// sh), scales ks/vs [B, S, Hk, 1] in q's type with strides (sb, ss, sh).
// Other arguments as flash_decode.
extern "C" int flash_decode_quant(const void* q, const void* k, const void* ks,
                                  const void* v, const void* vs, const void* lengths,
                                  void* out, int dtype, int B, int Hk, int G, int S,
                                  int hd, int window, long long q_sb, long long q_sh,
                                  long long k_sb,
                                  long long k_ss, long long k_sh, long long ks_sb,
                                  long long ks_ss, long long ks_sh, long long v_sb,
                                  long long v_ss, long long v_sh, long long vs_sb,
                                  long long vs_ss, long long vs_sh, long long o_sb,
                                  long long o_sh, float scale, void* stream) {
  const long long st[16] = {q_sb, q_sh, k_sb,  k_ss,  k_sh,  v_sb,  v_ss,  v_sh,
                            o_sb, o_sh, ks_sb, ks_ss, ks_sh, vs_sb, vs_ss, vs_sh};
  return dispatch<true>(q, k, v, ks, vs, lengths, out, dtype, B, Hk, G, S, hd, window, st,
                        SlabRows{}, scale, stream);
}

// int8 paged arenas: values k/v int8 [P_phys, page, Hk, hd] and scales
// ks/vs [P_phys, page, Hk, 1] in q's type, each with strides (sp, ss, sh),
// read through one block table.  Other arguments as flash_decode_paged.
extern "C" int flash_decode_paged_quant(
    const void* q, const void* k, const void* ks, const void* v, const void* vs,
    const void* lengths, const void* block_tables, void* out, int dtype, int B, int Hk,
    int G, int pmax, int page_shift, int hd, int window, long long q_sb, long long q_sh,
    long long k_sp, long long k_ss, long long k_sh, long long ks_sp, long long ks_ss,
    long long ks_sh, long long v_sp, long long v_ss, long long v_sh, long long vs_sp,
    long long vs_ss, long long vs_sh, long long o_sb, long long o_sh, float scale,
    void* stream) {
  if (page_shift < 0 || page_shift > 16 || pmax < 1) return (int)cudaErrorInvalidValue;
  const long long st[16] = {q_sb, q_sh, k_sp,  k_ss,  k_sh,  v_sp,  v_ss,  v_sh,
                            o_sb, o_sh, ks_sp, ks_ss, ks_sh, vs_sp, vs_ss, vs_sh};
  return dispatch<true>(q, k, v, ks, vs, lengths, out, dtype, B, Hk, G,
                        pmax << page_shift, hd, window, st,
                        PagedRows{(const int*)block_tables, pmax, page_shift}, scale,
                        stream);
}
