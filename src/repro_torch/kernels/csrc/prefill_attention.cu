// Cache-aware chunk-prefill attention for Hopper (sm_90a), against the
// slab KV cache or, through a block table, the paged KV arena, each in
// the model's type or in int8 with per-(position, head) scales.
//
// Replaces the TPU kernels src/repro/kernels/prefill_attention.py
// `flash_prefill_bhsd` (entry `flash_prefill`),
// `flash_prefill_paged_bhsd` (entry `flash_prefill_paged`),
// `flash_prefill_quant_bhsd` (entry `flash_prefill_quant`) and
// `flash_prefill_paged_quant_bhsd` (entry `flash_prefill_paged_quant`),
// all built by `_build` (`_kernel_common`, tile bounds from
// `_tile_bounds`; the int8 ones load through `_prefill_kernel_quant`).
// Same function: a query chunk q[m, i] at absolute
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
// int8 cache (the `_quant` entries): the same body with int8 values C
// and scales [.., Hk, 1] in q's type.  Each thread's 16-byte vector holds
// 16 values of one key row, so it reads that row's scale (a scalar
// through the scale leaf's strides: the leaf's last dim is 1, so its rows
// are not 16-byte vectors) with the values, and the row is dequantised
// as f32(int8) * f32(scale) while it is stored to shared memory, as the
// TPU kernel does per tile.  The cache bytes halve against bf16 (plus 2
// scale bytes per row and head); the products and the softmax are those
// of the bf16 path, so a long chunk stays bound by operations.
// Paged layout: the same body with another row addressing (the `Rows`
// functor): logical row pos of row m lives at physical page
// bt[m, pos / page], row pos % page, of the [P_phys, page, Hk, hd]
// arena.  The tile bounds stay logical; each 16-byte vector finds its own
// page (one lookup serves K and V), so a 32-key tile may straddle pages
// of any power-of-two size.  The lookups run one tile ahead of the K/V
// loads that use them, so a table read never sits in front of a tile's
// loads.  A batched resume passes its M rows of the table (bt[slot_idx])
// instead of slot_idx.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>
#include <type_traits>

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

// Where logical cache position `pos` of cache row `row` lives: element
// offset page(row, pos) * sp + within(pos) * ss (+ head and column).
// Slab [B, S, Hk, hd]: the page is the slab row and sp its stride.
// Paged [P_phys, page, Hk, hd]: the page comes from the block table
// bt [M, pmax], page size 1 << shift.
// kTable: the page depends on pos, so the kernel reads it a tile ahead.
struct SlabRows {
  static constexpr bool kTable = false;
  __device__ __forceinline__ int page(int row, int) const { return row; }
  __device__ __forceinline__ int within(int pos) const { return pos; }
};
struct PagedRows {
  static constexpr bool kTable = true;
  const int* bt;
  int pmax, shift;
  __device__ __forceinline__ int page(int row, int pos) const {
    return bt[(long long)row * pmax + (pos >> shift)];
  }
  __device__ __forceinline__ int within(int pos) const {
    return pos & ((1 << shift) - 1);
  }
};

template <int HD>
constexpr int smem_floats() {
  return kBM * (HD + 1) + kBK * (HD + 1) + kBK * HD + kBM * (kBK + 1) + 3 * kBM;
}

// grid (query tiles, Hk, M); block kThreads; dynamic shared memory
// smem_floats<HD>() * 4 bytes.  q/out: [M, Sq, H, hd] with strides
// (sm, ss, sh); K at addr.page(slot, pos) * k_sp + addr.within(pos) * k_ss
// + h * k_sh (likewise V) with slot = slot_idx[m] (or m); all with a unit
// stride on hd, cache rows 16-byte aligned; keys below min(lengths[m], cap).
// C: the cache values' type, T or int8_t; with int8 the scales ks/vs
// (type T) sit at the same (page, row, head) through their own strides.
template <typename T, typename C, int HD, typename Rows>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q, const C* __restrict__ k,
                     const C* __restrict__ v, const T* __restrict__ ks,
                     const T* __restrict__ vs, const int* __restrict__ slot_idx,
                     const int* __restrict__ q_offset,
                     const int* __restrict__ lengths, T* __restrict__ out,
                     int Sq, int G, int cap, int window,
                     long long q_sm, long long q_ss, long long q_sh,
                     Rows addr, long long k_sp, long long k_ss, long long k_sh,
                     long long v_sp, long long v_ss, long long v_sh,
                     long long o_sm, long long o_ss, long long o_sh,
                     long long ks_sp, long long ks_ss, long long ks_sh,
                     long long vs_sp, long long vs_ss, long long vs_sh, float scale) {
  static_assert(kThreads == 128 && kBM == 64 && kBK == 32, "thread layout");
  constexpr bool kQuant = std::is_same<C, int8_t>::value;
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
  const int len = min(lengths[m], cap);
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
  // slab: the slot's row offset is folded in here, once
  const long long row0 = Rows::kTable ? 0 : addr.page(slot, 0);
  const C* kb = k + h * k_sh + row0 * k_sp;
  const C* vb = v + h * v_sh + row0 * v_sp;
  const T* ksb = kQuant ? ks + h * ks_sh + row0 * ks_sp : nullptr;
  const T* vsb = kQuant ? vs + h * vs_sh + row0 * vs_sp : nullptr;
  // vector u of thread t holds tile elements (t + u * kThreads) * kV ...
  // (kV values of one key row: 4 f32, 8 bf16 or 16 int8, so kVecs is 8,
  // 4 or 2 at hd 128 and half that at hd 64); paged: pg[u] is its page in
  // the tile about to be loaded
  constexpr int kV = Vec16<C>::N, kVecs = kBK * HD / kV / kThreads;
  static_assert(kVecs >= 1 && HD % kV == 0, "a vector stays in one key row");
  int pg[kVecs];
  auto pages_of = [&](int k0) {
    if constexpr (!Rows::kTable) return;
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int pos = k0 + (t + u * kThreads) * kV / HD;
      pg[u] = pos < len ? addr.page(slot, pos) : 0;
    }
  };
  pages_of(first * kBK);

  for (int kt = first; kt <= last; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                             // previous tile fully used
    // the tile's 16-byte loads are all in flight before any of them is
    // unpacked into shared memory: one memory round trip per tile
    uint4 kr[kVecs], vr[kVecs];
    float ksc[kVecs], vsc[kVecs];                // int8: the rows' scales
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int e = (t + u * kThreads) * kV, pos = k0 + e / HD, d = e % HD;
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      const long long w = addr.within(pos);
      const long long ko = Rows::kTable ? pg[u] * k_sp + w * k_ss : pos * k_ss;
      const long long vo = Rows::kTable ? pg[u] * v_sp + w * v_ss : pos * v_ss;
      kr[u] = pos < len ? *reinterpret_cast<const uint4*>(kb + ko + d) : zero;
      vr[u] = pos < len ? *reinterpret_cast<const uint4*>(vb + vo + d) : zero;
      if constexpr (kQuant) {
        const long long kso = Rows::kTable ? pg[u] * ks_sp + w * ks_ss : pos * ks_ss;
        const long long vso = Rows::kTable ? pg[u] * vs_sp + w * vs_ss : pos * vs_ss;
        ksc[u] = pos < len ? to_f(ksb[kso]) : 0.f;
        vsc[u] = pos < len ? to_f(vsb[vso]) : 0.f;
      }
    }
    if (kt < last) pages_of(k0 + kBK);           // next tile's table reads
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int e = (t + u * kThreads) * kV, j = e / HD, d = e % HD;
      float f[kV];
      // int8: dequantised on the way in, f32(int8) * f32(scale)
      const float kf = kQuant ? ksc[u] : 1.f, vf = kQuant ? vsc[u] : 1.f;
      Vec16<C>::unpack(kr[u], f);
#pragma unroll
      for (int c = 0; c < kV; ++c) k_s[j * (HD + 1) + d + c] = kQuant ? f[c] * kf : f[c];
      Vec16<C>::unpack(vr[u], f);
      // a V row is 16-byte aligned, so the vector goes in as float4s: a
      // quarter of the store instructions, and a warp's scalar stores,
      // kV floats apart, would meet on few banks
#pragma unroll
      for (int c = 0; c < kV; c += 4)
        *reinterpret_cast<float4*>(v_s + j * HD + d + c) =
            kQuant ? make_float4(f[c] * vf, f[c + 1] * vf, f[c + 2] * vf, f[c + 3] * vf)
                   : make_float4(f[c], f[c + 1], f[c + 2], f[c + 3]);
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

template <typename T, typename C, int HD, typename Rows>
cudaError_t launch_hd(const void* q, const void* k, const void* v, const void* ks,
                      const void* vs, const int* slot_idx, const int* q_offset,
                      const int* lengths, void* out, int M, int Sq, int Hk, int G,
                      int cap, int window, const long long* st, Rows addr, float scale,
                      cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * (int)sizeof(float);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_prefill_kernel<T, C, HD, Rows>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int qpt = kBM / G;
  dim3 grid((Sq + qpt - 1) / qpt, Hk, M);
  flash_prefill_kernel<T, C, HD, Rows><<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const C*)k, (const C*)v, (const T*)ks, (const T*)vs, slot_idx,
      q_offset, lengths, (T*)out, Sq, G, cap, window, st[0], st[1], st[2], addr, st[3],
      st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12], st[13], st[14],
      st[15], st[16], st[17], scale);
  return cudaGetLastError();
}

// st: q (sm, ss, sh), k (sp, ss, sh), v (sp, ss, sh), out (sm, ss, sh),
// ks (sp, ss, sh), vs (sp, ss, sh), in elements (sp: the slab row stride,
// or the page stride).  kQuant: int8 values with scales ks/vs of q's type;
// else ks/vs are unused and the values have q's type.
template <bool kQuant, typename Rows>
int dispatch(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* slot_idx, const void* q_offset,
             const void* lengths, void* out, int dtype, int M, int Sq, int Hk, int G,
             int cap, int hd, int window, const long long* st, Rows addr, float scale,
             void* stream) {
  if (G < 1 || G > kBM) return (int)cudaErrorInvalidValue;
  if (M == 0 || Sq == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int* si = (const int*)slot_idx;
  const int* qo = (const int*)q_offset;
  const int* ln = (const int*)lengths;
#define REPRO_PREFILL_LAUNCH(T, HD)                                                \
  return (int)launch_hd<T, std::conditional_t<kQuant, int8_t, T>, HD, Rows>(       \
      q, k, v, ks, vs, si, qo, ln, out, M, Sq, Hk, G, cap, window, st, addr, scale, s)
  if (dtype == 0 && hd == 128) REPRO_PREFILL_LAUNCH(float, 128);
  if (dtype == 0 && hd == 64) REPRO_PREFILL_LAUNCH(float, 64);
  if (dtype == 1 && hd == 128) REPRO_PREFILL_LAUNCH(__nv_bfloat16, 128);
  if (dtype == 1 && hd == 64) REPRO_PREFILL_LAUNCH(__nv_bfloat16, 64);
#undef REPRO_PREFILL_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  slot_idx may be null (row m reads
// cache row m).  Slab cache k/v [B, S, Hk, hd].  strides: q (sm, ss, sh),
// k (sb, ss, sh), v (sb, ss, sh), out (sm, ss, sh), in elements.
// Returns the launch's cudaError_t.
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             const void* slot_idx, const void* q_offset,
                             const void* lengths, void* out, int dtype, int M,
                             int Sq, int Hk, int G, int S, int hd, int window,
                             long long q_sm, long long q_ss, long long q_sh,
                             long long k_sb, long long k_ss, long long k_sh,
                             long long v_sb, long long v_ss, long long v_sh,
                             long long o_sm, long long o_ss, long long o_sh,
                             float scale, void* stream) {
  const long long st[18] = {q_sm, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                            o_sm, o_ss, o_sh, 0,    0,    0,    0,    0,    0};
  return dispatch<false>(q, k, v, nullptr, nullptr, slot_idx, q_offset, lengths, out,
                         dtype, M, Sq, Hk, G, S, hd, window, st, SlabRows{}, scale,
                         stream);
}

// Paged arena k/v [P_phys, page, Hk, hd] with strides (sp, ss, sh);
// block_tables [M, pmax] int32 physical page ids, row m for query row m;
// page = 1 << page_shift.  Other arguments as flash_prefill.
extern "C" int flash_prefill_paged(const void* q, const void* k, const void* v,
                                   const void* block_tables, const void* q_offset,
                                   const void* lengths, void* out, int dtype, int M,
                                   int Sq, int Hk, int G, int pmax, int page_shift,
                                   int hd, int window, long long q_sm, long long q_ss,
                                   long long q_sh, long long k_sp, long long k_ss,
                                   long long k_sh, long long v_sp, long long v_ss,
                                   long long v_sh, long long o_sm, long long o_ss,
                                   long long o_sh, float scale, void* stream) {
  if (page_shift < 0 || page_shift > 16 || pmax < 1) return (int)cudaErrorInvalidValue;
  const long long st[18] = {q_sm, q_ss, q_sh, k_sp, k_ss, k_sh, v_sp, v_ss, v_sh,
                            o_sm, o_ss, o_sh, 0,    0,    0,    0,    0,    0};
  return dispatch<false>(q, k, v, nullptr, nullptr, nullptr, q_offset, lengths, out,
                         dtype, M, Sq, Hk, G, pmax << page_shift, hd, window, st,
                         PagedRows{(const int*)block_tables, pmax, page_shift}, scale,
                         stream);
}

// int8 slab cache: values k/v int8 [B, S, Hk, hd] with strides (sb, ss,
// sh), scales ks/vs [B, S, Hk, 1] in q's type with strides (sb, ss, sh).
// Other arguments as flash_prefill.
extern "C" int flash_prefill_quant(const void* q, const void* k, const void* ks,
                                   const void* v, const void* vs, const void* slot_idx,
                                   const void* q_offset, const void* lengths, void* out,
                                   int dtype, int M, int Sq, int Hk, int G, int S, int hd,
                                   int window, long long q_sm, long long q_ss,
                                   long long q_sh, long long k_sb, long long k_ss,
                                   long long k_sh, long long ks_sb, long long ks_ss,
                                   long long ks_sh, long long v_sb, long long v_ss,
                                   long long v_sh, long long vs_sb, long long vs_ss,
                                   long long vs_sh, long long o_sm, long long o_ss,
                                   long long o_sh, float scale, void* stream) {
  const long long st[18] = {q_sm,  q_ss,  q_sh,  k_sb,  k_ss,  k_sh,
                            v_sb,  v_ss,  v_sh,  o_sm,  o_ss,  o_sh,
                            ks_sb, ks_ss, ks_sh, vs_sb, vs_ss, vs_sh};
  return dispatch<true>(q, k, v, ks, vs, slot_idx, q_offset, lengths, out, dtype, M, Sq,
                        Hk, G, S, hd, window, st, SlabRows{}, scale, stream);
}

// int8 paged arenas: values k/v int8 [P_phys, page, Hk, hd] and scales
// ks/vs [P_phys, page, Hk, 1] in q's type, each with strides (sp, ss, sh),
// read through one block table.  Other arguments as flash_prefill_paged.
extern "C" int flash_prefill_paged_quant(
    const void* q, const void* k, const void* ks, const void* v, const void* vs,
    const void* block_tables, const void* q_offset, const void* lengths, void* out,
    int dtype, int M, int Sq, int Hk, int G, int pmax, int page_shift, int hd,
    int window, long long q_sm, long long q_ss, long long q_sh, long long k_sp,
    long long k_ss, long long k_sh, long long ks_sp, long long ks_ss, long long ks_sh,
    long long v_sp, long long v_ss, long long v_sh, long long vs_sp, long long vs_ss,
    long long vs_sh, long long o_sm, long long o_ss, long long o_sh, float scale,
    void* stream) {
  if (page_shift < 0 || page_shift > 16 || pmax < 1) return (int)cudaErrorInvalidValue;
  const long long st[18] = {q_sm,  q_ss,  q_sh,  k_sp,  k_ss,  k_sh,
                            v_sp,  v_ss,  v_sh,  o_sm,  o_ss,  o_sh,
                            ks_sp, ks_ss, ks_sh, vs_sp, vs_ss, vs_sh};
  return dispatch<true>(q, k, v, ks, vs, nullptr, q_offset, lengths, out, dtype, M, Sq,
                        Hk, G, pmax << page_shift, hd, window, st,
                        PagedRows{(const int*)block_tables, pmax, page_shift}, scale,
                        stream);
}
