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
// the card, so the products stay on the CUDA cores and the design is
// about parallelism and streaming:
//   * split over fixed key chunks.  Block (chunk c, KV head h, head group,
//     row b) covers keys [c * chunk, (c + 1) * chunk) of [lo, lengths[b]),
//     with `chunk` a multiple of the 32-key tile (DECODE_CHUNK in the
//     wrapper).  The chunk count, ceil(capacity / chunk), comes from the
//     cache's static capacity alone, so the host never reads `lengths`;
//     a chunk with no live key writes m = -1e30, l = 0 and returns
//     without reading K or V.  At Qwen2.5-3B's 16/2 heads, 6 rows of up
//     to 8000 keys, 256-key chunks give about 140 live blocks (one wave
//     on 132 SMs) where one block per (b, h) gave 12;
//   * each block writes its unnormalised f32 accumulator and (m, l), m in
//     log2 units, to a scratch buffer; `decode_merge_kernel` combines a
//     row's live chunks in chunk order (no atomics).  Chunk boundaries
//     depend on neither the batch, the capacity nor the other rows, so a
//     row's output is bitwise the same alone, in a batch and over a
//     larger cache;
//   * query groups above 8 take ceil(G / 8) head groups, one block each
//     (the K/V tiles of a KV head are then read once per head group);
//   * inside a block, the tile loop reads nothing it does not need: it
//     runs over the chunk's live 32-key tiles only, and with a window it
//     starts at the tile holding lo, so bytes are O(window) and the paged
//     entries look up no page below the first live tile;
//   * K and V are read in place from the model's [B, S_max, Hk, hd]
//     layout through strides (no transpose or copy of the cache);
//   * the G query rows of one KV head share every K/V tile staged in
//     shared memory, so each row is read from HBM once per head group;
//   * tiles move as 16-byte vectors, and the next tile is in flight in
//     registers while the current one is computed;
//   * the merge keeps 16 chunks' loads in flight before it adds them in
//     chunk order.
// What still bounds it (PERF.md §6): at Qwen2.5-3B's timing shape the
// two launches take about 0.033 ms of device time against a 0.0054 ms
// byte bound.  A tile costs the SM about 1.8 us of shared-memory traffic
// and latency (staged as f32, read by all 4 warps), and the busiest SMs
// run two 8-tile blocks.
// int8 cache: the same body with int8 values (16 to a 16-byte vector, so
// 2 vectors per thread and tile at hd 128 and 1 at hd 64) and scales
// [.., Hk, 1] in q's type, read as scalars through their own strides
// beside the values of their row and applied as the row is stored to
// shared memory.  Bytes per step halve against bf16 (plus 2 scale bytes
// per row and head).
// Paged layout: the kernel body is the slab one; only the row
// addressing differs (the `Rows` functor).  Logical row pos of batch row
// b lives at physical page bt[b, pos / page], row pos % page, of the
// [P_phys, page, Hk, hd] arena, so each 16-byte vector finds its own page
// (one lookup serves K and V) and a 32-key tile may straddle pages of
// any power-of-two size.  The lookups are part of the next tile's
// register prefetch, so they overlap the current tile's compute.  Keys
// are bounded by min(lengths[b], P_max * page), and chunks are counted
// over P_max * page.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kBK = 32;      // keys per tile (== warp size, see softmax step)
constexpr int kMaxG = 8;     // query heads of one head group (padded to 8)
constexpr float kLog2e = 1.4426950408889634f;

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

// Stores kV floats (times `scale`) at a 16-byte aligned row of shared
// memory as float4s.  With 8 floats a lane, the 8 lanes of a quarter-warp
// sit 8 floats apart, so their first float4s meet on 16 banks; lanes 4-7
// of each quarter store their second float4 first, and every store
// instruction covers 32 distinct banks.
template <int kV>
__device__ __forceinline__ void store_row(float* row, const float* f, float scale,
                                          int lane) {
  if constexpr (kV == 8) {
    const bool swap = (lane >> 2) & 1;
#pragma unroll
    for (int x = 0; x < 8; x += 4) {
      const int y = swap ? 4 - x : x;            // 0, 4 or 4, 0
      const float4 a = make_float4(f[x] * scale, f[x + 1] * scale, f[x + 2] * scale,
                                   f[x + 3] * scale);
      const float4 b = make_float4(f[4 - x] * scale, f[5 - x] * scale, f[6 - x] * scale,
                                   f[7 - x] * scale);
      *reinterpret_cast<float4*>(row + y) = swap ? b : a;
    }
  } else {
#pragma unroll
    for (int x = 0; x < kV; x += 4)
      *reinterpret_cast<float4*>(row + x) = make_float4(
          f[x] * scale, f[x + 1] * scale, f[x + 2] * scale, f[x + 3] * scale);
  }
}

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

// grid (chunks, Hk * ceil(G / kMaxG), B); block kThreads.  Block (c, h *
// n_groups + hg, b) takes query heads h * G + hg * kMaxG .. (at most kMaxG)
// of row b against keys [max(lo, c * chunk), min(L, (c + 1) * chunk)),
// L = min(lengths[b], cap), lo as in the header (window 0: lo = 0).
// q: [B, 1, H, hd] rows addressed by (b * q_sb + head * q_sh); K at
// addr.page(b, pos) * k_sp + addr.within(pos) * k_ss + h * k_sh (likewise
// V), a unit stride on hd, 16-byte aligned rows.  C: the cache values'
// type, T or int8_t; with int8 the scales ks/vs (type T) sit at the same
// (page, row, head) through their own strides.  Writes, for each head,
// part_o[(c * B + b) * H + head][0..hd) (the unnormalised f32
// accumulator) and part_ml[..][0..2) = (m in log2 units, l).
template <typename T, typename C, int HD, typename Rows>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const C* __restrict__ k,
                    const C* __restrict__ v, const T* __restrict__ ks,
                    const T* __restrict__ vs, const int* __restrict__ lengths,
                    float* __restrict__ part_o, float* __restrict__ part_ml, int B,
                    int H, int G, int cap, int window, int chunk,
                    long long q_sb, long long q_sh, Rows addr,
                    long long k_sp, long long k_ss, long long k_sh,
                    long long v_sp, long long v_ss, long long v_sh,
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
  // every row 16-byte aligned: the tile is stored, and q, K and p are read,
  // as float4s (a quarter of the instructions; a warp-wide broadcast of
  // one float4 costs what a scalar one does)
  __shared__ __align__(16) float q_s[kMaxG][HD];
  __shared__ __align__(16) float k_s[kBK][HD + 4];  // +4: lanes on distinct banks
  __shared__ __align__(16) float v_s[kBK][HD];
  __shared__ __align__(16) float p_s[kMaxG][kBK];
  __shared__ float m_s[kMaxG], l_s[kMaxG], c_s[kMaxG];

  const int n_groups = (G + kMaxG - 1) / kMaxG;
  const int c = blockIdx.x, h = blockIdx.y / n_groups, b = blockIdx.z;
  const int hg = blockIdx.y % n_groups, t = threadIdx.x;
  const int Gb = min(kMaxG, G - hg * kMaxG);     // this block's query heads
  const int head0 = h * G + hg * kMaxG;          // the first of them
  const int warp = t / 32, lane = t % 32;
  const int L = min(lengths[b], cap);  // keys past the cache do not exist
  const int lo = window > 0 ? max(0, L - window) : 0;   // first live key
  // the chunk's live keys; chunk is a multiple of kBK, so every tile of
  // the loop below lies inside the chunk
  const int key_lo = max(lo, c * chunk), key_hi = min(L, (c + 1) * chunk);
  const long long prow = ((long long)c * B + b) * H + head0;
  if (key_lo >= key_hi) {
    if (t < Gb) {
      part_ml[2 * (prow + t)] = kNegInf;
      part_ml[2 * (prow + t) + 1] = 0.f;
    }
    return;
  }
  const int start0 = key_lo / kBK * kBK;         // the tile holding key_lo
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
      if (pos >= key_lo && pos < key_hi) {
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
  load_tile(start0);                             // in flight while q is staged
  for (int i = t; i < kMaxG * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    q_s[g][d] = g < Gb
        ? to_f(q[b * q_sb + (long long)(head0 + g) * q_sh + d]) * (scale * kLog2e) : 0.f;
  }
  if (t < kMaxG) { m_s[t] = kNegInf; l_s[t] = 0.f; c_s[t] = 0.f; }
  __syncthreads();                               // q_s, m_s, l_s ready

  for (int start = start0; start < key_hi; start += kBK) {
    __syncthreads();                             // previous tile fully used
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int e = (t + u * kThreads) * kV, j = e / HD, d = e % HD;
      float f[kV];
      // int8: dequantised on the way in, f32(int8) * f32(scale)
      const float kf = kQuant ? ksc[u] : 1.f, vf = kQuant ? vsc[u] : 1.f;
      // the vector goes in as float4s: a warp's scalar stores, kV floats
      // apart, would meet on few banks
      Vec16<C>::unpack(kr[u], f);
      store_row<kV>(&k_s[j][d], f, kf, lane);
      Vec16<C>::unpack(vr[u], f);
      store_row<kV>(&v_s[j][d], f, vf, lane);
    }
    __syncthreads();
    if (start + kBK < key_hi) load_tile(start + kBK);

    // scores (log2 units: q carries log2(e)): lane -> key, warp -> heads
    // warp and warp + 4 (one K read per two products; the q reads are
    // warp-wide broadcasts)
    {
      const int j = lane, ga = warp, gb = warp + 4;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      float b0 = 0.f, b1 = 0.f, b2 = 0.f, b3 = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&k_s[j][d]);
        const float4 qa = *reinterpret_cast<const float4*>(&q_s[ga][d]);
        const float4 qb = *reinterpret_cast<const float4*>(&q_s[gb][d]);
        a0 += qa.x * kk.x;
        a1 += qa.y * kk.y;
        a2 += qa.z * kk.z;
        a3 += qa.w * kk.w;
        b0 += qb.x * kk.x;
        b1 += qb.y * kk.y;
        b2 += qb.z * kk.z;
        b3 += qb.w * kk.w;
      }
      const bool key_ok = start + j >= key_lo && start + j < key_hi;
      // rows of padded heads (g >= Gb) hold p = 0 and are never written
      p_s[ga][j] = ga < Gb ? (key_ok ? (a0 + a1) + (a2 + a3) : kNegInf) : 0.f;
      p_s[gb][j] = gb < Gb ? (key_ok ? (b0 + b1) + (b2 + b3) : kNegInf) : 0.f;
    }
    __syncthreads();
    // every tile holds >= 1 live key (the first holds key_lo), so m_new
    // is finite and masked scores underflow to p = 0
    for (int g = warp; g < Gb; g += kThreads / 32) {
      const float s = p_s[g][lane];
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = exp2f(s - m_new);
      const float sum = warp_sum(p);
      p_s[g][lane] = p;
      if (lane == 0) {
        const float corr = exp2f(m_old - m_new);
        c_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // acc[g, d0] = acc * corr + sum_j p[g, j] v[j, d0]: each V element is
    // read once for all of the thread's heads
#pragma unroll
    for (int i = 0; i < kGPer; ++i) acc[i] *= c_s[g0 + i * kGStep];
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      const float v0 = v_s[j][d0], v1 = v_s[j + 1][d0], v2 = v_s[j + 2][d0],
                  v3 = v_s[j + 3][d0];
#pragma unroll
      for (int i = 0; i < kGPer; ++i) {
        const float4 p = *reinterpret_cast<const float4*>(&p_s[g0 + i * kGStep][j]);
        acc[i] += p.x * v0;
        acc[i] += p.y * v1;
        acc[i] += p.z * v2;
        acc[i] += p.w * v3;
      }
    }
  }
  // m_s and l_s are final: the last tile's softmax step is behind a
  // barrier
#pragma unroll
  for (int i = 0; i < kGPer; ++i) {
    const int g = g0 + i * kGStep;
    if (g < Gb) part_o[(prow + g) * HD + d0] = acc[i];
  }
  if (t < Gb) {
    part_ml[2 * (prow + t)] = m_s[t];
    part_ml[2 * (prow + t) + 1] = l_s[t];
  }
}

// One warp per (row b, query head): combines the row's live chunks
// [lo / chunk, (L - 1) / chunk] in chunk order.  With mx the largest m
// and w_c = 2^(m_c - mx): out = sum_c w_c acc_c / max(sum_c w_c l_c,
// 1e-30), written in T through the output's (row, head) strides.  A row
// with no live key (L <= lo) gets zeros.  Chunks outside the live range
// are never read.
template <typename T, int HD>
__global__ void __launch_bounds__(128)
decode_merge_kernel(const float* __restrict__ part_o, const float* __restrict__ part_ml,
                    const int* __restrict__ lengths, T* __restrict__ out, int B, int H,
                    int cap, int window, int chunk, long long o_sb, long long o_sh) {
  constexpr int kC = HD / 32;
  const int r = blockIdx.x * 4 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (r >= B * H) return;
  const int b = r / H, head = r % H;
  const int L = min(lengths[b], cap);
  const int lo = window > 0 ? max(0, L - window) : 0;
  const int first = lo / chunk, last = L > lo ? (L - 1) / chunk : first - 1;
  // the largest m: lanes take chunks in parallel (max is exact in any
  // order); the sums below run in chunk order
  float mx = kNegInf;
  for (int c = first + lane; c <= last; c += 32)
    mx = fmaxf(mx, part_ml[2 * (((long long)c * B + b) * H + head)]);
  mx = warp_max(mx);
  float acc[kC], den = 0.f;
#pragma unroll
  for (int x = 0; x < kC; ++x) acc[x] = 0.f;
  // kBatch chunks' loads in flight at once, then their sums in order
  constexpr int kBatch = 16;
  for (int c0 = first; c0 <= last; c0 += kBatch) {
    float m[kBatch], l[kBatch], po[kBatch][kC];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (c0 + u <= last) {
        const long long pr = ((long long)(c0 + u) * B + b) * H + head;
        m[u] = part_ml[2 * pr];
        l[u] = part_ml[2 * pr + 1];
#pragma unroll
        for (int x = 0; x < kC; ++x) po[u][x] = part_o[pr * HD + lane + 32 * x];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (c0 + u <= last) {
        const float w = exp2f(m[u] - mx);
        den += w * l[u];
#pragma unroll
        for (int x = 0; x < kC; ++x) acc[x] += w * po[u][x];
      }
    }
  }
  const float inv = 1.f / fmaxf(den, 1e-30f);
  T* orow = out + b * o_sb + (long long)head * o_sh + lane;
#pragma unroll
  for (int x = 0; x < kC; ++x) orow[32 * x] = from_f<T>(acc[x] * inv);
}

template <typename T>
cudaError_t launch_merge(const float* part_o, const float* part_ml, const int* lengths,
                         void* out, int B, int H, int hd, int cap, int window, int chunk,
                         long long o_sb, long long o_sh, cudaStream_t stream) {
  const dim3 grid((B * H + 3) / 4);
  if (hd == 128)
    decode_merge_kernel<T, 128><<<grid, 128, 0, stream>>>(
        part_o, part_ml, lengths, (T*)out, B, H, cap, window, chunk, o_sb, o_sh);
  else if (hd == 64)
    decode_merge_kernel<T, 64><<<grid, 128, 0, stream>>>(
        part_o, part_ml, lengths, (T*)out, B, H, cap, window, chunk, o_sb, o_sh);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// st: q (sb, sh), k (sp, ss, sh), v (sp, ss, sh), out (sb, sh), ks (sp,
// ss, sh), vs (sp, ss, sh), in elements (sp: the slab row stride, or the
// page stride).  C: the values' type (int8_t: with scales ks/vs).  The
// chunk kernel, then the merge, on `stream`.
template <typename T, typename C, typename Rows>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ks,
                   const void* vs, const int* lengths, void* out, float* part_o,
                   float* part_ml, int B, int Hk, int G, int cap, int hd, int window,
                   int chunk, const long long* st, Rows addr, float scale,
                   cudaStream_t stream) {
  const int H = Hk * G;
  const dim3 grid((cap + chunk - 1) / chunk, Hk * ((G + kMaxG - 1) / kMaxG), B);
#define REPRO_DECODE_LAUNCH(HD)                                                         \
  flash_decode_kernel<T, C, HD, Rows><<<grid, kThreads, 0, stream>>>(                   \
      (const T*)q, (const C*)k, (const C*)v, (const T*)ks, (const T*)vs, lengths,       \
      part_o, part_ml, B, H, G, cap, window, chunk, st[0], st[1], addr, st[2], st[3],    \
      st[4], st[5], st[6], st[7], st[10], st[11], st[12], st[13], st[14], st[15], scale)
  if (hd == 128)
    REPRO_DECODE_LAUNCH(128);
  else if (hd == 64)
    REPRO_DECODE_LAUNCH(64);
  else
    return cudaErrorInvalidValue;
#undef REPRO_DECODE_LAUNCH
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_merge<T>(part_o, part_ml, lengths, out, B, H, hd, cap, window, chunk,
                         st[8], st[9], stream);
}

template <bool kQuant, typename Rows>
int dispatch(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* lengths, void* out, void* part_o,
             void* part_ml, int dtype, int B, int Hk, int G, int cap, int hd, int window,
             int chunk, const long long* st, Rows addr, float scale, void* stream) {
  if (G < 1 || Hk < 1 || cap < 1 || chunk < kBK || chunk % kBK)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int* lens = (const int*)lengths;
  float* po = (float*)part_o;
  float* pml = (float*)part_ml;
  if (dtype == 0)
    return (int)launch<float, std::conditional_t<kQuant, int8_t, float>>(
        q, k, v, ks, vs, lens, out, po, pml, B, Hk, G, cap, hd, window, chunk, st, addr,
        scale, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16, std::conditional_t<kQuant, int8_t, __nv_bfloat16>>(
        q, k, v, ks, vs, lens, out, po, pml, B, Hk, G, cap, hd, window, chunk, st, addr,
        scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the launches' cudaError_t.
// part_o / part_ml: f32 scratch of [ceil(cap / chunk), B, H, hd] and
// [.., 2] (cap: S, or pmax * page); chunk: keys per block, a multiple of
// 32.  Slab cache: k/v [B, S, Hk, hd] with strides (sb, ss, sh).
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const void* lengths, void* out, void* part_o, void* part_ml,
                            int dtype, int B, int Hk, int G, int S, int hd, int window,
                            int chunk, long long q_sb, long long q_sh,
                            long long k_sb, long long k_ss, long long k_sh,
                            long long v_sb, long long v_ss, long long v_sh,
                            long long o_sb, long long o_sh, float scale,
                            void* stream) {
  const long long st[16] = {q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                            o_sb, o_sh, 0,    0,    0,    0,    0,    0};
  return dispatch<false>(q, k, v, nullptr, nullptr, lengths, out, part_o, part_ml, dtype,
                         B, Hk, G, S, hd, window, chunk, st, SlabRows{}, scale, stream);
}

// Paged arena: k/v [P_phys, page, Hk, hd] with strides (sp, ss, sh);
// block_tables [B, pmax] int32 physical page ids; page = 1 << page_shift.
extern "C" int flash_decode_paged(const void* q, const void* k, const void* v,
                                  const void* lengths, const void* block_tables,
                                  void* out, void* part_o, void* part_ml, int dtype,
                                  int B, int Hk, int G, int pmax, int page_shift, int hd,
                                  int window, int chunk, long long q_sb,
                                  long long q_sh, long long k_sp, long long k_ss,
                                  long long k_sh, long long v_sp, long long v_ss,
                                  long long v_sh, long long o_sb, long long o_sh,
                                  float scale, void* stream) {
  if (page_shift < 0 || page_shift > 16 || pmax < 1) return (int)cudaErrorInvalidValue;
  const long long st[16] = {q_sb, q_sh, k_sp, k_ss, k_sh, v_sp, v_ss, v_sh,
                            o_sb, o_sh, 0,    0,    0,    0,    0,    0};
  return dispatch<false>(q, k, v, nullptr, nullptr, lengths, out, part_o, part_ml, dtype,
                         B, Hk, G, pmax << page_shift, hd, window, chunk, st,
                         PagedRows{(const int*)block_tables, pmax, page_shift}, scale,
                         stream);
}

// int8 slab cache: values k/v int8 [B, S, Hk, hd] with strides (sb, ss,
// sh), scales ks/vs [B, S, Hk, 1] in q's type with strides (sb, ss, sh).
// Other arguments as flash_decode.
extern "C" int flash_decode_quant(const void* q, const void* k, const void* ks,
                                  const void* v, const void* vs, const void* lengths,
                                  void* out, void* part_o, void* part_ml, int dtype,
                                  int B, int Hk, int G, int S, int hd, int window,
                                  int chunk, long long q_sb, long long q_sh,
                                  long long k_sb,
                                  long long k_ss, long long k_sh, long long ks_sb,
                                  long long ks_ss, long long ks_sh, long long v_sb,
                                  long long v_ss, long long v_sh, long long vs_sb,
                                  long long vs_ss, long long vs_sh, long long o_sb,
                                  long long o_sh, float scale, void* stream) {
  const long long st[16] = {q_sb, q_sh, k_sb,  k_ss,  k_sh,  v_sb,  v_ss,  v_sh,
                            o_sb, o_sh, ks_sb, ks_ss, ks_sh, vs_sb, vs_ss, vs_sh};
  return dispatch<true>(q, k, v, ks, vs, lengths, out, part_o, part_ml, dtype, B, Hk, G,
                        S, hd, window, chunk, st, SlabRows{}, scale, stream);
}

// int8 paged arenas: values k/v int8 [P_phys, page, Hk, hd] and scales
// ks/vs [P_phys, page, Hk, 1] in q's type, each with strides (sp, ss, sh),
// read through one block table.  Other arguments as flash_decode_paged.
extern "C" int flash_decode_paged_quant(
    const void* q, const void* k, const void* ks, const void* v, const void* vs,
    const void* lengths, const void* block_tables, void* out, void* part_o,
    void* part_ml, int dtype, int B, int Hk, int G, int pmax, int page_shift, int hd,
    int window, int chunk, long long q_sb, long long q_sh,
    long long k_sp, long long k_ss, long long k_sh, long long ks_sp, long long ks_ss,
    long long ks_sh, long long v_sp, long long v_ss, long long v_sh, long long vs_sp,
    long long vs_ss, long long vs_sh, long long o_sb, long long o_sh, float scale,
    void* stream) {
  if (page_shift < 0 || page_shift > 16 || pmax < 1) return (int)cudaErrorInvalidValue;
  const long long st[16] = {q_sb, q_sh, k_sp,  k_ss,  k_sh,  v_sp,  v_ss,  v_sh,
                            o_sb, o_sh, ks_sp, ks_ss, ks_sh, vs_sp, vs_ss, vs_sh};
  return dispatch<true>(q, k, v, ks, vs, lengths, out, part_o, part_ml, dtype, B, Hk, G,
                        pmax << page_shift, hd, window, chunk, st,
                        PagedRows{(const int*)block_tables, pmax, page_shift}, scale,
                        stream);
}

// The merge alone (the chunk kernels launch it themselves): part_o /
// part_ml as written by a chunk kernel over a cache of `cap` rows, out
// [B, 1, H, hd] in dtype with (row, head) strides.
extern "C" int decode_merge(const void* part_o, const void* part_ml, const void* lengths,
                            void* out, int dtype, int B, int H, int hd, int cap,
                            int window, int chunk, long long o_sb, long long o_sh,
                            void* stream) {
  if (chunk < kBK || chunk % kBK) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const float* po = (const float*)part_o;
  const float* pml = (const float*)part_ml;
  const int* lens = (const int*)lengths;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_merge<float>(po, pml, lens, out, B, H, hd, cap, window, chunk,
                                    o_sb, o_sh, s);
  if (dtype == 1)
    return (int)launch_merge<__nv_bfloat16>(po, pml, lens, out, B, H, hd, cap, window,
                                            chunk, o_sb, o_sh, s);
  return (int)cudaErrorInvalidValue;
}
