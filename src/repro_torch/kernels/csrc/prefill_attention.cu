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
// What bounds it on the H100: operations, at the serving shapes.  A
// chunk of Sq rows against L valid keys does 4 * Sq * H * L * hd flops
// and must read 2 * L * Hk * hd cache elements, so the arithmetic
// intensity grows with Sq * G: the 160-token cold chunk at offset 3000
// (Qwen2.5-3B, 16/2/128) is 4.04 GFLOP against 4.5 MB with q and the
// output (bound 0.0041 ms by operations at 989 TFLOP/s, 0.0014 ms by
// bytes at 3.35 TB/s), and the 4 x 64-token resume batch 7.3 GFLOP
// against 16.5 MB (0.0074 vs 0.0049 ms): both are bound by operations.
//
// Which body runs which entry, by q's type:
//   entry                          bf16 q                       f32 q
//   flash_prefill[_paged]          prefill_tc_kernel (bf16)     flash_prefill_kernel
//   flash_prefill[_paged]_quant    prefill_tc_kernel (int8)     flash_prefill_kernel (int8)
//
// bf16 q (`prefill_tc_kernel`): the products run on the tensor cores.
//   * one block per (query tile, KV head, row m, split) and one
//     warpgroup per block; its 64-row M dimension folds the G query
//     heads of the KV head and qpt = 64 / G query positions, which is
//     wgmma's 64 rows: a spec-verify chunk (Sq 2..8) still fills a tile,
//     and each K/V tile is read once for the whole group;
//   * S = Q K^T is `wgmma.mma_async` m64n64k16 (bf16 in, f32
//     accumulate) with Q and the K tile in shared memory (K-major);
//     O += P V takes P from registers (the S accumulator, masked,
//     exponentiated and packed to bf16 in place: its fragment is the A
//     fragment) and V as it lies, [keys, hd] row-major, read MN-major
//     through wgmma's transpose bit, so no transpose copy;
//   * the online softmax (f32, NEG_INF = -1e30, max(l, 1e-30)) runs on
//     the accumulator fragments: a row's 64 scores sit in the 4 lanes
//     of a quad, so its max takes two shuffles and its sum none until
//     the end; scores are kept in log2 units (exp2);
//   * key tiles of 64 (kTcBK; the code also builds with 128): one page
//     at the default page size, S is one m64n64 accumulator (154
//     registers a thread at hd 128, no spills), and Q plus two 32 KB
//     stages (81 KB) fit two blocks on an SM, so one block's softmax
//     runs under the other's products.  Measured on an H100 (700 W), a
//     tile of 128 (two 64 KB stages, one block an SM) took 25.2 against
//     17.5 us of main kernel at the cold chunk below, 37.5 against 27.1
//     at the 4 x 64 resume batch, each at its best split count;
//   * K and V tiles arrive by TMA (`cp.async.bulk.tensor`, 4-D maps over
//     the cache [rows, S or page, Hk, hd] with its real strides, 128-byte
//     swizzle to match the wgmma descriptors, boxes of 64 columns: hd
//     128 takes two per tile) into a ring of two stages in dynamic shared
//     memory, completion on an mbarrier; thread 0 issues tile i + 2 as
//     soon as every warp is done with tile i, so a tile's load runs
//     under the previous tile's products.  Paged: thread 0 reads the
//     block table for the tile after next while the current one is
//     issued, and issues one box per (page, half) -- several per tile
//     for pages under 64 rows; a table entry naming the scratch page is
//     loaded like any other;
//   * the key range is split: a static count of splits (a function of
//     M, Sq, Hk, G, the cache's row capacity and the SM count, chosen by
//     the wrapper for at most two blocks per SM) divides each block's live
//     tile range [first, last] into consecutive shares.  A split writes
//     its f32 accumulator and its (m, l) to scratch; `prefill_merge_kernel`
//     combines the splits of each row in split order (no atomics: the
//     same inputs give the same bits).  With one split the main kernel
//     writes the output itself and no merge is launched.  The cold chunk
//     above runs 40 blocks unsplit, 240 with its 6 splits (a 7th would
//     put 16 blocks in a second wave).
//   * keys at or past lengths[m] in the last tile may hold anything: P is
//     0 there, and their V rows are zeroed in shared memory first, so a
//     NaN there cannot reach the output.
// This replaces, for bf16, the TPU kernels `flash_prefill_bhsd` and
// `flash_prefill_paged_bhsd`.
//
// int8 cache with bf16 q (the `_quant` entries; the same kernel, kQuant):
// every int8 value is exactly a bf16 value, and a key is f32(int8) *
// f32(scale) with one scale per (position, head), so the scales leave the
// sums: q . (Kq[j] ks[j]) = (q . Kq[j]) ks[j] and sum_j P[j] vs[j] Vq[j] =
// sum_j (P[j] vs[j]) Vq[j].  The body above runs on the int8 values with
// only its loads changed (this replaces `flash_prefill_quant_bhsd` and
// `flash_prefill_paged_quant_bhsd` for bf16):
//   * the int8 K and V tiles arrive by TMA: maps over the int8 value
//     leaves, boxes of 64 columns (64 bytes, unswizzled), into a ring of
//     two stages of 16 KB at hd 128, half a bf16 stage;
//   * the scales [.., Hk, 1] have a position stride of 2 Hk bytes and a
//     one-element box would be 2 bytes, both under TMA's 16-byte minimum:
//     thread t loads the scale of key t (K) or t - 64 (V) of each tile
//     with a plain load one tile ahead (paged: its table entry two tiles
//     ahead, so the two loads never wait on each other) and stores it to
//     shared memory as f32 with the tile;
//   * after the tile's mbarrier wait the warpgroup converts it into one
//     bf16 K/V pair in the 128-byte-swizzled layout the descriptors read
//     (chunk c of row r at c ^ (r % 8), as Q), exactly and with no
//     conversion instruction (byte permutes and a subtract, as
//     Vec16<int8_t>); a quarter warp reads 128 contiguous int8 bytes and
//     writes 8 distinct swizzled chunks, so neither side meets a bank
//     conflict.  Keys at or past lengths[m] convert to 0 and get scale 0,
//     so a NaN scale there (fresh memory) cannot reach the output.  Then
//     `fence.proxy.async` (generic stores are not visible to wgmma's async
//     proxy without it) and a barrier, and the int8 stage goes straight
//     back to TMA for the tile after next;
//   * S's column j is multiplied by ks[j] (f32) before the mask and the
//     softmax, and P's column j by vs[j] before P is packed to bf16 for
//     P V; the row sum l sums the unscaled P.  The only rounding the bf16
//     body lacks is bf16(P vs) in place of bf16(P);
//   * the same split plan and merge as the bf16 entries;
//   * occupancy as for bf16: Q 16 KB, the bf16 pair 32 KB, two int8
//     stages 32 KB and the scales (81 KB at hd 128) keep two blocks on an
//     SM.  The block's own warpgroup converts, between the wait and the
//     first wgmma, and the other block on the SM keeps the tensor cores
//     busy meanwhile; a converter warpgroup would add a third of the
//     block's registers and a hand-off barrier per tile for work of about
//     2.5 instructions a value.  At hd 64 an int8 row is 64 bytes, so the
//     unswizzled staging is the same at both head dims.
//
// f32 q (`flash_prefill_kernel`, all four entries): the products run on
// the CUDA cores in f32 (wgmma has no exact f32, and TF32 would break the
// f32 identity checks, which hold engine streams to the oracle within
// 1e-4, and the int8 ones, which hold card logits to the CPU's within
// 1e-3):
//   * the same block of 64 folded rows per (query tile, KV head, row m),
//     over key tiles of 32;
//   * both paths run the key loop over the live tiles [first, last]
//     only, computed as `_tile_bounds` does: past-causal, never-written
//     and below-window tiles are neither read nor computed, so bytes stay
//     O(valid length) instead of O(S_max);
//   * both read K and V in place from the model's [B, S_max, Hk, hd]
//     layout through strides, and an optional slot_idx[m] picks the
//     cache row, so a batched resume reads the shared cache without
//     gathering whole slot stripes;
//   * tiles move as 16-byte vectors, all of a tile's loads in flight
//     before the first is stored to shared memory (as f32).
// int8 cache with f32 q: the same body with int8 values C and f32 scales
// [.., Hk, 1].  Each thread's 16-byte vector holds 16 values of one key
// row, so it reads that row's scale (a scalar through the scale leaf's
// strides: the leaf's last dim is 1, so its rows are not 16-byte vectors)
// with the values, and the row is dequantised as f32(int8) * f32(scale)
// while it is stored to shared memory, as the TPU kernel does per tile.
// Paged layout: the same body with another row addressing (the `Rows`
// functor): logical row pos of row m lives at physical page
// bt[m, pos / page], row pos % page, of the [P_phys, page, Hk, hd]
// arena.  The tile bounds stay logical; each 16-byte vector finds its own
// page (one lookup serves K and V), so a 32-key tile may straddle pages
// of any power-of-two size.  The lookups run one tile ahead of the K/V
// loads that use them, so a table read never sits in front of a tile's
// loads.  A batched resume passes its M rows of the table (bt[slot_idx])
// instead of slot_idx.
#include <cuda.h>   // CUtensorMap (its encoder is fetched at run time)
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

// One 16-byte vector of C, unpacked to floats: 4 f32 or 16 int8 values.
template <typename T> struct Vec16;
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
  // (kV values of one key row: 4 f32 or 16 int8, so kVecs is 8 or 2 at
  // hd 128 and half that at hd 64); paged: pg[u] is its page in the tile
  // about to be loaded
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
// or the page stride).  f32 only (bf16 runs on the tensor cores:
// `dispatch_prefill`).  kQuant: int8 values with f32 scales ks/vs; else
// ks/vs are unused.
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
#undef REPRO_PREFILL_LAUNCH
  return (int)cudaErrorInvalidValue;
}


// ---------------------------------------------------------------------
// bf16 on the tensor cores (see the header)
// ---------------------------------------------------------------------

constexpr int kTcBK = 64;      // keys per tile
constexpr int kTcStages = 2;   // TMA ring depth
constexpr int kSwRow = 128;    // bytes of one 128-byte-swizzled row: 64 bf16
constexpr int kMaxSplits = 16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void st_shared16(uint32_t addr, uint4 x) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(x.x),
               "r"(x.y), "r"(x.z), "r"(x.w)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// spin until the barrier's phase `parity` has completed; a tile that
// never lands (a bad map) traps after ~2^24 tries instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries > (1u << 24)) __trap();
  }
}

// one box of a 4-D tensor map (coordinates innermost first) into shared
// memory; its bytes complete a transaction on the barrier
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (in 16-byte units), layout 1
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads across a wait
__device__ __forceinline__ void reg_fence(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64x64] (+)= A[64x16] B[16x64], A and B in shared memory, both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64x64] += A[64x16] B[16x64], A in registers (the m64k16 fragment: 4
// words of 2 bf16), B in shared memory MN-major (transpose bit set)
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// Where the boxes of a key tile come from, as (within, outer) coordinates
// of the cache's 4-D map [outer, rows, Hk, hd].  Slab: one box of kTcBK
// rows of cache row `slot`.  Paged: one box per page the tile covers
// (pages of fewer than kTcBK rows give several), pages read from the
// block table a tile ahead into pg[]; keys at or past the length read
// page 0 (never past the table's row).  page_of / in_page: where one
// key's row lives, for the int8 scales' plain loads.
struct TmaSlab {
  static constexpr bool kTable = false;
  static constexpr int kMaxBoxes = 1;
  __device__ __forceinline__ int box_rows() const { return kTcBK; }
  __device__ __forceinline__ int boxes() const { return 1; }
  __device__ __forceinline__ void pages(int row, int, int, int* pg) const { pg[0] = row; }
  __device__ __forceinline__ int within(int k0, int) const { return k0; }
  __device__ __forceinline__ int page_of(int row, int) const { return row; }
  __device__ __forceinline__ int in_page(int pos) const { return pos; }
};
struct TmaPaged {
  static constexpr bool kTable = true;
  static constexpr int kMaxBoxes = kTcBK / 8;   // the smallest page is 8 rows
  const int* bt;
  int pmax, shift;
  __device__ __forceinline__ int box_rows() const { return min(kTcBK, 1 << shift); }
  __device__ __forceinline__ int boxes() const { return kTcBK / box_rows(); }
  __device__ __forceinline__ int page_of(int row, int pos) const {
    return bt[(long long)row * pmax + (pos >> shift)];
  }
  __device__ __forceinline__ int in_page(int pos) const { return pos & ((1 << shift) - 1); }
  __device__ __forceinline__ void pages(int row, int k0, int len, int* pg) const {
#pragma unroll
    for (int b = 0; b < kMaxBoxes; ++b) {
      const int pos = k0 + b * box_rows();
      pg[b] = (b < boxes() && pos < len) ? page_of(row, pos) : 0;
    }
  }
  __device__ __forceinline__ int within(int k0, int b) const {
    return in_page(k0 + b * box_rows());
  }
};

__device__ __forceinline__ uint4 ld_shared16(uint32_t addr) {
  uint4 x;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x.x), "=r"(x.y), "=r"(x.z), "=r"(x.w)
               : "r"(addr)
               : "memory");
  return x;
}

// 16 int8 values -> 16 bf16 (lo: values 0-7, hi: 8-15), exactly: an
// integer of at most 8 bits is exact in bf16, so the top half of the
// float Vec16<int8_t> makes is the bf16 value, and one byte permute packs
// two of them
__device__ __forceinline__ void i8x16_bf16(const uint4& r, uint4& lo, uint4& hi) {
  float f[16];
  Vec16<int8_t>::unpack(r, f);
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    w[i] = __byte_perm(__float_as_uint(f[2 * i]), __float_as_uint(f[2 * i + 1]), 0x7632u);
  lo = make_uint4(w[0], w[1], w[2], w[3]);
  hi = make_uint4(w[4], w[5], w[6], w[7]);
}

template <int HD, bool kQuant>
constexpr int tc_smem_bytes() {
  // Q; bf16: kTcStages x (K, V), each HD / 64 halves of 64-column rows;
  // int8: the bf16 (K, V) pair the tiles are converted into, kTcStages x
  // int8 (K, V) of HD / 64 halves of 64-byte rows, and 2 x kTcBK f32
  // scales; the barriers; slack to align the base to 1024 bytes (the
  // swizzle atom)
  constexpr int pair = 2 * (HD / 64) * kTcBK * kSwRow;
  constexpr int ring = kQuant ? pair + kTcStages * 2 * (HD / 64) * kTcBK * 64 + 2 * kTcBK * 4
                              : kTcStages * pair;
  return (HD / 64) * 64 * kSwRow + ring + 8 * kTcStages + 1024;
}

// grid (query tiles * splits, Hk, M); block 128 (one warpgroup); dynamic
// shared memory tc_smem_bytes<HD, kQuant>().  kmap/vmap: the cache leaves
// as 4-D maps [outer, rows, Hk, hd] (slab: outer = cache row, rows =
// S_max; paged: outer = physical page, rows = page), boxes (64, 1,
// box_rows, 1); bf16: 128-byte swizzle; kQuant: int8 values, no swizzle,
// with scales ks/vs (bf16) at page_of(row, pos) * sp + in_page(pos) * ss +
// h * sh.  splits == 1: writes out [M, Sq, H, hd] (strides o_*); else
// split s writes its unnormalised f32 accumulator to part_o [splits, M,
// Sq, H, HD] and (m, l) to part_ml [splits, M, Sq, H, 2], m in log2 units
// (scores times scale_log2).
template <int HD, bool kQuant, typename Rows>
__global__ void __launch_bounds__(128, 1)
prefill_tc_kernel(const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ ks,
                  const __nv_bfloat16* __restrict__ vs, const int* __restrict__ slot_idx,
                  const int* __restrict__ q_offset, const int* __restrict__ lengths,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ part_o,
                  float* __restrict__ part_ml, int Sq, int G, int cap, int window,
                  int splits, long long q_sm, long long q_ss, long long q_sh,
                  long long o_sm, long long o_ss, long long o_sh, Rows addr,
                  long long ks_sp, long long ks_ss, long long ks_sh, long long vs_sp,
                  long long vs_ss, long long vs_sh, float scale_log2) {
  constexpr int kHalves = HD / 64;
  static_assert(kHalves == 1 || kHalves == 2, "hd must be 64 or 128");
  constexpr int kNB = kTcBK / 64;                     // 64-key score blocks
  static_assert(kNB == 1 || kNB == 2, "key tiles of 64 or 128");
  constexpr int kHalfBytes = kTcBK * kSwRow;          // one half of a bf16 K or V tile
  constexpr int kQBytes = kHalves * 64 * kSwRow;
  constexpr int kPairBytes = 2 * kHalves * kHalfBytes;
  constexpr int kBoxRow = kQuant ? 64 : kSwRow;       // bytes of a box row in the ring
  constexpr int kStageBytes = 2 * kHalves * kTcBK * kBoxRow;
  extern __shared__ unsigned char tc_smem[];
  const uint32_t raw = smem_u32(tc_smem);
  const uint32_t q_s = (raw + 1023u) & ~1023u;
  // bf16: wgmma reads the ring's stages; int8: the ring holds the int8
  // tiles, converted into the one bf16 pair after Q, and the scales
  const uint32_t ring0 = q_s + kQBytes + (kQuant ? kPairBytes : 0);
  const uint32_t sc_s = ring0 + kTcStages * kStageBytes;
  const uint32_t bar0 = sc_s + (kQuant ? 2 * kTcBK * 4 : 0);
  float* sc = reinterpret_cast<float*>(tc_smem + (sc_s - raw));   // K, then V scales
  auto ring_k = [&](int st, int hf) { return ring0 + st * kStageBytes + hf * kTcBK * kBoxRow; };
  auto ring_v = [&](int st, int hf) {
    return ring0 + st * kStageBytes + (kHalves + hf) * kTcBK * kBoxRow;
  };
  auto k_tile = [&](int st, int hf) {
    return kQuant ? q_s + kQBytes + hf * kHalfBytes : ring_k(st, hf);
  };
  auto v_tile = [&](int st, int hf) {
    return kQuant ? q_s + kQBytes + (kHalves + hf) * kHalfBytes : ring_v(st, hf);
  };

  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int qt = blockIdx.x / splits, sp = blockIdx.x % splits;
  const int h = blockIdx.y, m = blockIdx.z, M = gridDim.z;
  const int H = gridDim.y * G;
  const int qpt = 64 / G, rows = qpt * G;
  const int qoff = q_offset[m];
  const int len = min(lengths[m], cap);
  const int i_lo = qt * qpt, i_hi = min(i_lo + qpt, Sq);
  // live tiles as `_tile_bounds`, then this split's consecutive share
  const int limit = min(len, qoff + i_hi);
  const int last = (limit + kTcBK - 1) / kTcBK - 1;
  int first = 0;
  if (window > 0) first = min(max(qoff + i_lo - window + 1, 0) / kTcBK, last);
  const int live = last >= 0 ? last - first + 1 : 0;
  const int t_lo = first + (int)((long long)live * sp / splits);
  const int n_tiles = first + (int)((long long)live * (sp + 1) / splits) - t_lo;
  const int row = Rows::kTable ? m : (slot_idx ? slot_idx[m] : m);

  if (t == 0) {
#pragma unroll
    for (int st = 0; st < kTcStages; ++st) mbar_init(bar0 + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0: tile it of this share into stage it % kTcStages, its pages in pg
  const CUtensorMap* km = &kmap;
  const CUtensorMap* vm = &vmap;
  int pg[Rows::kMaxBoxes];
  auto issue = [&](int it) {
    const int st = it % kTcStages, k0 = (t_lo + it) * kTcBK;
    const uint32_t bar = bar0 + 8 * st;
    mbar_expect_tx(bar, kStageBytes);
#pragma unroll
    for (int b = 0; b < Rows::kMaxBoxes; ++b) {
      if (b < addr.boxes()) {
        const int w = addr.within(k0, b);
        const uint32_t off = b * addr.box_rows() * kBoxRow;
#pragma unroll
        for (int hf = 0; hf < kHalves; ++hf) {
          tma_load_4d(ring_k(st, hf) + off, km, bar, hf * 64, h, w, pg[b]);
          tma_load_4d(ring_v(st, hf) + off, vm, bar, hf * 64, h, w, pg[b]);
        }
      }
    }
  };
  if (t == 0) {
    for (int it = 0; it < kTcStages && it < n_tiles; ++it) {
      addr.pages(row, (t_lo + it) * kTcBK, len, pg);
      issue(it);
    }
    if (kTcStages < n_tiles) addr.pages(row, (t_lo + kTcStages) * kTcBK, len, pg);
  }

  // int8: scale j = t + 128 u of a tile is the K scale of key j (j <
  // kTcBK) or the V scale of key j - kTcBK; loaded a tile ahead into
  // sc_r, its page two tiles ahead into sc_pg; 0 at or past the length
  constexpr int kScPer = kQuant ? 2 * kTcBK / 128 : 1;
  float sc_r[kScPer];
  int sc_pg[kScPer];
  auto sc_pages = [&](int it) {
#pragma unroll
    for (int u = 0; u < kScPer; ++u) {
      const int pos = (t_lo + it) * kTcBK + (t + 128 * u) % kTcBK;
      sc_pg[u] = (it < n_tiles && pos < len) ? addr.page_of(row, pos) : 0;
    }
  };
  auto sc_loads = [&](int it) {
#pragma unroll
    for (int u = 0; u < kScPer; ++u) {
      const int j = t + 128 * u, pos = (t_lo + it) * kTcBK + j % kTcBK;
      const bool is_v = j >= kTcBK;
      const long long off = sc_pg[u] * (is_v ? vs_sp : ks_sp) +
                            addr.in_page(pos) * (is_v ? vs_ss : ks_ss) +
                            h * (is_v ? vs_sh : ks_sh);
      sc_r[u] = (it < n_tiles && pos < len) ? to_f((is_v ? vs : ks)[off]) : 0.f;
    }
  };
  if constexpr (kQuant) {
    sc_pages(0);
    sc_loads(0);
    sc_pages(1);
  }

  // Q: 64 folded rows, 16-byte chunks stored with the 128-byte swizzle
  // (chunk c of a row at c ^ (row % 8)), zero past the tile's rows
#pragma unroll
  for (int u = 0; u < HD / 16; ++u) {
    const int c = t + u * 128;
    const int r = c / (HD / 8), ch = c % (HD / 8);
    const int i = i_lo + r / G, g = r % G;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows && i < Sq)
      x = *reinterpret_cast<const uint4*>(q + m * q_sm + i * q_ss +
                                          (long long)(h * G + g) * q_sh + ch * 8);
    st_shared16(q_s + (ch / 8) * 64 * kSwRow + r * kSwRow + (((ch % 8) ^ (r & 7)) << 4), x);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // this thread's two rows of the accumulators: warp * 16 + lane / 4 (+8)
  const int quad = lane >> 2, t4 = lane & 3;
  int k_hi[2], k_lo[2];
  bool row_ok[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = warp * 16 + quad + 8 * j, i = i_lo + r / G;
    row_ok[j] = r < rows && i < Sq;
    const int q_pos = qoff + i;
    k_hi[j] = row_ok[j] ? min(len, q_pos + 1) : 0;         // exclusive
    k_lo[j] = window > 0 ? q_pos - window + 1 : 0;          // inclusive
  }
  float o[kHalves][32];
#pragma unroll
  for (int hf = 0; hf < kHalves; ++hf)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[hf][e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kTcStages, k0 = (t_lo + it) * kTcBK;
    mbar_wait(bar0 + 8 * st, (it / kTcStages) & 1);

    if constexpr (kQuant) {
      // int8 -> the bf16 pair.  16-byte chunk x = t + 128 u of the K (and
      // of the V) tile: half x / (4 kTcBK), row (x / 4) % kTcBK, chunk x %
      // 4, whose 16 values become bf16 chunks 2c and 2c + 1 of the
      // swizzled row; rows at or past the length become 0
      constexpr int kCh = kHalves * kTcBK * 4 / 128;
      uint4 kr[kCh], vr[kCh];
#pragma unroll
      for (int u = 0; u < kCh; ++u) {
        const int x = t + 128 * u, hf = x / (4 * kTcBK), rr = (x / 4) % kTcBK;
        kr[u] = ld_shared16(ring_k(st, hf) + rr * 64 + (x % 4) * 16);
        vr[u] = ld_shared16(ring_v(st, hf) + rr * 64 + (x % 4) * 16);
      }
#pragma unroll
      for (int u = 0; u < kCh; ++u) {
        const int x = t + 128 * u, hf = x / (4 * kTcBK), rr = (x / 4) % kTcBK, c = x % 4;
        const bool ok = k0 + rr < len;
        const uint32_t c0 = rr * kSwRow + (((2 * c) ^ (rr & 7)) << 4);
        const uint32_t c1 = rr * kSwRow + (((2 * c + 1) ^ (rr & 7)) << 4);
        const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
        uint4 lo, hi;
        i8x16_bf16(kr[u], lo, hi);
        st_shared16(k_tile(st, hf) + c0, ok ? lo : zero);
        st_shared16(k_tile(st, hf) + c1, ok ? hi : zero);
        i8x16_bf16(vr[u], lo, hi);
        st_shared16(v_tile(st, hf) + c0, ok ? lo : zero);
        st_shared16(v_tile(st, hf) + c1, ok ? hi : zero);
      }
#pragma unroll
      for (int u = 0; u < kScPer; ++u) sc[t + 128 * u] = sc_r[u];
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();                    // the pair is written, stage st free
      if (t == 0 && it + kTcStages < n_tiles) {
        issue(it + kTcStages);
        if (it + kTcStages + 1 < n_tiles)
          addr.pages(row, (t_lo + it + kTcStages + 1) * kTcBK, len, pg);
      }
      sc_loads(it + 1);
      sc_pages(it + 2);
    }

    // S = Q K^T: HD / 16 steps of 16 columns, 32 bytes into a swizzled row
    // (one m64n64 accumulator per 64 keys of the tile)
    float s[kNB][32];
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int e = 0; e < 32; ++e) s[nb][e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t a = q_s + (kk / 4) * 64 * kSwRow + (kk % 4) * 32;
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) {
        const uint32_t b = k_tile(st, kk / 4) + nb * 64 * kSwRow + (kk % 4) * 32;
        wgmma_ss(s[nb], sw128_desc(a, 16, 1024), sw128_desc(b, 16, 1024), kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) reg_fence(s[nb]);

    // mask per element; accumulator element e of s[nb] is row
    // (e & 2 ? 8 : 0) + quad, column nb * 64 + (e / 4) * 8 + 2 * t4 + (e & 1);
    // int8: the column's key scale multiplies the score first
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int j = (e >> 1) & 1, col = nb * 64 + (e / 4) * 8 + 2 * t4 + (e & 1);
        const int kp = k0 + col;
        const float f = kQuant ? sc[col] * scale_log2 : scale_log2;
        s[nb][e] = (kp < k_hi[j] && kp >= k_lo[j]) ? s[nb][e] * f : kNegInf;
        mx[j] = fmaxf(mx[j], s[nb][e]);
      }
    float corr[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
      const float m_new = fmaxf(m_r[j], mx[j]);
      corr[j] = exp2f(m_r[j] - m_new);
      m_r[j] = m_new;
      l_r[j] *= corr[j];
    }
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int j = (e >> 1) & 1;
        s[nb][e] = exp2f(s[nb][e] - m_r[j]);
        l_r[j] += s[nb][e];
      }

    if constexpr (kQuant) {
      // l summed the unscaled P; P V takes P times the column's V scale
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
        for (int e = 0; e < 32; ++e)
          s[nb][e] *= sc[kTcBK + nb * 64 + (e / 4) * 8 + 2 * t4 + (e & 1)];
    } else if (k0 + kTcBK > len) {
      // rows at or past the length: zero their V rows (a whole 128-byte
      // row, whatever the swizzle) so 0 * garbage cannot make a NaN
      for (int c = t; c < kHalves * kTcBK * 8; c += 128) {
        const int hf = c / (kTcBK * 8), rr = (c / 8) % kTcBK;
        if (k0 + rr >= len)
          st_shared16(v_tile(st, hf) + rr * kSwRow + (c % 8) * 16, make_uint4(0u, 0u, 0u, 0u));
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }

    // O = O * corr + P V: P's accumulator fragment is its A fragment
#pragma unroll
    for (int hf = 0; hf < kHalves; ++hf)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[hf][e] *= corr[(e >> 1) & 1];
    uint32_t pa[kTcBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) {
      const float* p = s[kk / 4] + 8 * (kk % 4);
      pa[kk][0] = pack_bf16(p[0], p[1]);
      pa[kk][1] = pack_bf16(p[2], p[3]);
      pa[kk][2] = pack_bf16(p[4], p[5]);
      pa[kk][3] = pack_bf16(p[6], p[7]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk)
#pragma unroll
      for (int hf = 0; hf < kHalves; ++hf)
        // 16 keys = two 8-row groups 1024 bytes apart; one 64-column atom
        wgmma_rs_tb(o[hf], pa[kk],
                    sw128_desc(v_tile(st, hf) + kk * 16 * kSwRow, 1024, 1024));
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int hf = 0; hf < kHalves; ++hf) reg_fence(o[hf]);

    __syncthreads();                      // every warp is done with stage st
    if (!kQuant && t == 0 && it + kTcStages < n_tiles) {
      issue(it + kTcStages);
      if (it + kTcStages + 1 < n_tiles)
        addr.pages(row, (t_lo + it + kTcStages + 1) * kTcBK, len, pg);
    }
  }

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l_r[j] += __shfl_xor_sync(0xffffffffu, l_r[j], 1);
    l_r[j] += __shfl_xor_sync(0xffffffffu, l_r[j], 2);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (!row_ok[j]) continue;
    const int r = warp * 16 + quad + 8 * j, i = i_lo + r / G, head = h * G + r % G;
    if (splits == 1) {
      const float inv = 1.f / fmaxf(l_r[j], 1e-30f);
      __nv_bfloat16* orow = out + m * o_sm + i * o_ss + (long long)head * o_sh;
#pragma unroll
      for (int hf = 0; hf < kHalves; ++hf)
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const int e = nb * 4 + 2 * j;
          *reinterpret_cast<__nv_bfloat162*>(orow + hf * 64 + nb * 8 + 2 * t4) =
              __floats2bfloat162_rn(o[hf][e] * inv, o[hf][e + 1] * inv);
        }
    } else {
      const long long prow = (((long long)sp * M + m) * Sq + i) * H + head;
      float* po = part_o + prow * HD;
#pragma unroll
      for (int hf = 0; hf < kHalves; ++hf)
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const int e = nb * 4 + 2 * j;
          *reinterpret_cast<float2*>(po + hf * 64 + nb * 8 + 2 * t4) =
              make_float2(o[hf][e], o[hf][e + 1]);
        }
      if (t4 == 0)
        *reinterpret_cast<float2*>(part_ml + 2 * prow) = make_float2(m_r[j], l_r[j]);
    }
  }
}

// Combines the splits of each output row in split order: with
// mx = max_s m_s and w_s = 2^(m_s - mx), out = sum_s w_s acc_s /
// max(sum_s w_s l_s, 1e-30), written in T.  grid (ceil(rows / 4)); block
// 128, one warp per row of [M, Sq, H], HD / 32 columns per lane.
template <typename T, int HD>
__global__ void __launch_bounds__(128)
prefill_merge_kernel(const float* __restrict__ part_o, const float* __restrict__ part_ml,
                     T* __restrict__ out, int n_rows, int Sq, int H, int splits,
                     long long o_sm, long long o_ss, long long o_sh) {
  constexpr int kC = HD / 32;
  const int r = blockIdx.x * 4 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (r >= n_rows) return;
  float mx = kNegInf;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, part_ml[2 * ((long long)s * n_rows + r)]);
  float acc[kC], den = 0.f;
#pragma unroll
  for (int c = 0; c < kC; ++c) acc[c] = 0.f;
  for (int s = 0; s < splits; ++s) {
    const long long pr = (long long)s * n_rows + r;
    const float2 ml = *reinterpret_cast<const float2*>(part_ml + 2 * pr);
    const float w = exp2f(ml.x - mx);
    den += w * ml.y;
    const float* po = part_o + pr * HD + lane * kC;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[c] += w * po[c];
  }
  const float inv = 1.f / fmaxf(den, 1e-30f);
  const int m = r / (Sq * H), i = (r / H) % Sq, head = r % H;
  T* orow = out + m * o_sm + i * o_ss + (long long)head * o_sh + lane * kC;
#pragma unroll
  for (int c = 0; c < kC; ++c) orow[c] = from_f<T>(acc[c] * inv);
}

template <int HD>
cudaError_t launch_merge(const float* part_o, const float* part_ml, void* out, int dtype,
                         int M, int Sq, int H, int splits, long long o_sm, long long o_ss,
                         long long o_sh, cudaStream_t stream) {
  const int n_rows = M * Sq * H;
  const dim3 grid((n_rows + 3) / 4);
  if (dtype == 0)
    prefill_merge_kernel<float, HD><<<grid, 128, 0, stream>>>(
        part_o, part_ml, (float*)out, n_rows, Sq, H, splits, o_sm, o_ss, o_sh);
  else
    prefill_merge_kernel<__nv_bfloat16, HD><<<grid, 128, 0, stream>>>(
        part_o, part_ml, (__nv_bfloat16*)out, n_rows, Sq, H, splits, o_sm, o_ss, o_sh);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled is a driver-API call; the runtime hands out its
// address, so the library needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A cache leaf [outer, rows, Hk, hd] (strides in elements, unit on hd)
// as a 4-D tensor map with boxes of (64 columns, 1 head, box_rows rows, 1
// outer): bf16 with the 128-byte swizzle that the wgmma descriptors read,
// or int8 unswizzled (64-byte box rows, converted in shared memory).  TMA
// needs a 16-byte-aligned base and strides that are multiples of 16 bytes
// (the wrapper checks both); keys past `rows` read as zeros.
cudaError_t encode_cache(CUtensorMap* map, const void* base, bool int8, int outer, int rows,
                         int Hk, int hd, long long s_outer, long long s_row,
                         long long s_head, int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  const int es = int8 ? 1 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)Hk, (cuuint64_t)rows,
                              (cuuint64_t)outer};
  const cuuint64_t strides[3] = {(cuuint64_t)(s_head * es), (cuuint64_t)(s_row * es),
                                 (cuuint64_t)(s_outer * es)};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r =
      fn(map, int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
         const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
         int8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The bf16 path of every entry: the maps of k and v, then the main kernel
// and, with more than one split, the merge.  st as `dispatch`; kQuant:
// int8 k/v with bf16 scales ks/vs; rows/outer: the maps' row and outer
// extents; box_rows: rows per box.
template <int HD, bool kQuant, typename Rows>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const void* ks,
                      const void* vs, const int* slot_idx, const int* q_offset,
                      const int* lengths, void* out, float* part_o, float* part_ml, int M,
                      int Sq, int Hk, int G, int cap, int window, int splits, int outer,
                      int rows, int box_rows, const long long* st, Rows addr, float scale,
                      cudaStream_t stream) {
  CUtensorMap kmap, vmap;
  cudaError_t e =
      encode_cache(&kmap, k, kQuant, outer, rows, Hk, HD, st[3], st[4], st[5], box_rows);
  if (e != cudaSuccess) return e;
  e = encode_cache(&vmap, v, kQuant, outer, rows, Hk, HD, st[6], st[7], st[8], box_rows);
  if (e != cudaSuccess) return e;
  constexpr int bytes = tc_smem_bytes<HD, kQuant>();
  static bool configured = false;
  if (!configured) {
    e = cudaFuncSetAttribute(prefill_tc_kernel<HD, kQuant, Rows>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int qpt = kBM / G;
  const dim3 grid(((Sq + qpt - 1) / qpt) * splits, Hk, M);
  prefill_tc_kernel<HD, kQuant, Rows><<<grid, 128, bytes, stream>>>(
      kmap, vmap, (const __nv_bfloat16*)q, (const __nv_bfloat16*)ks,
      (const __nv_bfloat16*)vs, slot_idx, q_offset, lengths, (__nv_bfloat16*)out, part_o,
      part_ml, Sq, G, cap, window, splits, st[0], st[1], st[2], st[9], st[10], st[11], addr,
      st[12], st[13], st[14], st[15], st[16], st[17], scale * 1.4426950408889634f);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  return launch_merge<HD>(part_o, part_ml, out, 1, M, Sq, Hk * G, splits, st[9], st[10],
                          st[11], stream);
}

// dtype 1 (bf16) goes to the tensor cores, dtype 0 (f32) to the CUDA-core
// body; splits > 1 only for bf16, with scratch part_o/part_ml.  kQuant:
// int8 values k/v with scales ks/vs in q's type.
template <bool kQuant, typename TcRows, typename Rows>
int dispatch_prefill(const void* q, const void* k, const void* v, const void* ks,
                     const void* vs, const void* slot_idx, const void* q_offset,
                     const void* lengths, void* out, void* part_o, void* part_ml, int dtype,
                     int M, int Sq, int Hk, int G, int cap, int hd, int window, int splits,
                     int outer, int rows, int box_rows, const long long* st, TcRows tc_addr,
                     Rows addr, float scale, void* stream) {
  if (dtype != 1)
    return splits == 1 ? dispatch<kQuant>(q, k, v, ks, vs, slot_idx, q_offset, lengths, out,
                                          dtype, M, Sq, Hk, G, cap, hd, window, st, addr,
                                          scale, stream)
                       : (int)cudaErrorInvalidValue;
  if (G < 1 || G > kBM || splits < 1 || splits > kMaxSplits ||
      (splits > 1 && (part_o == nullptr || part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (M == 0 || Sq == 0) return 0;
  const int* si = (const int*)slot_idx;
  const int* qo = (const int*)q_offset;
  const int* ln = (const int*)lengths;
  cudaStream_t s = (cudaStream_t)stream;
  if (hd == 128)
    return (int)launch_tc<128, kQuant>(q, k, v, ks, vs, si, qo, ln, out, (float*)part_o,
                                       (float*)part_ml, M, Sq, Hk, G, cap, window, splits,
                                       outer, rows, box_rows, st, tc_addr, scale, s);
  if (hd == 64)
    return (int)launch_tc<64, kQuant>(q, k, v, ks, vs, si, qo, ln, out, (float*)part_o,
                                      (float*)part_ml, M, Sq, Hk, G, cap, window, splits,
                                      outer, rows, box_rows, st, tc_addr, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  slot_idx may be null (row m reads
// cache row m).  Slab cache k/v [B, S, Hk, hd].  strides: q (sm, ss, sh),
// k (sb, ss, sh), v (sb, ss, sh), out (sm, ss, sh), in elements.  splits:
// the key-range splits (bf16 only; 1 for f32), with f32 scratch part_o
// [splits, M, Sq, H, hd] and part_ml [splits, M, Sq, H, 2] when above 1
// (else null).  Returns the first failing launch's cudaError_t.
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             const void* slot_idx, const void* q_offset,
                             const void* lengths, void* out, void* part_o,
                             void* part_ml, int dtype, int M, int Sq, int Hk, int G,
                             int S, int hd, int window, int B, int splits,
                             long long q_sm, long long q_ss, long long q_sh,
                             long long k_sb, long long k_ss, long long k_sh,
                             long long v_sb, long long v_ss, long long v_sh,
                             long long o_sm, long long o_ss, long long o_sh,
                             float scale, void* stream) {
  const long long st[18] = {q_sm, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                            o_sm, o_ss, o_sh, 0,    0,    0,    0,    0,    0};
  return dispatch_prefill<false>(q, k, v, nullptr, nullptr, slot_idx, q_offset, lengths,
                                 out, part_o, part_ml, dtype, M, Sq, Hk, G, S, hd, window,
                                 splits, B, S, kTcBK, st, TmaSlab{}, SlabRows{}, scale,
                                 stream);
}

// Paged arena k/v [P_phys, page, Hk, hd] with strides (sp, ss, sh);
// block_tables [M, pmax] int32 physical page ids, row m for query row m;
// page = 1 << page_shift.  Other arguments as flash_prefill.
extern "C" int flash_prefill_paged(const void* q, const void* k, const void* v,
                                   const void* block_tables, const void* q_offset,
                                   const void* lengths, void* out, void* part_o,
                                   void* part_ml, int dtype, int M, int Sq, int Hk, int G,
                                   int pmax, int page_shift, int hd, int window, int P,
                                   int splits, long long q_sm, long long q_ss,
                                   long long q_sh, long long k_sp, long long k_ss,
                                   long long k_sh, long long v_sp, long long v_ss,
                                   long long v_sh, long long o_sm, long long o_ss,
                                   long long o_sh, float scale, void* stream) {
  if (page_shift < 3 || page_shift > 16 || pmax < 1) return (int)cudaErrorInvalidValue;
  const long long st[18] = {q_sm, q_ss, q_sh, k_sp, k_ss, k_sh, v_sp, v_ss, v_sh,
                            o_sm, o_ss, o_sh, 0,    0,    0,    0,    0,    0};
  const int* bt = (const int*)block_tables;
  return dispatch_prefill<false>(
      q, k, v, nullptr, nullptr, nullptr, q_offset, lengths, out, part_o, part_ml, dtype, M,
      Sq, Hk, G, pmax << page_shift, hd, window, splits, P, 1 << page_shift,
      (1 << page_shift) < kTcBK ? 1 << page_shift : kTcBK, st,
      TmaPaged{bt, pmax, page_shift}, PagedRows{bt, pmax, page_shift}, scale, stream);
}

// The merge of the bf16 entries alone: part_o [splits, M, Sq, H, hd] and
// part_ml [splits, M, Sq, H, 2] (f32, m in log2 units) -> out (dtype, as
// flash_prefill; strides sm, ss, sh).
extern "C" int prefill_merge(const void* part_o, const void* part_ml, void* out, int dtype,
                             int M, int Sq, int H, int hd, int splits, long long o_sm,
                             long long o_ss, long long o_sh, void* stream) {
  if (splits < 1 || M * Sq * H == 0) return splits < 1 ? (int)cudaErrorInvalidValue : 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (hd == 128)
    return (int)launch_merge<128>((const float*)part_o, (const float*)part_ml, out, dtype,
                                  M, Sq, H, splits, o_sm, o_ss, o_sh, s);
  if (hd == 64)
    return (int)launch_merge<64>((const float*)part_o, (const float*)part_ml, out, dtype,
                                 M, Sq, H, splits, o_sm, o_ss, o_sh, s);
  return (int)cudaErrorInvalidValue;
}

// int8 slab cache: values k/v int8 [B, S, Hk, hd] with strides (sb, ss,
// sh), scales ks/vs [B, S, Hk, 1] in q's type with strides (sb, ss, sh).
// Other arguments (splits and scratch included) as flash_prefill.
extern "C" int flash_prefill_quant(const void* q, const void* k, const void* ks,
                                   const void* v, const void* vs, const void* slot_idx,
                                   const void* q_offset, const void* lengths, void* out,
                                   void* part_o, void* part_ml, int dtype, int M, int Sq,
                                   int Hk, int G, int S, int hd, int window, int B,
                                   int splits, long long q_sm, long long q_ss,
                                   long long q_sh, long long k_sb, long long k_ss,
                                   long long k_sh, long long ks_sb, long long ks_ss,
                                   long long ks_sh, long long v_sb, long long v_ss,
                                   long long v_sh, long long vs_sb, long long vs_ss,
                                   long long vs_sh, long long o_sm, long long o_ss,
                                   long long o_sh, float scale, void* stream) {
  const long long st[18] = {q_sm,  q_ss,  q_sh,  k_sb,  k_ss,  k_sh,
                            v_sb,  v_ss,  v_sh,  o_sm,  o_ss,  o_sh,
                            ks_sb, ks_ss, ks_sh, vs_sb, vs_ss, vs_sh};
  return dispatch_prefill<true>(q, k, v, ks, vs, slot_idx, q_offset, lengths, out, part_o,
                                part_ml, dtype, M, Sq, Hk, G, S, hd, window, splits, B, S,
                                kTcBK, st, TmaSlab{}, SlabRows{}, scale, stream);
}

// int8 paged arenas: values k/v int8 [P_phys, page, Hk, hd] and scales
// ks/vs [P_phys, page, Hk, 1] in q's type, each with strides (sp, ss, sh),
// read through one block table.  Other arguments as flash_prefill_paged.
extern "C" int flash_prefill_paged_quant(
    const void* q, const void* k, const void* ks, const void* v, const void* vs,
    const void* block_tables, const void* q_offset, const void* lengths, void* out,
    void* part_o, void* part_ml, int dtype, int M, int Sq, int Hk, int G, int pmax,
    int page_shift, int hd, int window, int P, int splits, long long q_sm, long long q_ss,
    long long q_sh, long long k_sp, long long k_ss, long long k_sh, long long ks_sp,
    long long ks_ss, long long ks_sh, long long v_sp, long long v_ss, long long v_sh,
    long long vs_sp, long long vs_ss, long long vs_sh, long long o_sm, long long o_ss,
    long long o_sh, float scale, void* stream) {
  if (page_shift < 3 || page_shift > 16 || pmax < 1) return (int)cudaErrorInvalidValue;
  const long long st[18] = {q_sm,  q_ss,  q_sh,  k_sp,  k_ss,  k_sh,
                            v_sp,  v_ss,  v_sh,  o_sm,  o_ss,  o_sh,
                            ks_sp, ks_ss, ks_sh, vs_sp, vs_ss, vs_sh};
  const int* bt = (const int*)block_tables;
  return dispatch_prefill<true>(
      q, k, v, ks, vs, nullptr, q_offset, lengths, out, part_o, part_ml, dtype, M, Sq, Hk,
      G, pmax << page_shift, hd, window, splits, P, 1 << page_shift,
      (1 << page_shift) < kTcBK ? 1 << page_shift : kTcBK, st,
      TmaPaged{bt, pmax, page_shift}, PagedRows{bt, pmax, page_shift}, scale, stream);
}
