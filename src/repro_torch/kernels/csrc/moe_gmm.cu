// MoE grouped matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm.py `gmm_bcd`
// (`_gmm_kernel`, entry `moe_gmm`).  Same function: E independent
// products out[e] = x[e] @ w[e], x [E, C, d], w [E, d, f] -> out [E, C, f],
// accumulated in f32 and written in x's type (f32 or bf16).  The TPU
// wrapper pads C, d and f to its block sizes; here the ragged edges are
// zero-filled on load and guarded on store.  x is read through its
// strides, so the MoE layer's dense mode passes the broadcast view
// x2d.expand(E, T, d) (expert stride 0) without a copy.
//
// What bounds it on the H100: bytes.  At OLMoE widths (E 64, d 2048, f
// 1024) a call reads 268 MB of weights (0.080 ms at 3.35 TB/s), and its
// 2ECdf flops stay under that time up to C ~ 295 rows (the card's ~295
// flop/byte ridge).  The serving calls have C = 1 (gmm decode), 6 (dense
// decode), 25 and 40 (gmm chunk, gmm resume batch), 160 and 256 (dense
// chunk, dense resume batch): every one sits at or under the ridge.
//
// bf16 (`gmm_tc_kernel`, entry `moe_gmm_tc`): the products run on the
// tensor cores, and each weight byte is read from device memory once per
// call up to C = 256.
//   * a work tile is (128 columns of f, expert): its block runs every row
//     of the call against each weight tile it loads.  The rows form
//     C-tiles of 64 (wgmma's M), up to 4 of them (256 rows) in one row
//     group; above 256 rows the block walks the row groups in turn (the
//     C-tiles shared evenly) and reads its weights once per group;
//   * persistent blocks, one an SM, take the work tiles in turn (512 at
//     OLMoE's up/gate, 1024 at its down product);
//   * 384 threads: a producer warpgroup, whose thread 0 issues TMA loads
//     into a ring of stages (mbarriers `full` and `empty`) without a
//     break between work tiles, and two consumer warpgroups, one per
//     64-column half of the tile.  `setmaxnreg` moves the producer's
//     registers to the consumers (40 / 232 a thread);
//   * a stage holds the x rows of the group over 64 of d (128 bytes, the
//     128-byte swizzle: one box of [64, rows]) and the weight tile [64 of
//     d, 128 of f] as two boxes of [64, 64]; x is A (K-major), the weight
//     half is B read MN-major through wgmma's transpose bit, so neither
//     is copied or transposed.  3 stages for one C-tile, 4 for more
//     (`tc_stages` in moe_gmm.py: the fastest on an H100 at OLMoE's
//     widths; more stages read the weights no faster);
//   * `wgmma.mma_async` m64n64k16, bf16 in, f32 out: each C-tile's
//     product over a stage (4 k16 steps) starts from zero and is then
//     added to an f32 accumulator held in registers (32 a C-tile), one
//     C-tile's product running while the previous one is added.  The
//     tensor cores' own adds truncate; kept inside 64 terms they leave
//     fewer bf16 outputs off the f64 product, rounded, than the plain f32
//     einsum does, where one wgmma chain over all of d (what torch.bmm
//     gives) leaves about five times as many (chip_smoke.py's parity_moe
//     phase prints the counts);
//   * rows past C and columns past d or f are zero-filled by TMA's
//     out-of-bounds fill; a C under 64 loads C rounded up to 8 rows, and
//     the rest of its C-tile (whatever the stage held) only reaches
//     output rows that are never stored;
//   * TMA takes no zero stride: x with expert stride 0 (or E = 1) is a
//     2-D map over its [C, d] tokens, otherwise a 3-D map [E, C, d], so a
//     ragged C-tile never reads the next expert's rows; w likewise;
//   * the d tiles and their k16 steps run in one order whatever C, the
//     row group or the grid, and there is no split over d: a row's output
//     does not depend on the other rows of the call (the same bits at any
//     C, and under a stride-0 view and its contiguous copy);
//   * the epilogue packs adjacent columns to bf16 pairs, stages a C-tile
//     through shared memory (rows 144 bytes apart: the pair stores fall
//     on 32 banks) and writes 16-byte vectors, rows past C skipped.
//   The tile plan (C-tiles of a row group, stages) comes from the caller
//   (`gmm_plan` in moe_gmm.py).
//
// f32 (`gmm_kernel`, entry `moe_gmm`): the products run on the CUDA cores
// (wgmma has no exact f32, and TF32 would break the f32 identity checks
// that hold engine streams to the oracle):
//   * one block per (f-tile, C-tile, expert), looping over d in tiles of
//     32; a C-tile covers all of a small C (8 rows when C <= 8, 32 when
//     C <= 32), so each weight is read from device memory once per call
//     up to C = 64;
//   * the x and w tiles stream into shared memory through a 3-stage
//     ring of 16-byte `cp.async` copies; out-of-range vectors are
//     zero-filled by the copy itself;
//   * each thread keeps a 4 x 4 f32 accumulator tile in registers.
//   Each output is one f32 FMA chain over d in order.
//
// Known limits: a decode call (C = 1 or 6) multiplies 58 or more padded
// rows of its 64-row C-tile (0.017 ms of tensor-core time at OLMoE
// widths, under the 0.080 ms byte floor); x is read again by each of an
// expert's f tiles (from L2); 512 work tiles on 132 SMs leave 16 SMs idle
// for the last round; above 256 rows the weights are read once per row
// group; experts that received no rows are still read; gate and up are
// two launches.
#include <cuda.h>   // CUtensorMap (its encoder is fetched at run time)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kBD = 32;       // contraction depth of one pipeline stage
constexpr int kStages = 3;    // cp.async ring depth
constexpr int kTC = 4;        // rows per thread
constexpr int kTF = 4;        // columns per thread

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;   // 0 source bytes: the 16 bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// one 16-byte vector of shared memory as floats
__device__ __forceinline__ void load_vec(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

// four consecutive values as floats
__device__ __forceinline__ void load4(const float* p, float* o) {
  load_vec(p, o);
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

template <typename T, int BC, int BF>
struct Tile {
  static constexpr int kThreads = (BC / kTC) * (BF / kTF);
  static constexpr int kVec = 16 / sizeof(T);     // elements per 16 bytes
  static constexpr int kXPitch = kBD + kVec;      // one vector of pad per x
  //                                                 row: the rows a warp
  //                                                 reads fall in other banks
  static constexpr int kXElems = BC * kXPitch;    // x tile, one stage
  static constexpr int kWElems = kBD * BF;        // w tile, one stage
  static constexpr size_t kSmem =
      kStages * (size_t)(kXElems + kWElems) * sizeof(T);
};

// grid (ceil(f / BF), ceil(C / BC), E); block Tile::kThreads threads
template <typename T, int BC, int BF>
__global__ void __launch_bounds__(Tile<T, BC, BF>::kThreads)
gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
           T* __restrict__ out, int C, int d, int f, long long sxe,
           long long sxc, long long swe, long long swd) {
  using Tl = Tile<T, BC, BF>;
  constexpr int NT = Tl::kThreads, VEC = Tl::kVec, XP = Tl::kXPitch;
  constexpr int XV = BC * (kBD / VEC);    // x vectors per stage
  constexpr int WV = kBD * (BF / VEC);    // w vectors per stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  T* ws = xs + kStages * Tl::kXElems;

  const int e = blockIdx.z;
  const int c0 = blockIdx.y * BC;
  const int f0 = blockIdx.x * BF;
  const int tid = threadIdx.x;
  const int tx = tid % (BF / kTF), ty = tid / (BF / kTF);
  const T* xe = x + e * sxe;
  const T* we = w + e * swe;
  const int ntiles = (d + kBD - 1) / kBD;

  // d and f are multiples of VEC (checked by the caller), so a vector is
  // either wholly inside the matrix or wholly outside
  auto load_tile = [&](int t, int stage) {
    const int k0 = t * kBD;
    T* xd = xs + stage * Tl::kXElems;
    T* wd = ws + stage * Tl::kWElems;
    for (int v = tid; v < XV; v += NT) {
      const int r = v / (kBD / VEC), kv = (v % (kBD / VEC)) * VEC;
      const bool ok = (c0 + r < C) && (k0 + kv < d);
      const T* src = ok ? xe + (long long)(c0 + r) * sxc + (k0 + kv) : x;
      cp_async16(xd + r * XP + kv, src, ok);
    }
    for (int v = tid; v < WV; v += NT) {
      const int kr = v / (BF / VEC), fv = (v % (BF / VEC)) * VEC;
      const bool ok = (k0 + kr < d) && (f0 + fv < f);
      const T* src = ok ? we + (long long)(k0 + kr) * swd + (f0 + fv) : w;
      cp_async16(wd + kr * BF + fv, src, ok);
    }
  };

  float acc[kTC][kTF];
#pragma unroll
  for (int i = 0; i < kTC; ++i)
#pragma unroll
    for (int q = 0; q < kTF; ++q) acc[i][q] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) load_tile(s, s);
    cp_async_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    // tile t has landed once at most kStages - 2 later groups are pending;
    // the barrier also retires every thread's reads of the stage that the
    // next copy overwrites (tile t - 1's)
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nt = t + kStages - 1;
    if (nt < ntiles) load_tile(nt, nt % kStages);
    cp_async_commit();
    const T* xt = xs + (t % kStages) * Tl::kXElems + (ty * kTC) * XP;
    const T* wt = ws + (t % kStages) * Tl::kWElems + tx * kTF;
#pragma unroll
    for (int kk = 0; kk < kBD; kk += VEC) {
      float xv[kTC][VEC];
#pragma unroll
      for (int i = 0; i < kTC; ++i) load_vec(xt + i * XP + kk, xv[i]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float wv[kTF];
        load4(wt + (kk + j) * BF, wv);
#pragma unroll
        for (int i = 0; i < kTC; ++i)
#pragma unroll
          for (int q = 0; q < kTF; ++q)
            acc[i][q] = fmaf(xv[i][j], wv[q], acc[i][q]);
      }
    }
  }
  cp_async_wait<0>();

  // f is a multiple of 8 and the column a multiple of 4: all four columns
  // are in range when the first is
  const int col = f0 + tx * kTF;
#pragma unroll
  for (int i = 0; i < kTC; ++i) {
    const int r = c0 + ty * kTC + i;
    if (r < C && col < f)
      store4(out + ((long long)e * C + r) * f + col, acc[i]);
  }
}

// ---------------------------------------------------------------------
// bf16 on the tensor cores (see the header)
// ---------------------------------------------------------------------

constexpr int kTcRows = 64;       // rows of a C-tile: wgmma's M
constexpr int kTcMaxTiles = 4;    // C-tiles of a row group: 256 rows
constexpr int kTcK = 64;          // d per stage: one 128-byte swizzled row
constexpr int kTcHalf = 64;       // f columns of one consumer warpgroup
constexpr int kTcN = 2 * kTcHalf; // f columns of a block
constexpr int kSwRow = 128;       // bytes of a 128-byte-swizzled row
constexpr int kEpiPitch = 144;    // bytes between epilogue rows
constexpr int kTcThreads = 384;   // a producer warpgroup and two consumer ones
constexpr int kTcMaxStages = 8;
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may opt in to
constexpr int kWStageBytes = kTcK * kTcN * 2;      // two [64, 64] boxes
constexpr int kWHalfBytes = kTcK * kTcHalf * 2;

// bytes of dynamic shared memory: slack to align the base to 1024 (the
// swizzle atom), the stages (x rows, then w), two epilogue tiles, and
// the full and empty barriers.  `gmm_plan` in moe_gmm.py computes the same.
constexpr int tc_smem_bytes(int tiles, int stages) {
  return 1024 + stages * (tiles * kTcRows * kSwRow + kWStageBytes) +
         2 * kTcRows * kEpiPitch + 16 * stages;
}

// rows of x a stage's box brings: the group's, or C rounded up to 8 when
// C is smaller (the rest of a C-tile keeps whatever the stage held; its
// output rows are never stored)
__host__ __device__ constexpr int x_box_rows(int tiles, int C) {
  return tiles * kTcRows < ((C + 7) & ~7) ? tiles * kTcRows : ((C + 7) & ~7);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
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

// one box of a 2-D or 3-D tensor map (coordinates innermost first) into
// shared memory; its bytes complete a transaction on the barrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         bool three_d, int c0, int c1, int c2) {
  if (three_d)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
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
// keeps the compiler from moving accumulator reads across a wait
__device__ __forceinline__ void reg_fence(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64x64] (+)= A[64x16] B[16x64], both in shared memory: A K-major, B
// MN-major (transpose bit set)
__device__ __forceinline__ void wgmma_ss_tb(float (&d)[32], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// grid min(E * ceil(f / 128), SMs): persistent blocks, each taking work
// tiles blockIdx.x, + gridDim.x, ...; tile `item` is expert item / nf,
// columns from (item % nf) * 128.  Block kTcThreads; dynamic shared
// memory tc_smem_bytes(TILES, stages).  xmap: x as [d, C] (x3 = 0: every
// expert reads the same tokens) or [d, C, E] (x3 = 1), boxes (64,
// x_box_rows(TILES, C)); wmap: w as [f, d] (w3 = 0) or [f, d, E], boxes
// (64, 64); both with the 128-byte swizzle.  out [E, C, f] contiguous.
template <int TILES>
__global__ void __launch_bounds__(kTcThreads, 1)
gmm_tc_kernel(const __grid_constant__ CUtensorMap xmap,
              const __grid_constant__ CUtensorMap wmap, __nv_bfloat16* __restrict__ out,
              int E, int C, int d, int f, int stages, int x3, int w3) {
  constexpr int kGroupRows = TILES * kTcRows;
  constexpr int kXStageBytes = kGroupRows * kSwRow;
  extern __shared__ unsigned char tc_smem[];
  const uint32_t raw = smem_u32(tc_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t w0 = base + stages * kXStageBytes;
  const uint32_t epi0 = w0 + stages * kWStageBytes;
  const uint32_t full0 = epi0 + 2 * kTcRows * kEpiPitch;
  const uint32_t empty0 = full0 + 8 * stages;
  auto x_stage = [&](int s) { return base + s * kXStageBytes; };
  auto w_stage = [&](int s) { return w0 + s * kWStageBytes; };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wg = threadIdx.x / 128;
  const int nf = (f + kTcN - 1) / kTcN;
  const int nk = (d + kTcK - 1) / kTcK;
  const int groups = (C + kGroupRows - 1) / kGroupRows;
  const int per_item = groups * nk;
  const int items = E * nf;
  const int my_items =
      items > (int)blockIdx.x ? (items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);     // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // the producer warpgroup gives its registers to the consumers; its
    // thread 0 loads pipeline tile t (the t-th (group, d tile) of the
    // block's work tiles in order) into stage t % stages once the
    // consumers have released that stage's previous tile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      const uint32_t bytes = x_box_rows(TILES, C) * kSwRow + kWStageBytes;
      for (int t = 0; t < my_items * per_item; ++t) {
        const int s = t % stages, item = blockIdx.x + (t / per_item) * gridDim.x;
        const int r = t % per_item, e = item / nf, n0 = (item % nf) * kTcN;
        const int row0 = (r / nk) * kGroupRows, k0 = (r % nk) * kTcK;
        if (t >= stages) mbar_wait(empty0 + 8 * s, (t / stages - 1) & 1);
        const uint32_t bar = full0 + 8 * s;
        mbar_expect_tx(bar, bytes);
        tma_load(x_stage(s), &xmap, bar, x3, k0, row0, e);
        tma_load(w_stage(s), &wmap, bar, w3, n0, k0, e);
        tma_load(w_stage(s) + kWHalfBytes, &wmap, bar, w3, n0 + kTcHalf, k0, e);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  // consumer warpgroup h: columns n0 + h * 64 .. + 64 of every C-tile
  const int h = wg - 1, t = threadIdx.x % 128;
  const int quad = lane >> 2, t4 = lane & 3;
  unsigned char* epi = tc_smem + (epi0 - raw) + h * kTcRows * kEpiPitch;
  float acc[TILES][32];
  float part[2][32];
  int it = 0;
  for (int m = 0; m < my_items; ++m) {
    const int item = blockIdx.x + m * gridDim.x;
    const int e = item / nf, n0 = (item % nf) * kTcN;
    for (int g = 0; g < groups; ++g) {
#pragma unroll
      for (int ct = 0; ct < TILES; ++ct)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[ct][i] = 0.f;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % stages;
        mbar_wait(full0 + 8 * s, (it / stages) & 1);
        // each C-tile's product over this d tile (4 k16 steps, 32 bytes
        // into a swizzled x row and 16 rows of w each) starts from zero
        // in part[ct % 2] and is then added to the f32 accumulator: the
        // tensor cores' own (truncating) adds stay inside 64 terms.  One
        // C-tile's product runs while the previous one is added.
#pragma unroll
        for (int ct = 0; ct < TILES; ++ct) {
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kTcK / 16; ++kk)
            wgmma_ss_tb(part[ct % 2],
                        sw128_desc(x_stage(s) + ct * kTcRows * kSwRow + kk * 32, 16, 1024),
                        sw128_desc(w_stage(s) + h * kWHalfBytes + kk * 16 * kSwRow, 1024,
                                   1024),
                        kk > 0);
          wgmma_commit();
          if (ct > 0) {
            wgmma_wait<1>();
            reg_fence(part[(ct - 1) % 2]);
#pragma unroll
            for (int i = 0; i < 32; ++i) acc[ct - 1][i] += part[(ct - 1) % 2][i];
          }
        }
        wgmma_wait<0>();
        reg_fence(part[(TILES - 1) % 2]);
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[TILES - 1][i] += part[(TILES - 1) % 2][i];
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * s);
      }

      // epilogue: accumulator element i of a C-tile is row (warp % 4) * 16
      // + quad (+ 8 when i & 2), column (i / 4) * 8 + 2 * t4 (+ 1 when i & 1);
      // rows past C (stale or zero in shared memory) are never stored
#pragma unroll
      for (int ct = 0; ct < TILES; ++ct) {
        const int row0 = g * kGroupRows + ct * kTcRows;
        if (row0 >= C) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          unsigned char* er = epi + ((warp % 4) * 16 + quad + 8 * j) * kEpiPitch + 4 * t4;
#pragma unroll
          for (int nb = 0; nb < 8; ++nb) {
            const int i = nb * 4 + 2 * j;
            *reinterpret_cast<uint32_t*>(er + nb * 16) =
                pack_bf16(acc[ct][i], acc[ct][i + 1]);
          }
        }
        asm volatile("bar.sync %0, 128;\n" ::"r"(wg) : "memory");
        // 64 rows of 8 16-byte vectors, 4 a thread
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int v = t + u * 128, r = v / 8, c = (v % 8) * 8;
          const int row = row0 + r, col = n0 + h * kTcHalf + c;
          if (row < C && col < f)
            *reinterpret_cast<uint4*>(out + ((long long)e * C + row) * f + col) =
                *reinterpret_cast<const uint4*>(epi + r * kEpiPitch + 2 * c);
        }
        asm volatile("bar.sync %0, 128;\n" ::"r"(wg) : "memory");
      }
    }
  }
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

// A bf16 operand [outer, rows, inner] (strides in elements, unit on inner)
// as a tensor map with boxes of (64 inner, box_rows rows) and the 128-byte
// swizzle: 2-D over [rows, inner] when `outer` is 0 (every expert reads the
// same matrix), else 3-D.  Elements past the extents read as zeros.
cudaError_t encode_operand(CUtensorMap* map, const void* base, int inner, int rows,
                           int outer, long long s_row, long long s_outer, int box_rows,
                           CUtensorMapL2promotion l2) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows, (cuuint64_t)outer};
  const cuuint64_t strides[2] = {(cuuint64_t)s_row * 2, (cuuint64_t)s_outer * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, outer ? 3 : 2,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, l2,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the SM count of the current device (read once per device)
int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    counts[dev] = 132;
  return counts[dev];
}

template <int TILES>
int launch_tc(const CUtensorMap& xmap, const CUtensorMap& wmap, void* out, int E, int C,
              int d, int f, int stages, int x3, int w3, cudaStream_t st) {
  // above 48 KB of dynamic shared memory a kernel must opt in: once per
  // instantiation, for all a block may take
  static cudaError_t configured = cudaFuncSetAttribute(
      gmm_tc_kernel<TILES>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (configured != cudaSuccess) return (int)configured;
  // persistent blocks, one an SM (the stages take its shared memory)
  const long long items = (long long)E * ((f + kTcN - 1) / kTcN);
  const int blocks = (int)std::min<long long>(items, sm_count());
  gmm_tc_kernel<TILES><<<blocks, kTcThreads, tc_smem_bytes(TILES, stages), st>>>(
      xmap, wmap, static_cast<__nv_bfloat16*>(out), E, C, d, f, stages, x3, w3);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// f32 launch
// ---------------------------------------------------------------------

template <typename T, int BC, int BF>
int launch(const void* x, const void* w, void* out, int E, int C, int d, int f,
           long long sxe, long long sxc, long long swe, long long swd, cudaStream_t st) {
  using Tl = Tile<T, BC, BF>;
  const dim3 grid((f + BF - 1) / BF, (C + BC - 1) / BC, E);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  // above 48 KB of dynamic shared memory a kernel must opt in: once per
  // instantiation
  static cudaError_t configured = cudaFuncSetAttribute(
      gmm_kernel<T, BC, BF>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tl::kSmem);
  if (configured != cudaSuccess) return (int)configured;
  gmm_kernel<T, BC, BF><<<grid, Tl::kThreads, Tl::kSmem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      C, d, f, sxe, sxc, swe, swd);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* w, void* out, int E, int C, int d,
             int f, long long sxe, long long sxc, long long swe,
             long long swd, cudaStream_t st) {
  // the C-tile: all of a small C in one tile, so the weights are read once
  if (C <= 8)
    return launch<T, 8, 128>(x, w, out, E, C, d, f, sxe, sxc, swe, swd, st);
  if (C <= 32)
    return launch<T, 32, 64>(x, w, out, E, C, d, f, sxe, sxc, swe, swd, st);
  return launch<T, 64, 64>(x, w, out, E, C, d, f, sxe, sxc, swe, swd, st);
}

}  // namespace

// x [E, C, d] with strides (sxe, sxc, 1); w [E, d, f] with strides
// (swe, swd, 1); out [E, C, f] contiguous.  dtype 0 = f32 (the CUDA-core
// body); bf16 (dtype 1) runs on the tensor cores through `moe_gmm_tc`,
// which takes its tile plan from the caller, and is refused here.  d and
// f multiples of 8, every row 16-byte aligned.  Returns the CUDA error of
// the launch (0 on success).
extern "C" int moe_gmm(const void* x, const void* w, void* out, int dtype,
                       int E, int C, int d, int f, long long sxe,
                       long long sxc, long long swe, long long swd,
                       void* stream) {
  if (E <= 0 || C <= 0 || f <= 0) return 0;
  if (d < 0 || d % 8 || f % 8) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(x, w, out, E, C, d, f, sxe, sxc, swe, swd,
                           (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

// bf16 x [E, C, d], w [E, d, f] as `moe_gmm`; out [E, C, f] contiguous.
// `tiles` C-tiles of 64 rows form a row group (1-4) and `stages` (2-8)
// d tiles are in flight, as `gmm_plan` chose them.  A stride of a size-1
// dim is never read; an expert stride of 0 makes a 2-D map; a row stride
// of 0 (with more than one row) is refused: TMA takes none.
extern "C" int moe_gmm_tc(const void* x, const void* w, void* out, int E, int C, int d,
                          int f, long long sxe, long long sxc, long long swe,
                          long long swd, int tiles, int stages, void* stream) {
  if (E <= 0 || C <= 0 || f <= 0) return 0;
  if (d < 0 || d % 8 || f % 8 || E > 65535 || tiles < 1 || tiles > kTcMaxTiles ||
      stages < 2 || stages > kTcMaxStages || tc_smem_bytes(tiles, stages) > kSmemMax)
    return (int)cudaErrorInvalidValue;
  const bool x3 = E > 1 && sxe != 0, w3 = E > 1 && swe != 0;
  CUtensorMap xmap{}, wmap{};
  if (d > 0) {   // d == 0: no tile is loaded and the output is zeros
    const long long x_row = C > 1 ? sxc : d;
    if (x_row <= 0 || swd <= 0) return (int)cudaErrorInvalidValue;
    cudaError_t e = encode_operand(&xmap, x, d, C, x3 ? E : 0, x_row, sxe,
                                   x_box_rows(tiles, C), CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
    if (e != cudaSuccess) return (int)e;
    // a weight row's two 128-byte halves are one 256-byte L2 request
    e = encode_operand(&wmap, w, f, d, w3 ? E : 0, swd, swe, kTcK,
                       CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t st = (cudaStream_t)stream;
  switch (tiles) {
    case 1: return launch_tc<1>(xmap, wmap, out, E, C, d, f, stages, x3, w3, st);
    case 2: return launch_tc<2>(xmap, wmap, out, E, C, d, f, stages, x3, w3, st);
    case 3: return launch_tc<3>(xmap, wmap, out, E, C, d, f, stages, x3, w3, st);
    default: return launch_tc<4>(xmap, wmap, out, E, C, d, f, stages, x3, w3, st);
  }
}

// The dynamic shared memory of `moe_gmm_tc` at a plan's tiles and stages
// (the card tests hold `gmm_plan`'s figure to it).
extern "C" int moe_gmm_tc_smem(int tiles, int stages) {
  return tc_smem_bytes(tiles, stages);
}
