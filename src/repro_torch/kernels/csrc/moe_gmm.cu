// MoE grouped matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm.py `gmm_bcd`
// (`_gmm_kernel`, entry `moe_gmm`).  Same function: E independent
// products out[e] = x[e] @ w[e], x [E, C, d], w [E, d, f] -> out [E, C, f],
// accumulated in f32 and written in x's type (f32 or bf16).  The TPU
// wrapper pads C, d and f to its block sizes; here the ragged edges are
// bounds checks inside the kernel (zero-filled loads, guarded stores).
// x is read through its strides, so the MoE layer's dense mode passes the
// broadcast view x2d.expand(E, T, d) (expert stride 0) without a copy.
// Each output is one f32 FMA chain over d in order, so results do not
// depend on the launch shape.
//
// What bounds it on the H100: at OLMoE widths (d 2048, f 1024, E 64)
// bytes up to C ~ 295 rows: one call reads 268 MB of weights (>= 0.080
// ms at 3.35 TB/s), and the serving calls have C = 1 (gmm decode), 6
// (dense decode), 25 (gmm 160-token chunk) or 160 (dense chunk).  What
// the design does about that:
//   * one block per (f-tile, C-tile, expert), looping over d in tiles of
//     32; a C-tile covers all of a small C (8 rows when C <= 8, 32 when
//     C <= 32), so each weight is read from device memory once per call;
//   * the x and w tiles stream into shared memory through a 3-stage
//     ring of 16-byte `cp.async` copies (no registers held for the
//     copy), so two tiles are in flight while the third is multiplied;
//     out-of-range vectors are zero-filled by the copy itself;
//   * each thread keeps a 4 x 4 f32 accumulator tile in registers and
//     reads 16-byte x vectors and 4-wide w vectors from shared memory.
// Known limits: the products run on CUDA cores (no mma / wgmma), so a
// large C (dense prefill chunks) is bound by the CUDA cores' FMA rate,
// far above both bounds; a block of a small C multiplies padded rows; and
// experts that received no rows are still read.  Those are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* o) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x; o[2 * i + 1] = f.y;
  }
}

// four consecutive values as floats
__device__ __forceinline__ void load4(const float* p, float* o) {
  load_vec(p, o);
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  uint2 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
  h[0] = __floats2bfloat162_rn(v[0], v[1]);
  h[1] = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = u;
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

template <typename T, int BC, int BF>
int launch(const void* x, const void* w, void* out, int E, int C, int d,
           int f, long long sxe, long long sxc, long long swe, long long swd,
           cudaStream_t st) {
  using Tl = Tile<T, BC, BF>;
  const dim3 grid((f + BF - 1) / BF, (C + BC - 1) / BC, E);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  // above 48 KB of dynamic shared memory a kernel must opt in
  cudaError_t err = cudaFuncSetAttribute(
      gmm_kernel<T, BC, BF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Tl::kSmem);
  if (err != cudaSuccess) return (int)err;
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
// (swe, swd, 1); out [E, C, f] contiguous.  dtype 0 = f32, 1 = bf16 (x, w
// and out of one type).  d and f multiples of 8, every row 16-byte
// aligned.  Returns the CUDA error of the launch (0 on success).
extern "C" int moe_gmm(const void* x, const void* w, void* out, int dtype,
                       int E, int C, int d, int f, long long sxe,
                       long long sxc, long long swe, long long swd,
                       void* stream) {
  if (E <= 0 || C <= 0 || f <= 0) return 0;
  if (d < 0 || d % 8 || f % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(x, w, out, E, C, d, f, sxe, sxc, swe, swd, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, w, out, E, C, d, f, sxe, sxc, swe, swd,
                                   st);
  return (int)cudaErrorInvalidValue;
}
