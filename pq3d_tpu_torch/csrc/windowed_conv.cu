// Windowed sparse convolution over Morton-ordered rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel windowed_sparse_conv (pq3d_tpu/ops/pallas_conv.py,
// body _kernel :94, pl.pallas_call :205).  Same function as the K-tap
// gather conv ops/sparse.sparse_conv on the (N, K) map its plan was built
// from (ops/windowed_conv.build_window_map):
//
//     y[j] = sum_k x[win_lo[t] + nbr_local[j, k]] @ W[k]
//            + sum of contrib[t * et + e] over e with exc_row[t, e] == j % tile
//
// for output row j of tile t = j / tile; nbr_local = -1 (missing, or outside
// the window) reads zeros; contrib holds the out-of-window references'
// products, computed outside the kernel (ops/windowed_conv.exception_contrib).
//
// What bounds it on this card: bytes.  Per output row it reads x (Cin bf16,
// 192 bytes at Cin 96), its nbr_local row (4 K bytes: 108 at K = 27, more
// than half of x) and writes Cout f32, against 2 * Cin * Cout flops per
// valid reference (about 9 a row on scan surfaces), which is below the
// card's ~295 flops a byte.  The design reads x once per block as one
// contiguous slab and does the gather in shared memory:
//   * one block per tile (tile / 16 warps, 16 output rows a warp) and per
//     Cout slice of at most 128 columns (gridDim.y);
//   * the tile's window-row slab of x is copied to shared memory with
//     cp.async in chunks of 64 Cin columns (512 x 192 bf16 alone would be
//     192 KB), double-buffered so the next chunk lands while this one is
//     multiplied;
//   * for each tap, every lane points ldmatrix at the slab row its output
//     row references (or at a zero row), so the gather is the A-fragment
//     load itself; mma.sync m16n8k16 bf16 with f32 accumulators held in
//     registers across all chunks and taps; B fragments are read from W
//     (pre-transposed to (K, Cout, Cin)) through the read-only cache;
//   * the epilogue stages the tile's f32 sums in shared memory, adds the
//     tile's exception rows there with shared-memory atomics (several
//     exceptions may name one row; -1 padding names none) and writes y.
// The TPU kernel's one-hot MXU gather, one-hot exception add, 128-lane
// padding and 8-row DMA alignment worked around Mosaic's one-vreg in-VMEM
// gather and are not carried over.  nbr_local is read once per chunk and
// tap through L1; narrowing it (local rows fit 16 bits), wgmma and a TMA
// ring are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CK = 64;         // Cin columns of the slab per chunk
constexpr int LDS = CK + 8;    // slab row stride in bf16: 144 bytes, so
                               // rows stay 16-byte aligned for ldmatrix
constexpr int MAX_TILE = 256;  // 16 warps of 16 rows
constexpr int MAX_NT = 16;     // 128 Cout columns a block

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// four 8x8 b16 matrices; lane i gives the address of row i % 8 of matrix
// i / 8, so every lane may name any (16-byte aligned) row: a gather
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int NT>  // the block's Cout slice: NT n8 tiles
__global__ void __launch_bounds__(2 * MAX_TILE, 1)
windowed_conv_kernel(const __nv_bfloat16* __restrict__ x,    // (n, cin)
                     const __nv_bfloat16* __restrict__ wt,   // (k, cout_p, cin)
                     const int32_t* __restrict__ win_lo,     // (n / tile,)
                     const int32_t* __restrict__ nbr_local,  // (n, k)
                     const int32_t* __restrict__ exc_row,    // (n / tile, et)
                     const float* __restrict__ contrib,      // (n/tile*et, cout_p)
                     float* __restrict__ y,                  // (n, cout)
                     int64_t n, int cin, int cout_p, int cout, int k_taps,
                     int tile, int window, int et) {
  constexpr int CS = NT * 8;
  constexpr int LDO = CS + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  // main loop: two slab buffers of window + 1 rows (the last row is zeros);
  // epilogue: the tile's f32 sums, over the same bytes
  __nv_bfloat16* slab = reinterpret_cast<__nv_bfloat16*>(smem);
  float* o_tile = reinterpret_cast<float*>(smem);
  const int buf_elems = (window + 1) * LDS;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int t = blockIdx.x;
  const int c0 = blockIdx.y * CS;
  const int64_t row0 = static_cast<int64_t>(t) * tile;
  // a plan from build_window_map keeps the slab inside x; clamp so that no
  // other plan can read past it
  int64_t lo = win_lo[t];
  lo = lo < 0 ? 0 : (lo > n - window ? n - window : lo);

  for (int i = tid; i < 2 * LDS; i += nthreads)
    slab[(i / LDS) * buf_elems + window * LDS + i % LDS] =
        __float2bfloat16(0.0f);

  const int n_chunks = (cin + CK - 1) / CK;
  auto load_chunk = [&](int ch, int buf) {
    const int cb = ch * CK;
    const int pieces = min(CK, cin - cb) / 8;  // 16-byte pieces a row
    __nv_bfloat16* dst = slab + buf * buf_elems;
    const __nv_bfloat16* src = x + lo * cin + cb;
    for (int i = tid; i < window * pieces; i += nthreads) {
      const int r = i / pieces;
      const int q = i - r * pieces;
      cp_async16(dst + r * LDS + q * 8,
                 src + static_cast<int64_t>(r) * cin + q * 8);
    }
    cp_async_commit();
  };

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.0f;

  // ldmatrix: lane l names row l % 16 of its warp's 16 rows, columns
  // (l / 16) * 8 .. +7 of the 16-column step; mma's B fragment: lane l
  // holds W[k][c0 + 8j + l / 4][2 (l % 4) .. +1] and [.. + 8 .. + 9]
  const int32_t* my_nbr =
      nbr_local + (row0 + warp * 16 + (lane & 15)) * k_taps;
  const int a_col = (lane >> 4) * 8;
  const int g = lane >> 2;
  const int tq = lane & 3;

  load_chunk(0, 0);
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int buf = ch & 1;
    if (ch + 1 < n_chunks) {
      load_chunk(ch + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int cb = ch * CK;
    const int steps = min(CK, cin - cb) / 16;
    const uint32_t base = smem_addr(slab + buf * buf_elems + a_col);
    for (int k = 0; k < k_taps; ++k) {
      int l = __ldg(my_nbr + k);
      if (l < 0 || l >= window) l = window;  // the zero row
      const uint32_t a_addr = base + l * (LDS * 2);
      const __nv_bfloat16* wk =
          wt + (static_cast<int64_t>(k) * cout_p + c0 + g) * cin + cb + 2 * tq;
      for (int s = 0; s < steps; ++s) {
        uint32_t a[4];
        ldmatrix_x4(a, a_addr + s * 32);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const unsigned int* wj = reinterpret_cast<const unsigned int*>(
              wk + static_cast<int64_t>(j) * 8 * cin + s * 16);
          mma_bf16(acc[j], a, __ldg(wj), __ldg(wj + 4));
        }
      }
    }
    __syncthreads();  // this buffer is refilled two chunks on
  }

  // accumulator layout: acc[j][0..1] row g, columns 8j + 2 tq .. +1;
  // acc[j][2..3] the same columns of row g + 8
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float* o = o_tile + (warp * 16 + g) * LDO + j * 8 + 2 * tq;
    o[0] = acc[j][0];
    o[1] = acc[j][1];
    o[8 * LDO] = acc[j][2];
    o[8 * LDO + 1] = acc[j][3];
  }
  __syncthreads();
  const int32_t* er = exc_row + static_cast<int64_t>(t) * et;
  const float* ec = contrib + static_cast<int64_t>(t) * et * cout_p + c0;
  for (int i = tid; i < et * CS; i += nthreads) {
    const int e = i / CS;
    const int c = i - e * CS;
    const int r = __ldg(er + e);
    if (r >= 0 && r < tile)
      atomicAdd(o_tile + r * LDO + c,
                __ldg(ec + static_cast<int64_t>(e) * cout_p + c));
  }
  __syncthreads();
  for (int i = tid; i < tile * CS; i += nthreads) {
    const int r = i / CS;
    const int c = i - r * CS;
    if (c0 + c < cout) y[(row0 + r) * cout + c0 + c] = o_tile[r * LDO + c];
  }
}

template <int NT>
cudaError_t launch(const void* x, const void* wt, const void* win_lo,
                   const void* nbr_local, const void* exc_row,
                   const void* contrib, void* y, int64_t n, int cin,
                   int cout_p, int cout, int k_taps, int tile, int window,
                   int et, cudaStream_t stream) {
  const size_t slab = 2ull * (window + 1) * LDS * sizeof(__nv_bfloat16);
  const size_t o_tile = static_cast<size_t>(tile) * (NT * 8 + 4) * sizeof(float);
  const size_t smem = slab > o_tile ? slab : o_tile;
  auto kern = windowed_conv_kernel<NT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(n / tile),
                  static_cast<unsigned>(cout_p / (NT * 8)));
  kern<<<grid, tile * 2, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wt),
      static_cast<const int32_t*>(win_lo), static_cast<const int32_t*>(nbr_local),
      static_cast<const int32_t*>(exc_row), static_cast<const float*>(contrib),
      static_cast<float*>(y), n, cin, cout_p, cout, k_taps, tile, window, et);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (n, cin) bf16, wt (k, cout_p, cin) bf16 (W transposed per tap), win_lo
// (n / tile,) int32, nbr_local (n, k) int32, exc_row (n / tile, et) int32,
// contrib (n / tile * et, cout_p) f32, y (n, cout) f32.  cin a multiple of
// 16; width (the Cout slice of one block) a multiple of 16 up to 128 that
// divides cout_p; cout <= cout_p; tile a multiple of 16 up to 256 that
// divides n; tile <= window <= n.  Returns the cudaError_t of the launch
// (0 = success); the kernel runs on `stream` and is not synchronised.
int pq3d_windowed_conv(const void* x, const void* wt, const void* win_lo,
                       const void* nbr_local, const void* exc_row,
                       const void* contrib, void* y, int64_t n, int cin,
                       int cout_p, int width, int cout, int k_taps, int tile,
                       int window, int et, void* stream) {
  if (cin <= 0 || cin % 16 != 0 || width <= 0 || width % 16 != 0 ||
      width > MAX_NT * 8 || cout_p % width != 0 || cout <= 0 ||
      cout > cout_p || k_taps <= 0 || tile < 16 || tile % 16 != 0 ||
      tile > MAX_TILE || n <= 0 || n % tile != 0 || window < tile ||
      window > n || et <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width / 8) {
#define WINCONV_CASE(NT)                                                  \
  case NT:                                                                \
    return static_cast<int>(launch<NT>(x, wt, win_lo, nbr_local, exc_row, \
                                       contrib, y, n, cin, cout_p, cout,  \
                                       k_taps, tile, window, et, s));
    WINCONV_CASE(2) WINCONV_CASE(4) WINCONV_CASE(6) WINCONV_CASE(8)
    WINCONV_CASE(10) WINCONV_CASE(12) WINCONV_CASE(14) WINCONV_CASE(16)
#undef WINCONV_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
