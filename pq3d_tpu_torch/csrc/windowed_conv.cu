// Windowed sparse convolution over Morton-ordered rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel windowed_sparse_conv (pq3d_tpu/ops/pallas_conv.py,
// body _kernel :94, pl.pallas_call :205).  Same function as the K-tap
// gather conv ops/sparse.sparse_conv on the (N, K) map its plan was built
// from, for any K, over the plan of ops/windowed_conv.fold_exceptions:
//
//     y[j] = sum_k slab_t[nbr_slab[j, k]] @ W[k],   t = j / tile,
//     slab_t = x[win_lo[t] .. win_lo[t] + window) ++ x[exc_src[t, :]]
//
// nbr_slab = -1 (missing) reads zeros; exc_src lists the tile's distinct
// out-of-window source rows (-1 padded), so one gather covers every
// reference.  bf16 operands, f32 sums, y in f32.
//
// What bounds it on this card: bytes.  Per output row the function reads
// x (Cin bf16 after the wrapper's cast, 192 bytes at Cin 96), its nbr_slab
// row and writes Cout f32, against 2 * Cin * Cout flops per reference
// (about 9 references a row on scan surfaces): some 0.5 ms for the 12
// routed shapes of one served forward (B = 4), far below the card's ~295
// flops a byte.  The kernel cannot reach that: it multiplies whole
// (16-row, tap) pairs and reads each W slice once per tile.  The design
// (an earlier form read B fragments from global memory per MMA,
// multiplied every slot and added the exceptions in a pass of their own):
//   * one block per tile (tile / 16 warps, 16 output rows a warp) and per
//     Cout slice of at most 128 columns (gridDim.y);
//   * the exceptions are rows of the slab, not a pass of their own: the
//     tile's slab -- its window rows, then its extra rows, then a zero row
//     -- is copied to shared memory with 16-byte cp.async (an extra row of
//     -1 padding is zero-filled) in chunks of ck Cin columns: one chunk of
//     all of Cin where it fits, else equal chunks in two buffers;
//   * W lives in shared memory: the work is a sequence of items (chunk,
//     tap), and each item's W slice (the block's Cout columns, the chunk's
//     Cin columns) lands in one of two stages by one bulk copy (the TMA
//     engine, on an mbarrier) of an image the wrapper lays out once a
//     call, while the item before it is multiplied; the next chunk's slab
//     rows come in parts with the items of this one.  B fragments are
//     ldmatrix loads of the stage, never per MMA from global memory;
//   * work no row needs is skipped: the items run over the taps some row
//     of the tile references (the plan's tile_taps), so other taps cost no
//     W copy and a tile of padding rows loads nothing and writes zeros; a
//     warp none of whose 16 rows references an item's tap skips its MMAs
//     (a vote); each lane's slab row for the next item is read while this
//     one runs, from int16 nbr_slab (local rows fit 16 bits);
//   * for each item, every lane points ldmatrix at the slab row its output
//     row references (or at the zero row), so the gather is the A-fragment
//     load itself; mma.sync m16n8k16 bf16 with f32 accumulators held in
//     registers across all items;
//   * the epilogue writes the accumulators straight to y (no atomics).
// Slab and W rows are ck + 8 bf16 apart: an odd number of 16-byte units,
// so the 8 rows of an ldmatrix matrix fall in distinct bank groups.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_TILE = 256;  // 16 warps of 16 rows
constexpr int MAX_NT = 16;     // 128 Cout columns a block
constexpr int HEAD_BYTES = 16;  // two mbarriers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes 0 zero-fills the piece and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// waits until the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWC_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WC_WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one bulk copy (the TMA engine) of `bytes` into shared memory, and the
// arrival on `bar` that expects them
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  // earlier reads of the destination (generic proxy) before its rewrite
  // (async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
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

template <int NT>  // the block's Cout slice: NT n8 tiles (NT even)
__global__ void __launch_bounds__(2 * MAX_TILE, 1)
windowed_conv_kernel(const __nv_bfloat16* __restrict__ x,    // (n, cin)
                     const __nv_bfloat16* __restrict__ wimg,  // W's image
                     const int32_t* __restrict__ win_lo,     // (n / tile,)
                     const int16_t* __restrict__ nbr_slab,   // (n, k)
                     const int32_t* __restrict__ exc_src,    // (n / tile, xr)
                     const int16_t* __restrict__ tile_taps,  // (n / tile, k)
                     float* __restrict__ y,                  // (n, cout)
                     int64_t n, int cin, int cout_p, int cout, int k_taps,
                     int tile, int window, int x_rows, int ck,
                     int slab_bufs) {
  constexpr int CS = NT * 8;
  extern __shared__ __align__(128) unsigned char smem[];
  // the two W stages' mbarriers; slab_bufs slab buffers of window +
  // x_rows + 1 rows (the last row is zeros), two W stages of CS rows, the
  // tile's extra rows' sources, the tile's taps
  const int lds = ck + 8;
  const int n_rows = window + x_rows;      // slab rows loaded from x
  const int slab_rows = n_rows + 1;
  const uint32_t w_full = smem_addr(smem);
  __nv_bfloat16* slab = reinterpret_cast<__nv_bfloat16*>(smem + HEAD_BYTES);
  __nv_bfloat16* wst = slab + slab_bufs * slab_rows * lds;
  int32_t* extra = reinterpret_cast<int32_t*>(wst + 2 * CS * lds);
  int16_t* taps = reinterpret_cast<int16_t*>(extra + x_rows);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int t = blockIdx.x;
  const int c0 = blockIdx.y * CS;
  const int64_t row0 = static_cast<int64_t>(t) * tile;
  // a plan from build_window_map keeps the window inside x; clamp so that
  // no other plan can read past it
  int64_t lo = win_lo[t];
  lo = lo < 0 ? 0 : (lo > n - window ? n - window : lo);
  if (tid == 0) {
    mbar_init(w_full, 1);
    mbar_init(w_full + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < x_rows; i += nthreads)
    extra[i] = exc_src[static_cast<int64_t>(t) * x_rows + i];

  for (int i = tid; i < slab_bufs * lds; i += nthreads)
    slab[(i / lds) * slab_rows * lds + n_rows * lds + i % lds] =
        __float2bfloat16(0.0f);

  // the taps some row of the tile references, ascending, then -1: the
  // items are (chunk, one of those taps); a tile of padding rows has none,
  // loads nothing and writes zeros.  (The counting barriers also publish
  // the mbarriers and the extra rows' sources.)
  int n_used = 0;
  for (int base = 0; base < k_taps; base += nthreads) {
    const int k = base + tid;
    const int v = k < k_taps ? tile_taps[static_cast<int64_t>(t) * k_taps + k]
                             : -1;
    if (k < k_taps) taps[k] = static_cast<int16_t>(v);
    n_used += __syncthreads_count(v >= 0);
  }
  const int n_chunks = (cin + ck - 1) / ck;
  const int items = n_chunks * n_used;
  // slab rows r0 .. r1 of chunk ch, into buffer ch % slab_bufs: window row
  // r from x[lo + r], extra row r - window from its listed source row
  auto load_slab = [&](int ch, int r0, int r1) {
    const int cb = ch * ck;
    const int pieces = min(ck, cin - cb) / 8;  // 16-byte pieces a row
    __nv_bfloat16* dst = slab + (ch % slab_bufs) * slab_rows * lds;
    for (int i = tid; i < (r1 - r0) * pieces; i += nthreads) {
      const int r = r0 + i / pieces;
      const int q = i % pieces;
      const int64_t s = r < window ? lo + r : extra[r - window];
      cp_async16(dst + r * lds + q * 8,
                 x + (s < 0 ? 0 : s) * cin + cb + q * 8, s < 0 ? 0u : 16u);
    }
  };
  // item it's W slice (the block's Cout columns, the chunk's Cin columns
  // of one tap) into stage it % 2: one bulk copy by thread 0 of its image,
  // which the wrapper lays out as the stage's rows
  auto load_w = [&](int it) {
    if (tid != 0) return;
    const int ch = it / n_used;
    const int k = taps[it - ch * n_used];
    const __nv_bfloat16* src =
        wimg + ((static_cast<int64_t>(blockIdx.y) * n_chunks + ch) * k_taps +
                k) * CS * lds;
    bulk_load(smem_addr(wst + (it & 1) * CS * lds), src, CS * lds * 2,
              w_full + 8 * (it & 1));
  };

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.0f;

  // A (ldmatrix): lane l names row l % 16 of its warp's 16 rows, columns
  // (l / 16) * 8 .. +7 of the 16-column step.  B (ldmatrix of the W stage,
  // rows = Cout columns, Cin contiguous): lane l names W row
  // (l / 16) * 8 + l % 8 of a 16-column pair of n8 tiles, Cin columns
  // ((l / 8) % 2) * 8 .. +7, which gives b0, b1 of the pair's first tile
  // and b0, b1 of its second
  const int16_t* my_nbr =
      nbr_slab + (row0 + warp * 16 + (lane & 15)) * k_taps;
  const int a_col = (lane >> 4) * 8;
  const int b_off = (((lane >> 4) * 8 + (lane & 7)) * lds +
                     ((lane >> 3) & 1) * 8) * 2;
  const uint32_t slab_addr = smem_addr(slab);
  const uint32_t w_addr = smem_addr(wst);

  // each lane's slab row for the item's tap, read one item ahead
  int l_next = -1;
  if (items > 0) {
    load_slab(0, 0, n_rows);
    load_w(0);
    cp_async_commit();
    l_next = __ldg(my_nbr + taps[0]);
  }
  for (int it = 0; it < items; ++it) {
    const int ch = it / n_used;
    const int p = it - ch * n_used;
    cp_async_wait_all();
    // every warp is done with item it - 1: its W stage and, at the first
    // item of a chunk, the slab buffer of chunk ch - 1 are free
    __syncthreads();
    if (it + 1 < items) load_w(it + 1);
    if (ch + 1 < n_chunks)
      load_slab(ch + 1, p * n_rows / n_used, (p + 1) * n_rows / n_used);
    cp_async_commit();

    // W of this item has landed
    mbar_wait(w_full + 8 * (it & 1), (it >> 1) & 1);
    int l = l_next;
    if (it + 1 < items)
      l_next = __ldg(my_nbr + taps[p + 1 < n_used ? p + 1 : 0]);
    // a warp none of whose 16 rows references the tap skips its MMAs
    const bool ref = l >= 0 && l < n_rows;
    if (!__any_sync(0xffffffffu, ref)) continue;
    if (!ref) l = n_rows;  // the zero row
    const int steps = min(ck, cin - ch * ck) / 16;
    const uint32_t a_addr =
        slab_addr +
        (((ch % slab_bufs) * slab_rows + l) * lds + a_col) * 2;
    const uint32_t b_addr = w_addr + (it & 1) * CS * lds * 2 + b_off;
    for (int s = 0; s < steps; ++s) {
      uint32_t a[4];
      ldmatrix_x4(a, a_addr + s * 32);
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        uint32_t b[4];
        ldmatrix_x4(b, b_addr + jj * 16 * lds * 2 + s * 32);
        mma_bf16(acc[2 * jj], a, b[0], b[1]);
        mma_bf16(acc[2 * jj + 1], a, b[2], b[3]);
      }
    }
  }

  // accumulator layout: acc[j][0..1] row g, columns 8j + 2 tq .. +1;
  // acc[j][2..3] the same columns of row g + 8
  const int g = lane >> 2;
  const int tq = lane & 3;
  float* y0 = y + (row0 + warp * 16 + g) * cout;
  float* y1 = y0 + 8 * static_cast<int64_t>(cout);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = c0 + j * 8 + 2 * tq;
    if ((cout & 1) == 0) {    // c even: both columns or neither
      if (c < cout) {
        *reinterpret_cast<float2*>(y0 + c) = make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(y1 + c) = make_float2(acc[j][2], acc[j][3]);
      }
    } else {
      if (c < cout) {
        y0[c] = acc[j][0];
        y1[c] = acc[j][2];
      }
      if (c + 1 < cout) {
        y0[c + 1] = acc[j][1];
        y1[c + 1] = acc[j][3];
      }
    }
  }
}

template <int NT>
cudaError_t launch(const void* x, const void* wimg, const void* win_lo,
                   const void* nbr_slab, const void* exc_src,
                   const void* tile_taps, void* y, int64_t n, int cin,
                   int cout_p, int cout, int k_taps, int tile, int window,
                   int x_rows, int ck, int slab_bufs, cudaStream_t stream) {
  const size_t smem =
      HEAD_BYTES +
      (static_cast<size_t>(slab_bufs) * (window + x_rows + 1) + 2 * NT * 8) *
          (ck + 8) * 2 +
      static_cast<size_t>(x_rows) * 4 + static_cast<size_t>(k_taps) * 2;
  auto kern = windowed_conv_kernel<NT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(n / tile),
                  static_cast<unsigned>(cout_p / (NT * 8)));
  kern<<<grid, tile * 2, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wimg),
      static_cast<const int32_t*>(win_lo), static_cast<const int16_t*>(nbr_slab),
      static_cast<const int32_t*>(exc_src),
      static_cast<const int16_t*>(tile_taps), static_cast<float*>(y), n, cin,
      cout_p, cout, k_taps, tile, window, x_rows, ck, slab_bufs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (n, cin) bf16, wimg (cout_p / width, ceil(cin / ck), k, width, ck + 8)
// bf16 (each (Cout slice, Cin chunk, tap) of W as the rows of a W stage:
// Cout columns, Cin contiguous, 8 zero columns of padding), win_lo
// (n / tile,) int32, nbr_slab (n, k) int16, exc_src (n / tile, x_rows)
// int32, tile_taps (n / tile, k) int16, y (n, cout) f32: the plan of
// ops/windowed_conv.fold_exceptions.  cin a multiple of 16; width (the
// Cout slice of one block) a multiple of 16 up to 128 that divides cout_p;
// cout <= cout_p; tile a multiple of 16 up to 256 that divides n; tile <=
// window <= n; x_rows a multiple of 16; ck (the slab's chunk of Cin
// columns) a multiple of 16, with slab_bufs 1 when ck >= cin, else 2.
// Returns the cudaError_t of the launch (0 = success); the kernel runs on
// `stream` and is not synchronised.
int pq3d_windowed_conv(const void* x, const void* wimg, const void* win_lo,
                       const void* nbr_slab, const void* exc_src,
                       const void* tile_taps, void* y, int64_t n, int cin,
                       int cout_p, int width, int cout, int k_taps, int tile,
                       int window, int x_rows, int ck, int slab_bufs,
                       void* stream) {
  if (cin <= 0 || cin % 16 != 0 || width <= 0 || width % 16 != 0 ||
      width > MAX_NT * 8 || cout_p % width != 0 || cout <= 0 ||
      cout > cout_p || k_taps <= 0 || tile < 16 || tile % 16 != 0 ||
      tile > MAX_TILE || n <= 0 || n % tile != 0 || window < tile ||
      window > n || x_rows < 0 || x_rows % 16 != 0 || ck <= 0 ||
      ck % 16 != 0 || slab_bufs != (ck >= cin ? 1 : 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width / 8) {
#define WINCONV_CASE(NT)                                                   \
  case NT:                                                                 \
    return static_cast<int>(launch<NT>(x, wimg, win_lo, nbr_slab, exc_src,\
                                       tile_taps, y, n, cin, cout_p, cout, \
                                       k_taps, tile, window, x_rows, ck,   \
                                       slab_bufs, s));
    WINCONV_CASE(2) WINCONV_CASE(4) WINCONV_CASE(6) WINCONV_CASE(8)
    WINCONV_CASE(10) WINCONV_CASE(12) WINCONV_CASE(14) WINCONV_CASE(16)
#undef WINCONV_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
