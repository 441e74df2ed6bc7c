// Stride-1 3^3 sparse convolution over the z-run plan, for Hopper (sm_90a).
//
// Replaces the TPU kernel pallas_zt_conv (pq3d_tpu/ops/pallas_zt.py, body
// _kernel, pl.pallas_call at :386).  Same function as the 27-tap gather
// conv ops/sparse.sparse_conv on a (N, 27) stride-1 map:
//
//     y[i] = sum_{c<9, dz<3} x[zbase[i,c] + slot(i,c,dz)] @ W[3c+dz]
//
// where voxel rows are ravel-sorted with z fastest, so the up-to-3
// z-neighbours of each of the 9 (dy, dx) kernel columns are consecutive
// rows starting at zbase[i, c], and zcode[i, c, p] names the kernel
// z-offset (-1/0/+1) that fetched slot p carries (-2: none).
//
// What bounds it on this card: the work is 2*N*27*Cin*Cout flops against
// ~N*(Cin + Cout) bytes of unique traffic, so with bf16 tensor cores it is
// operation-bound in principle; the random-row gather that bounded the TPU
// version (its one-hot MXU gather and 384-row VMEM window were workarounds
// for Mosaic) is an ordinary indexed load here.  Design (simple first):
//   * one CTA = 64 output rows x all Cout, 4 warps of 16 rows each;
//   * for each (column, dz): every output row's selected source row
//     (zbase + slot, or zeros) is loaded with 16-byte vector loads into a
//     64 x Cin bf16 tile in shared memory (neighbouring output rows hit the
//     same z-runs, so L1/L2 absorb the re-reads across the 3 dz);
//   * the tile times W[3c+dz] runs on the tensor cores through WMMA
//     (16x16x16 bf16, f32 accumulators held in registers across all 27
//     taps); B fragments are read straight from global memory (W is
//     27*Cin*Cout bf16, L2-resident);
//   * the epilogue stages the f32 tile in shared memory, zeroes rows with
//     out_valid == 0 and writes x's dtype.
// No TMA, wgmma or multi-stage pipeline yet: those are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TILE = 64;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ void load_row_chunk(const float* __restrict__ x,
                                               int64_t src, int cin, int q,
                                               __nv_bfloat16* dst) {
  // 4 f32 -> 4 bf16 (one 16-byte load, one 8-byte store)
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (src >= 0) v = __ldg(reinterpret_cast<const float4*>(x + src * cin) + q);
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst + q * 4) = packed;
}

__device__ __forceinline__ void load_row_chunk(
    const __nv_bfloat16* __restrict__ x, int64_t src, int cin, int q,
    __nv_bfloat16* dst) {
  // 8 bf16 (one 16-byte load and store)
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (src >= 0) v = __ldg(reinterpret_cast<const uint4*>(x + src * cin) + q);
  *reinterpret_cast<uint4*>(dst + q * 8) = v;
}

__device__ __forceinline__ void store_out(float* y, int64_t i, float v) {
  y[i] = v;
}

__device__ __forceinline__ void store_out(__nv_bfloat16* y, int64_t i,
                                          float v) {
  y[i] = __float2bfloat16_rn(v);
}

template <typename T, int NF>
__global__ void __launch_bounds__(THREADS)
zrun_conv_kernel(const T* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                 const int32_t* __restrict__ zbase,
                 const int8_t* __restrict__ zcode,
                 const uint8_t* __restrict__ out_valid, T* __restrict__ y,
                 int64_t n, int cin) {
  constexpr int COUT = NF * 16;
  constexpr int VEC = sizeof(T) == 4 ? 4 : 8;  // elements per 16-byte load
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = cin + 8;                      // bf16 elements, padded
  __nv_bfloat16* a_tile = reinterpret_cast<__nv_bfloat16*>(smem);
  float* o_tile = reinterpret_cast<float*>(smem + TILE * lda * 2);
  constexpr int LDO = COUT + 4;
  __shared__ int64_t src_row[TILE];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * TILE;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[f], 0.0f);

  const int chunks = cin / VEC;
  for (int c = 0; c < 9; ++c) {
    for (int dz = 0; dz < 3; ++dz) {
      if (tid < TILE) {
        const int64_t r = row0 + tid;
        int64_t s = -1;
        if (r < n) {
          const int64_t base = zbase[r * 9 + c];
          const int8_t* code = zcode + (r * 9 + c) * 3;
#pragma unroll
          for (int p = 0; p < 3; ++p)
            if (code[p] == dz - 1) s = base + p;
        }
        src_row[tid] = s;
      }
      __syncthreads();
      for (int idx = tid; idx < TILE * chunks; idx += THREADS) {
        const int r = idx / chunks;
        const int q = idx - r * chunks;
        load_row_chunk(x, src_row[r], cin, q, a_tile + r * lda);
      }
      __syncthreads();
      const __nv_bfloat16* wt =
          w + static_cast<int64_t>(c * 3 + dz) * cin * COUT;
      for (int k = 0; k < cin; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a_frag;
        wmma::load_matrix_sync(a_frag, a_tile + warp * 16 * lda + k, lda);
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> b_frag;
          wmma::load_matrix_sync(b_frag, wt + k * COUT + f * 16, COUT);
          wmma::mma_sync(acc[f], a_frag, b_frag, acc[f]);
        }
      }
      __syncthreads();   // a_tile / src_row are rewritten next iteration
    }
  }

#pragma unroll
  for (int f = 0; f < NF; ++f)
    wmma::store_matrix_sync(o_tile + warp * 16 * LDO + f * 16, acc[f], LDO,
                            wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < TILE * COUT; idx += THREADS) {
    const int r = idx / COUT;
    const int o = idx - r * COUT;
    const int64_t row = row0 + r;
    if (row >= n) continue;
    float v = o_tile[r * LDO + o];
    if (out_valid != nullptr && out_valid[row] == 0) v = 0.0f;
    store_out(y, row * COUT + o, v);
  }
}

template <typename T, int NF>
cudaError_t launch(const void* x, const void* w, const void* zbase,
                   const void* zcode, const void* out_valid, void* y,
                   int64_t n, int cin, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(TILE) * (cin + 8) * 2 +
                      static_cast<size_t>(TILE) * (NF * 16 + 4) * 4;
  auto kern = zrun_conv_kernel<T, NF>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const unsigned grid = static_cast<unsigned>((n + TILE - 1) / TILE);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const int32_t*>(zbase), static_cast<const int8_t*>(zcode),
      static_cast<const uint8_t*>(out_valid), static_cast<T*>(y), n, cin);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int nf, const void* x, const void* w, const void* zb,
                     const void* zc, const void* ov, void* y, int64_t n,
                     int cin, cudaStream_t s) {
  switch (nf) {
#define ZRUN_CASE(NF) \
  case NF:            \
    return launch<T, NF>(x, w, zb, zc, ov, y, n, cin, s);
    ZRUN_CASE(1) ZRUN_CASE(2) ZRUN_CASE(3) ZRUN_CASE(4) ZRUN_CASE(5)
    ZRUN_CASE(6) ZRUN_CASE(7) ZRUN_CASE(8) ZRUN_CASE(9) ZRUN_CASE(10)
    ZRUN_CASE(11) ZRUN_CASE(12) ZRUN_CASE(13) ZRUN_CASE(14) ZRUN_CASE(15)
#undef ZRUN_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x (n, cin) f32 or bf16 (x_is_bf16), w (27, cin, cout) bf16, zbase (n, 9)
// int32, zcode (n, 9, 3) int8, out_valid (n,) uint8 or null, y (n, cout) in
// x's dtype.  cin and cout must be multiples of 16, cout <= 240.  Returns
// the cudaError_t of the launch (0 = success); the kernel runs on `stream`
// and is not synchronised.
int pq3d_zrun_conv(const void* x, const void* w, const void* zbase,
                   const void* zcode, const void* out_valid, void* y,
                   int64_t n, int cin, int cout, int x_is_bf16,
                   void* stream) {
  if (cin % 16 != 0 || cout % 16 != 0 || cout > 240 || cin <= 0 || n <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nf = cout / 16;
  cudaError_t e =
      x_is_bf16 ? dispatch<__nv_bfloat16>(nf, x, w, zbase, zcode, out_valid,
                                          y, n, cin, s)
                : dispatch<float>(nf, x, w, zbase, zcode, out_valid, y, n,
                                  cin, s);
  return static_cast<int>(e);
}

}  // extern "C"
