// Stride-1 3^3 sparse convolution over the z-run plan, for Hopper (sm_90a).
//
// Replaces the TPU kernel pallas_zt_conv (pq3d_tpu/ops/pallas_zt.py:352,
// body _kernel, pl.pallas_call at :386).  Same function as the 27-tap gather
// conv ops/sparse.sparse_conv on a (N, 27) stride-1 map:
//
//     y[i] = sum_{c<9, dz<3} x[zbase[i,c] + slot(i,c,dz)] @ W[3c+dz]
//
// where voxel rows are ravel-sorted with z fastest, so the up-to-3
// z-neighbours of each of the 9 (dy, dx) kernel columns are consecutive
// rows starting at zbase[i, c], and zcode[i, c, p] names the kernel
// z-offset (-1/0/+1) that fetched slot p carries (-2: none).  Tap order is
// z-fastest: tap = 3c + dz + 1.  bf16 operands, f32 sums, y in f32 or bf16,
// rows with out_valid == 0 zeroed.
//
// What bounds it on this card: the function reads x, W and the plan once
// and writes y once, against 2 * refs * Cin * Cout flops on the tensor
// cores; at the routed shapes that is bytes, about 0.498 ms for the 12
// routed convs of one served forward (B = 4).  The kernel cannot reach
// that: it stages each tap's W once per 128-row tile and multiplies whole
// (tile, tap) pairs, about 3.8x the references' work.  Design:
//   * one block per SM takes 128-row tiles from a counter in global memory
//     (the last block to finish sets it back to 0), with three
//     warpgroups: two consumers of 64 rows each, holding a
//     64 x Cout f32 accumulator in registers (Cout / 2 a thread, 120 at
//     Cout 240), and one producer;
//   * the producer turns each tile's zbase/zcode into the source row of
//     every (tap, row) (-1 = none) and the 27-bit mask of the taps any of
//     its rows references (one per 64-row half too), into one of two plan
//     buffers, while the consumers still multiply and write the previous
//     tile; only the set taps go through the pipeline, so empty (tile,
//     tap) pairs and all-padding tiles cost nothing (a tile with no tap
//     still writes its zero rows);
//   * a ring of 2-5 stages in shared memory, each one tap (or, where two
//     such stages would not fit, as at Cin 240 -> Cout 240, one of its
//     equal K chunks): the 128 gathered
//     source rows (A), by 16-byte cp.async into the no-swizzle core-matrix
//     layout that wgmma reads (a missing row is zero-filled with src-size 0:
//     no branch, no read), and the tap's W slice (B), whose image the
//     wrapper lays out in that layout so that one bulk copy (the TMA engine)
//     brings it.  The producer fills a slot as soon as the consumers free
//     it, across tile boundaries; a slot's "full" mbarrier completes when
//     its copies have landed, its "empty" one when both consumers are done
//     with it;
//   * the consumers multiply with wgmma.m64nCoutk16 bf16 -> f32, both
//     operands read from shared memory, W never per MMA from global memory;
//     the MMAs of tap t stay in flight while the consumers wait for tap
//     t+1, and a consumer whose 64 rows do not reference a tap skips its
//     MMAs;
//   * the epilogue writes the accumulators straight from registers, zeroing
//     rows with out_valid == 0.
// f32 x is cast to bf16 by the wrapper (one pass) so that the gather is a
// plain async copy.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;           // output rows per block
constexpr int CONSUMERS = 256;    // two warpgroups, 64 rows each
constexpr int PRODUCERS = 128;    // one warpgroup
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int TAPS = 27;
constexpr int MAX_STAGES = 5;
constexpr int HEAD_BYTES = 256;   // tap masks and the mbarriers
constexpr int SRC_BYTES = TAPS * BM * 4;   // one tile's source rows
constexpr int FIXED_SMEM = HEAD_BYTES + 2 * SRC_BYTES;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes 0 zero-fills the chunk and reads nothing.
// .ca keeps the gathered x rows in L1 (the 3 taps of a column read nearly
// the same rows).
__device__ __forceinline__ void cp_async_ca(uint32_t dst, const void* src,
                                            uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// mbarriers of the ring: "full" of a slot completes when the row copies of
// the producer's 128 threads and the W bulk copy (armed with its bytes)
// have landed; "empty" when the 256 consumer threads have released it.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// one arrival on `bar` once this thread's earlier cp.async copies have
// landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// one arrival that also expects `bytes` of the bulk copy started with it
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
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

// waits until the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nZR_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra ZR_WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// wgmma descriptor of a K-major operand in the no-swizzle layout: core
// matrices of 8 rows x 16 bytes, each 128 contiguous bytes, `lbo` bytes
// apart along K and `sbo` bytes apart along M (or N).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING)
               : "memory");
}

// Register lists of wgmma.m64nNk16: the N / 2 accumulators are operands
// %0 .. %(N/2 - 1), eight a fragment; the descriptors and scale-d follow.
#define ZR_F0 "%0, %1, %2, %3, %4, %5, %6, %7"
#define ZR_F1 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define ZR_F2 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define ZR_F3 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define ZR_F4 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define ZR_F5 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define ZR_F6 ", %48, %49, %50, %51, %52, %53, %54, %55"
#define ZR_F7 ", %56, %57, %58, %59, %60, %61, %62, %63"
#define ZR_F8 ", %64, %65, %66, %67, %68, %69, %70, %71"
#define ZR_F9 ", %72, %73, %74, %75, %76, %77, %78, %79"
#define ZR_F10 ", %80, %81, %82, %83, %84, %85, %86, %87"
#define ZR_F11 ", %88, %89, %90, %91, %92, %93, %94, %95"
#define ZR_F12 ", %96, %97, %98, %99, %100, %101, %102, %103"
#define ZR_F13 ", %104, %105, %106, %107, %108, %109, %110, %111"
#define ZR_F14 ", %112, %113, %114, %115, %116, %117, %118, %119"
#define ZR_S1 ZR_F0
#define ZR_S2 ZR_S1 ZR_F1
#define ZR_S3 ZR_S2 ZR_F2
#define ZR_S4 ZR_S3 ZR_F3
#define ZR_S5 ZR_S4 ZR_F4
#define ZR_S6 ZR_S5 ZR_F5
#define ZR_S7 ZR_S6 ZR_F6
#define ZR_S8 ZR_S7 ZR_F7
#define ZR_S9 ZR_S8 ZR_F8
#define ZR_S10 ZR_S9 ZR_F9
#define ZR_S11 ZR_S10 ZR_F10
#define ZR_S12 ZR_S11 ZR_F11
#define ZR_S13 ZR_S12 ZR_F12
#define ZR_S14 ZR_S13 ZR_F13
#define ZR_S15 ZR_S14 ZR_F14

#define ZR_D8(i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define ZR_A1 ZR_D8(0)
#define ZR_A2 ZR_A1, ZR_D8(8)
#define ZR_A3 ZR_A2, ZR_D8(16)
#define ZR_A4 ZR_A3, ZR_D8(24)
#define ZR_A5 ZR_A4, ZR_D8(32)
#define ZR_A6 ZR_A5, ZR_D8(40)
#define ZR_A7 ZR_A6, ZR_D8(48)
#define ZR_A8 ZR_A7, ZR_D8(56)
#define ZR_A9 ZR_A8, ZR_D8(64)
#define ZR_A10 ZR_A9, ZR_D8(72)
#define ZR_A11 ZR_A10, ZR_D8(80)
#define ZR_A12 ZR_A11, ZR_D8(88)
#define ZR_A13 ZR_A12, ZR_D8(96)
#define ZR_A14 ZR_A13, ZR_D8(104)
#define ZR_A15 ZR_A14, ZR_D8(112)

// d += A (64 x 16, desc a) @ B (16 x N, desc b); both K-major in shared
// memory, scale-d = 1 (accumulate), no transposes.  A, B, S name the
// operands of the descriptors and of scale-d, which follow the accumulators.
#define ZR_WGMMA(N, REGS, ACCS, A, B, S)                                  \
  asm volatile(                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, " S ", 0;\n"                      \
      "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" REGS   \
      "}, " A ", " B ", p, 1, 1, 0, 0;\n}\n"                               \
      : ACCS                                                              \
      : "l"(a), "l"(b), "r"(1))

template <int COUT>
__device__ __forceinline__ void wgmma_tile(float (&d)[COUT / 2], uint64_t a,
                                           uint64_t b) {
  if constexpr (COUT == 16)
    ZR_WGMMA(16, ZR_S1, ZR_A1, "%8", "%9", "%10");
  if constexpr (COUT == 32)
    ZR_WGMMA(32, ZR_S2, ZR_A2, "%16", "%17", "%18");
  if constexpr (COUT == 48)
    ZR_WGMMA(48, ZR_S3, ZR_A3, "%24", "%25", "%26");
  if constexpr (COUT == 64)
    ZR_WGMMA(64, ZR_S4, ZR_A4, "%32", "%33", "%34");
  if constexpr (COUT == 80)
    ZR_WGMMA(80, ZR_S5, ZR_A5, "%40", "%41", "%42");
  if constexpr (COUT == 96)
    ZR_WGMMA(96, ZR_S6, ZR_A6, "%48", "%49", "%50");
  if constexpr (COUT == 112)
    ZR_WGMMA(112, ZR_S7, ZR_A7, "%56", "%57", "%58");
  if constexpr (COUT == 128)
    ZR_WGMMA(128, ZR_S8, ZR_A8, "%64", "%65", "%66");
  if constexpr (COUT == 144)
    ZR_WGMMA(144, ZR_S9, ZR_A9, "%72", "%73", "%74");
  if constexpr (COUT == 160)
    ZR_WGMMA(160, ZR_S10, ZR_A10, "%80", "%81", "%82");
  if constexpr (COUT == 176)
    ZR_WGMMA(176, ZR_S11, ZR_A11, "%88", "%89", "%90");
  if constexpr (COUT == 192)
    ZR_WGMMA(192, ZR_S12, ZR_A12, "%96", "%97", "%98");
  if constexpr (COUT == 208)
    ZR_WGMMA(208, ZR_S13, ZR_A13, "%104", "%105", "%106");
  if constexpr (COUT == 224)
    ZR_WGMMA(224, ZR_S14, ZR_A14, "%112", "%113", "%114");
  if constexpr (COUT == 240)
    ZR_WGMMA(240, ZR_S15, ZR_A15, "%120", "%121", "%122");
}

// keeps the compiler from reading the accumulators before the last
// wgmma.wait_group
template <int R>
__device__ __forceinline__ void pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A of one stage: the tile's 128 source rows of one tap, columns `x` ..
// `x` + cw (x already offset to the stage's first column), in the
// no-swizzle layout of wgmma with K outermost: core matrix (K chunk k, row
// group g), 8 rows x 8 bf16, is 128 contiguous bytes at (k * 16 + g) * 128.
// Index t < 256 copies row 8 * ((t >> 4) & 15) + ((t >> 1) & 7), its K
// chunks t & 1, t & 1 + 2, ...: two threads read one 32-byte sector of a
// row, and a warp's 32 copies fill every shared-memory bank group evenly.
// The 128 producer threads take t = p and p + 128.  A missing row's chunks
// are zero-filled.
__device__ __forceinline__ void load_rows(uint32_t a_dst,
                                          const __nv_bfloat16* __restrict__ x,
                                          const int32_t* src_tap, int cin,
                                          int cw, int p) {
#pragma unroll
  for (int t = p; t < 2 * BM; t += PRODUCERS) {
    const int k0 = t & 1;
    const int g = (t >> 4) & 15;
    const int r8 = (t >> 1) & 7;
    const int s = src_tap[g * 8 + r8];
    const __nv_bfloat16* row =
        x + static_cast<int64_t>(s < 0 ? 0 : s) * cin + k0 * 8;
    const uint32_t bytes = s < 0 ? 0u : 16u;
    const uint32_t dst = a_dst + ((k0 * (BM / 8) + g) * 8 + r8) * 16;
    for (int i = 0; i < cw / 16; ++i)    // K chunks k0 + 2i
      cp_async_ca(dst + i * 2 * BM * 16, row + i * 16, bytes);
  }
}

// The plan of tile `tile` into `src` ([tap][row], -1 = none) and the taps
// its rows reference into `words` (one per producer warp: rows 32w ..
// 32w + 31).  Producer thread p takes row p.
__device__ __forceinline__ void build_plan(int64_t tile, int64_t n,
                                           const int32_t* __restrict__ zbase,
                                           const int8_t* __restrict__ zcode,
                                           int32_t* src, uint32_t* words,
                                           int p) {
  const int64_t row = tile * BM + p;
  int base[9];
  int8_t code[27];
#pragma unroll
  for (int c = 0; c < 9; ++c) base[c] = row < n ? zbase[row * 9 + c] : 0;
#pragma unroll
  for (int j = 0; j < 27; ++j) code[j] = row < n ? zcode[row * 27 + j] : -2;
  uint32_t bits = 0u;
#pragma unroll
  for (int c = 0; c < 9; ++c) {
    int s3[3] = {-1, -1, -1};   // source of dz = -1, 0, +1
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int cd = code[3 * c + q];
      if (cd == -1) s3[0] = base[c] + q;
      else if (cd == 0) s3[1] = base[c] + q;
      else if (cd == 1) s3[2] = base[c] + q;
    }
#pragma unroll
    for (int dz = 0; dz < 3; ++dz) {
      src[(3 * c + dz) * BM + p] = s3[dz];
      bits |= static_cast<uint32_t>(s3[dz] >= 0) << (3 * c + dz);
    }
  }
  bits = __reduce_or_sync(0xffffffffu, bits);
  if ((p & 31) == 0) words[p >> 5] = bits;
}

template <int COUT>
__global__ void __launch_bounds__(THREADS, 1)
zrun_conv_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ wt,
                 const int32_t* __restrict__ zbase,
                 const int8_t* __restrict__ zcode,
                 const uint8_t* __restrict__ out_valid, void* __restrict__ y,
                 int* __restrict__ counter, int64_t n, int cin, int kc,
                 int stages, int y_bf16) {
  constexpr int R = COUT / 2;    // accumulators per consumer thread
  extern __shared__ __align__(128) unsigned char smem[];
  // head: two plans' tap words (4 a plan) and tile indices, then the
  // mbarriers
  uint32_t* words = reinterpret_cast<uint32_t*>(smem);
  int* plan_tile = reinterpret_cast<int*>(smem + 32);
  const uint32_t plan_full = smem_addr(smem + 40);      // 2 of each
  const uint32_t plan_empty = plan_full + 16;
  const uint32_t full = plan_empty + 16;                // one a slot
  const uint32_t empty = full + 8 * MAX_STAGES;
  int32_t* src = reinterpret_cast<int32_t*>(smem + HEAD_BYTES);  // 2 plans
  const uint32_t ring_addr = smem_addr(smem + FIXED_SMEM);
  // a stage holds columns k0 .. k0 + kc of one tap: kc = Cin unless two
  // such stages would not fit, then Cin in ceil(Cin / kc) chunks
  const int a_bytes = BM * kc * 2;
  const int stage_bytes = a_bytes + COUT * kc * 2;
  const int64_t tiles = (n + BM - 1) / BM;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(plan_full + 8 * b, 1);
      mbar_init(plan_empty + 8 * b, CONSUMERS);
    }
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + 8 * i, PRODUCERS + 1);
      mbar_init(empty + 8 * i, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The block's k-th tile is the next of the launch's counter (tiles take
  // very different times: a padding tile has no taps), planned into buffer
  // k % 2; its taps run through the ring after tile k - 1's, so the next
  // tile's plan and first copies overlap this tile's MMAs and epilogue.
  // counter[0] hands out the tiles, counter[1] counts the blocks that have
  // taken their last; the last block sets both back to 0 for the next
  // launch.
  if (tid >= CONSUMERS) {
    // ---- producer: plan each tile, then fill slot i % S with its taps'
    // K chunks ---------------------------------------------------------
    const int p = tid - CONSUMERS;
    int i = 0;
    for (int k = 0;; ++k) {
      const int b = k & 1;
      if (k >= 2) mbar_wait(plan_empty + 8 * b, ((k >> 1) - 1) & 1);
      if (p == 0) plan_tile[b] = atomicAdd(counter, 1);
      // every producer thread is done with tile k - 2's plan, whose
      // buffer this tile takes
      asm volatile("bar.sync 1, %0;\n" ::"n"(PRODUCERS) : "memory");
      const int64_t tile = plan_tile[b];
      int32_t* plan = src + b * TAPS * BM;
      if (tile < tiles)
        build_plan(tile, n, zbase, zcode, plan, words + 4 * b, p);
      asm volatile("bar.sync 1, %0;\n" ::"n"(PRODUCERS) : "memory");
      if (p == 0) mbar_arrive(plan_full + 8 * b);   // plan (or the end)
      if (tile >= tiles) break;
      const uint32_t mask = words[4 * b] | words[4 * b + 1] |
                            words[4 * b + 2] | words[4 * b + 3];
      for (uint32_t m = mask; m; m &= m - 1) {
        const int tap = __ffs(m) - 1;
        for (int k0 = 0; k0 < cin; k0 += kc, ++i) {
          const int cw = cin - k0 < kc ? cin - k0 : kc;
          const int slot = i % stages;
          if (i >= stages) mbar_wait(empty + 8 * slot, (i / stages - 1) & 1);
          const uint32_t a = ring_addr + slot * stage_bytes;
          // W's image is K-chunk outermost: columns k0 .. k0 + cw of the
          // tap are one contiguous run
          if (p == 0)
            bulk_load(a + a_bytes,
                      wt + (static_cast<int64_t>(tap) * cin + k0) * COUT,
                      COUT * cw * 2, full + 8 * slot);
          load_rows(a, x + k0, plan + tap * BM, cin, cw, p);
          cp_async_arrive(full + 8 * slot);
        }
      }
    }
    if (p == 0) {
      __threadfence();   // this block's last atomicAdd precedes its count
      if (atomicAdd(counter + 1, 1) == static_cast<int>(gridDim.x) - 1) {
        atomicExch(counter, 0);
        atomicExch(counter + 1, 0);
      }
    }
    cp_async_wait_all();   // no copy may outlive its thread
    return;
  }

  // ---- consumers: multiply tap i while tap i + 1 lands --------------------
  const int wg = tid / 128;
  const int lane = tid & 31;
  const int r_lo = wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  int i = 0;
  for (int k = 0;; ++k) {
    const int b = k & 1;
    mbar_wait(plan_full + 8 * b, (k >> 1) & 1);
    const int64_t tile = plan_tile[b];
    const uint32_t* w4 = words + 4 * b;
    const uint32_t my_mask = w4[2 * wg] | w4[2 * wg + 1];
    const uint32_t mask = w4[0] | w4[1] | w4[2] | w4[3];
    mbar_arrive(plan_empty + 8 * b);
    if (tile >= tiles) break;
    float d[R];
#pragma unroll
    for (int j = 0; j < R; ++j) d[j] = 0.0f;
    for (uint32_t m = mask; m; m &= m - 1) {
      const int tap = __ffs(m) - 1;
      const bool mine = (my_mask >> tap) & 1u;
      for (int k0 = 0; k0 < cin; k0 += kc, ++i) {
        const int cw = cin - k0 < kc ? cin - k0 : kc;
        const int slot = i % stages;
        mbar_wait(full + 8 * slot, (i / stages) & 1);
        // the rows landed through the generic proxy, wgmma reads through
        // the async one
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        if (mine) {
          const uint32_t a = ring_addr + slot * stage_bytes;
          // K chunks BM / 8 (A) and Cout / 8 (B) core matrices apart, row
          // groups adjacent; this warpgroup's rows start at group 8 * wg
          const uint64_t da = desc(a + wg * 8 * 128, BM * 16, 128);
          const uint64_t db = desc(a + a_bytes, COUT * 16, 128);
          wgmma_fence();
          for (int kk = 0; kk < cw / 16; ++kk)   // K steps of 16 = 2 chunks
            wgmma_tile<COUT>(d, da + kk * (2 * BM * 16 >> 4),
                             db + kk * (2 * COUT * 16 >> 4));
        }
        wgmma_commit();   // possibly empty: one group per stage
        wgmma_wait<1>();  // stage i - 1's MMAs are done: free its slot
        if (i > 0) mbar_arrive(empty + 8 * ((i - 1) % stages));
      }
    }
    wgmma_wait<0>();
    pin(d);

    // ---- epilogue: accumulators straight to y --------------------------
    // wgmma's f32 layout: warp w of the group holds rows 16w .. 16w + 15;
    // lane l holds rows l / 4 and l / 4 + 8 of them, columns 8j + 2(l % 4)
    // and + 1 in d[4j .. 4j + 3].
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = tile * BM + r_lo + 8 * h;
      if (row >= n) continue;
      const bool keep = out_valid == nullptr || out_valid[row] != 0;
#pragma unroll
      for (int j = 0; j < COUT / 8; ++j) {
        const float v0 = keep ? d[4 * j + 2 * h] : 0.0f;
        const float v1 = keep ? d[4 * j + 2 * h + 1] : 0.0f;
        const int64_t off = row * COUT + 8 * j + col0;
        if (y_bf16)
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(y) + off) =
              __floats2bfloat162_rn(v0, v1);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(y) + off) =
              make_float2(v0, v1);
      }
    }
  }
}

template <int COUT>
cudaError_t launch(const void* x, const void* wt, const void* zbase,
                   const void* zcode, const void* out_valid, void* y,
                   void* counter, int64_t n, int cin, int y_bf16,
                   cudaStream_t stream) {
  constexpr int MAX_DEVICES = 64;
  // each device's opt-in shared memory per block and SM count, read once
  static int optin_of[MAX_DEVICES], sms_of[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (optin_of[dev] == 0) {
    int optin = 0, sms = 0;
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(zrun_conv_kernel<COUT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
    if (e != cudaSuccess) return e;
    sms_of[dev] = sms;
    optin_of[dev] = optin;
  }
  // a stage is one tap's (128 + Cout) x kc bf16: kc = Cin if two stages
  // fit, else Cin split into the fewest equal chunks (multiples of 16)
  // that do; then as many stages as fit, up to MAX_STAGES
  const int room = optin_of[dev] - FIXED_SMEM;
  int kc = cin;
  for (int chunks = 2; 2 * (BM + COUT) * kc * 2 > room && kc > 16; ++chunks)
    kc = ((cin + chunks - 1) / chunks + 15) / 16 * 16;
  const int stage_bytes = (BM + COUT) * kc * 2;
  int stages = room / stage_bytes;
  if (stages < 2) return cudaErrorInvalidValue;
  if (stages > MAX_STAGES) stages = MAX_STAGES;
  const int64_t tiles = (n + BM - 1) / BM;    // one block per SM at most
  const int sms = sms_of[dev];
  const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
  zrun_conv_kernel<COUT>
      <<<grid, THREADS, FIXED_SMEM + stages * stage_bytes, stream>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const __nv_bfloat16*>(wt),
          static_cast<const int32_t*>(zbase),
          static_cast<const int8_t*>(zcode),
          static_cast<const uint8_t*>(out_valid), y,
          static_cast<int*>(counter), n, cin, kc, stages, y_bf16);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (n, cin) bf16; wt: W (27, cin, cout) bf16 as each tap's shared-memory
// image, (cin/8, cout/8, 8, 8) with cin fastest (K-major core matrices for
// wgmma), both 16-byte aligned; zbase (n, 9) int32, zcode (n, 9, 3) int8,
// out_valid (n,) uint8 or null; y (n, cout) f32, or bf16 when y_bf16;
// counter: two int32 of the blocks' tile counter, 0 before the first
// launch; each launch leaves them 0 again, so launches that share them
// must run in stream order.  cin and cout multiples of 16, cout <= 240.
// Returns the cudaError_t of the launch (0 = success); the kernel runs on
// `stream` and is not synchronised.
int pq3d_zrun_conv(const void* x, const void* wt, const void* zbase,
                   const void* zcode, const void* out_valid, void* y,
                   void* counter, int64_t n, int cin, int cout, int y_bf16,
                   void* stream) {
  if (cin % 16 != 0 || cout % 16 != 0 || cout > 240 || cin <= 0 || n <= 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(wt) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cout) {
#define ZRUN_CASE(C) \
  case C:            \
    return static_cast<int>(                                              \
        launch<C>(x, wt, zbase, zcode, out_valid, y, counter, n, cin,     \
                  y_bf16, s));
    ZRUN_CASE(16) ZRUN_CASE(32) ZRUN_CASE(48) ZRUN_CASE(64) ZRUN_CASE(80)
    ZRUN_CASE(96) ZRUN_CASE(112) ZRUN_CASE(128) ZRUN_CASE(144)
    ZRUN_CASE(160) ZRUN_CASE(176) ZRUN_CASE(192) ZRUN_CASE(208)
    ZRUN_CASE(224) ZRUN_CASE(240)
#undef ZRUN_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
