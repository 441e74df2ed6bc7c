// Exact linear sum assignment (Jonker-Volgenant shortest augmenting paths),
// one warp per problem, for Hopper (sm_90a).
//
// Replaces no Pallas kernel.  It is the counterpart of the JAX package's
// on-device solver pq3d_tpu/ops/hungarian.py (solve, :28-113), which is a
// lax.scan over rows around two lax.while_loops (Dijkstra over columns,
// then the walk back along the path), vmapped over lanes.  The stage-1 set
// loss matches every (round, scene) with it, so the train step never reads
// the card back; without this kernel the port copied the costs to the host
// for scipy every step.
//
// What bounds it on this card: the chain of dependent steps, not bytes.
// The function reads L x R x N f32 costs once (52 x 120 x 120 at full
// width: 3.0 MB, about 0.9 us at 3.35 TB/s), but each Dijkstra step needs
// the argmin of the step before it (the next row to scan), so a lane is a
// chain of some 900 steps on random costs and up to R^2 / 2 when every
// column ties (a round whose queries are all the same).  A step's latency
// is one cost-row read plus a warp reduction.  The design:
//   * one warp per lane (a 32-thread block, one block a lane): a step is
//     warp-synchronous, with no block barrier;
//   * v, min_val, path and the scanned bits live in registers, column
//     c = 32 k + lane in slot k of ceil(N / 32) (a power of two, CPT), so a
//     row is read by the warp as CPT coalesced 128-byte lines;
//   * u, col4row and row4col live in shared memory (read as broadcasts);
//   * the lane's R x N costs are staged in shared memory when they fit
//     (57.6 KB at 120 x 120, above the 48 KB default: the launch opts in),
//     so a step reads shared memory; else each row is read from global
//     memory, where it stays in L2;
//   * the argmin is a butterfly of (value, index) pairs ordered
//     lexicographically, so the lowest index wins ties (jnp.argmin's rule)
//     and every thread ends with the same pair;
//   * adds and subtracts are pinned with __fadd_rn / __fsub_rn to JAX's
//     order, red = ((lowest + cost[i]) - u[i]) - v, so col4row equals the
//     plain version's (ops/hungarian.solve_batch_reference) on every row.
// Bounded loops: at most N Dijkstra steps an augmentation and at most R
// steps a path walk.  With finite costs a correct run never reaches them;
// with non-finite costs JAX's while_loop can spin forever.  A lane that
// reaches a cap, or whose walk meets a column with no path or a row with no
// column, fails: it stops, and its col4row is -1 on every row.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 1e30f;       // JAX's _INF
constexpr int kMaxCols = 1024;      // 32 columns a thread
constexpr int kSmemLimit = 232448;  // 227 KB a block

template <int CPT, bool STAGED>
__global__ void __launch_bounds__(32)
hungarian_kernel(const float* __restrict__ cost, int rows, int cols,
                 int* __restrict__ col4row_out, int* __restrict__ steps_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t lane_id = blockIdx.x;
  const int lane = threadIdx.x;
  const int64_t rn = static_cast<int64_t>(rows) * cols;
  const float* gcost = cost + lane_id * rn;
  float* scost = reinterpret_cast<float*>(smem);  // rn floats when staged
  float* u = scost + (STAGED ? rn : 0);
  int* col4row = reinterpret_cast<int*>(u + rows);
  int* row4col = col4row + rows;
  for (int r = lane; r < rows; r += 32) {
    u[r] = 0.f;
    col4row[r] = -1;
  }
  for (int c = lane; c < cols; c += 32) row4col[c] = -1;
  const float* costs = gcost;
  if (STAGED) {
    if (rn % 4 == 0 && reinterpret_cast<uintptr_t>(gcost) % 16 == 0) {
      const float4* src = reinterpret_cast<const float4*>(gcost);
      float4* dst = reinterpret_cast<float4*>(scost);
#pragma unroll 8
      for (int64_t e = lane; e < rn / 4; e += 32) dst[e] = src[e];
    } else {
#pragma unroll 8
      for (int64_t e = lane; e < rn; e += 32) scost[e] = gcost[e];
    }
    costs = scost;
  }
  __syncwarp();

  float v[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) v[k] = 0.f;
  int steps = 0;
  bool failed = false;
  for (int cur = 0; cur < rows && !failed; ++cur) {
    // ---- Dijkstra over columns from row cur ------------------------------
    float min_val[CPT];
    int path[CPT];
    uint32_t scanned = 0;  // bit k: column 32 k + lane
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      min_val[k] = kInf;
      path[k] = -1;
    }
    int i = cur;
    float lowest = 0.f;
    int sink = -1;
    for (int t = 0; t < cols; ++t) {
      const float ui = u[i];
      const float* crow = costs + static_cast<int64_t>(i) * cols;
      float best = __int_as_float(0x7f800000);  // +inf: no column
      int best_j = 0x7fffffff;
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        const int c = k * 32 + lane;
        if (c < cols) {
          const float red =
              __fsub_rn(__fsub_rn(__fadd_rn(lowest, crow[c]), ui), v[k]);
          const bool sc = (scanned >> k) & 1u;
          if (!sc && red < min_val[k]) {
            min_val[k] = red;
            path[k] = i;
          }
          const float m = sc ? kInf : min_val[k];
          if (m < best) {  // k rises with c: the lowest index wins ties
            best = m;
            best_j = c;
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int oj = __shfl_xor_sync(0xffffffffu, best_j, off);
        if (ob < best || (ob == best && oj < best_j)) {
          best = ob;
          best_j = oj;
        }
      }
      lowest = best;
      ++steps;
      if ((best_j & 31) == lane) scanned |= 1u << (best_j >> 5);
      const int nxt = row4col[best_j];
      if (nxt < 0) {
        sink = best_j;
        break;
      }
      i = nxt;
    }
    if (sink < 0) {
      failed = true;
      break;
    }
    // ---- dual update: u[cur] first, then the tree's rows and columns -----
    if (lane == 0) u[cur] = __fadd_rn(u[cur], lowest);
    __syncwarp();
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int c = k * 32 + lane;
      if (c < cols && ((scanned >> k) & 1u)) {
        const float d = __fsub_rn(lowest, min_val[k]);
        const int r = row4col[c];
        if (r >= 0) u[r] = __fadd_rn(u[r], d);
        v[k] = __fsub_rn(v[k], d);
      }
    }
    __syncwarp();
    // ---- augment along the path ------------------------------------------
    int s = sink;
    bool done = false;
    for (int t = 0; t < rows; ++t) {
      int ps = -1;
#pragma unroll
      for (int k = 0; k < CPT; ++k)
        if (k == (s >> 5)) ps = path[k];
      const int ii = __shfl_sync(0xffffffffu, ps, s & 31);
      if (ii < 0) break;
      const int prev = col4row[ii];
      __syncwarp();
      if (lane == 0) {
        row4col[s] = ii;
        col4row[ii] = s;
      }
      __syncwarp();
      if (ii == cur) {
        done = true;
        break;
      }
      if (prev < 0) break;
      s = prev;
    }
    if (!done) failed = true;
  }
  __syncwarp();
  for (int r = lane; r < rows; r += 32)
    col4row_out[lane_id * rows + r] = failed ? -1 : col4row[r];
  if (steps_out != nullptr && lane == 0) steps_out[lane_id] = steps;
}

template <int CPT, bool STAGED>
cudaError_t launch(const float* cost, int* col4row, int* steps,
                   int64_t lanes, int rows, int cols, size_t smem,
                   cudaStream_t stream) {
  auto kernel = hungarian_kernel<CPT, STAGED>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<static_cast<unsigned>(lanes), 32, smem, stream>>>(
      cost, rows, cols, col4row, steps);
  return cudaGetLastError();
}

template <bool STAGED>
cudaError_t dispatch(const float* cost, int* col4row, int* steps,
                     int64_t lanes, int rows, int cols, size_t smem,
                     cudaStream_t stream) {
  const int cpt = (cols + 31) / 32;
  if (cpt <= 1)
    return launch<1, STAGED>(cost, col4row, steps, lanes, rows, cols, smem,
                             stream);
  if (cpt <= 2)
    return launch<2, STAGED>(cost, col4row, steps, lanes, rows, cols, smem,
                             stream);
  if (cpt <= 4)
    return launch<4, STAGED>(cost, col4row, steps, lanes, rows, cols, smem,
                             stream);
  if (cpt <= 8)
    return launch<8, STAGED>(cost, col4row, steps, lanes, rows, cols, smem,
                             stream);
  if (cpt <= 16)
    return launch<16, STAGED>(cost, col4row, steps, lanes, rows, cols, smem,
                              stream);
  return launch<32, STAGED>(cost, col4row, steps, lanes, rows, cols, smem,
                            stream);
}

}  // namespace

extern "C" {

// cost (lanes, rows, cols) f32, contiguous; col4row (lanes, rows) int32;
// steps (lanes,) int32 or null: each lane's Dijkstra steps.  1 <= rows <=
// cols <= 1024, 1 <= lanes < 2^31.  stage: 1 copies each lane's costs to
// shared memory (they must fit, with u, col4row and row4col, in 227 KB),
// 0 reads them from global memory.  Returns the cudaError_t of the launch
// (0 = success); the kernel runs on `stream` and is not synchronised.
int pq3d_hungarian(const void* cost, void* col4row, void* steps,
                   int64_t lanes, int rows, int cols, int stage,
                   void* stream) {
  if (rows < 1 || cols < rows || cols > kMaxCols || lanes < 1 ||
      lanes > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t table = (2 * static_cast<size_t>(rows) + cols) * 4;
  const size_t staged =
      table + static_cast<size_t>(rows) * static_cast<size_t>(cols) * 4;
  if (stage && staged > static_cast<size_t>(kSmemLimit))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* c = static_cast<const float*>(cost);
  int* out = static_cast<int*>(col4row);
  int* st = static_cast<int*>(steps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      stage ? dispatch<true>(c, out, st, lanes, rows, cols, staged, s)
            : dispatch<false>(c, out, st, lanes, rows, cols, table, s));
}

}  // extern "C"
