// Exact linear sum assignment (Jonker-Volgenant shortest augmenting paths)
// on the host: the CPU counterpart of csrc/hungarian.cu.
//
// Same algorithm, caps and failure rule as the CUDA kernel, and the JAX
// package's f32 operation order (pq3d_tpu/ops/hungarian.py, solve):
// red = ((lowest + cost[i]) - u[i]) - v, the argmin's lowest index wins
// ties, u[cur] += lowest before the tree's rows get lowest - min_val.  So
// col4row equals JAX's and ops/hungarian.solve_batch_reference's on every
// row, ties and padded rows included.  There is no multiply in the
// arithmetic; the file is still built with -ffp-contract=off and without
// -ffast-math (ops/hungarian.py), so the compiler may neither fuse nor
// reorder a float operation.
//
// Bounded loops: at most N Dijkstra steps an augmentation and at most R
// steps a path walk.  A lane that reaches a cap, or whose walk meets a
// column with no path or a row with no column, fails: it stops, and its
// col4row is -1 on every row.
#include <stdint.h>

#include <vector>

namespace {

constexpr float kInf = 1e30f;  // JAX's _INF
constexpr int kMaxCols = 1024;

// one lane: cost (rows, cols) -> col4row (rows,), returns the steps taken
int solve_lane(const float* cost, int rows, int cols, int* col4row_out,
               std::vector<float>& u, std::vector<float>& v,
               std::vector<int>& col4row, std::vector<int>& row4col,
               std::vector<float>& min_val, std::vector<int>& path,
               std::vector<char>& scanned) {
  u.assign(rows, 0.f);
  v.assign(cols, 0.f);
  col4row.assign(rows, -1);
  row4col.assign(cols, -1);
  int steps = 0;
  bool failed = false;
  for (int cur = 0; cur < rows && !failed; ++cur) {
    // ---- Dijkstra over columns from row cur ------------------------------
    min_val.assign(cols, kInf);
    path.assign(cols, -1);
    scanned.assign(cols, 0);
    int i = cur;
    float lowest = 0.f;
    int sink = -1;
    for (int t = 0; t < cols; ++t) {
      const float ui = u[i];
      const float* crow = cost + static_cast<int64_t>(i) * cols;
      float best = 0.f;
      int best_j = -1;
      for (int c = 0; c < cols; ++c) {
        if (!scanned[c]) {
          const float red = ((lowest + crow[c]) - ui) - v[c];
          if (red < min_val[c]) {
            min_val[c] = red;
            path[c] = i;
          }
        }
        const float m = scanned[c] ? kInf : min_val[c];
        // strict <: the lowest index wins ties (min_val is never NaN: a
        // NaN red fails red < min_val)
        if (best_j < 0 || m < best) {
          best = m;
          best_j = c;
        }
      }
      lowest = best;
      ++steps;
      scanned[best_j] = 1;
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
    u[cur] = u[cur] + lowest;
    for (int c = 0; c < cols; ++c) {
      if (scanned[c]) {
        const float d = lowest - min_val[c];
        const int r = row4col[c];
        if (r >= 0) u[r] = u[r] + d;
        v[c] = v[c] - d;
      }
    }
    // ---- augment along the path ------------------------------------------
    int s = sink;
    bool done = false;
    for (int t = 0; t < rows; ++t) {
      const int ii = path[s];
      if (ii < 0) break;
      const int prev = col4row[ii];
      row4col[s] = ii;
      col4row[ii] = s;
      if (ii == cur) {
        done = true;
        break;
      }
      if (prev < 0) break;
      s = prev;
    }
    if (!done) failed = true;
  }
  for (int r = 0; r < rows; ++r) col4row_out[r] = failed ? -1 : col4row[r];
  return steps;
}

}  // namespace

extern "C" {

// cost (lanes, rows, cols) f32, contiguous; col4row (lanes, rows) int32;
// steps (lanes,) int32 or null: each lane's Dijkstra steps.  1 <= rows <=
// cols <= 1024, lanes >= 0.  Returns 0, or 1 for shapes out of range.
int pq3d_hungarian_cpu(const float* cost, int* col4row, int* steps,
                       int64_t lanes, int rows, int cols) {
  if (lanes < 0 || rows < 1 || cols < rows || cols > kMaxCols) return 1;
  std::vector<float> u, v, min_val;
  std::vector<int> c4r, r4c, path;
  std::vector<char> scanned;
  const int64_t rn = static_cast<int64_t>(rows) * cols;
  for (int64_t l = 0; l < lanes; ++l) {
    const int st = solve_lane(cost + l * rn, rows, cols, col4row + l * rows,
                              u, v, c4r, r4c, min_val, path, scanned);
    if (steps != nullptr) steps[l] = st;
  }
  return 0;
}

}  // extern "C"
