// Native host-side kernel-map building for the sparse-conv pipeline of
// pq3d_tpu_torch (a copy of pq3d_tpu/csrc/kernel_maps.cpp; the port keeps
// its own so that it imports nothing of the JAX package).
//
// Replaces the coordinate machinery MinkowskiEngine runs in C++/CUDA on the
// reference side (kernel-map construction for gather-GEMM sparse
// convolutions).  The numpy fallback in ops/kernel_maps.py emulates a hash
// with dense int32 grids, an O(volume) allocation per scan.  Here: one
// open-addressing hash over packed 21-bit coords, linear probing, and
// direct writes into caller-allocated padded outputs.
//
// Exposed as a plain C ABI consumed via ctypes.
#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {

// pack signed coords into a 64-bit key (21 bits per axis, bias 2^20)
inline uint64_t pack(int32_t x, int32_t y, int32_t z) {
    const uint64_t B = 1u << 20;
    return ((uint64_t)(uint32_t)(x + B) << 42) |
           ((uint64_t)(uint32_t)(y + B) << 21) |
           (uint64_t)(uint32_t)(z + B);
}

inline uint64_t hash_key(uint64_t k) {
    // splitmix64 finalizer
    k += 0x9e3779b97f4a7c15ull;
    k = (k ^ (k >> 30)) * 0xbf58476d1ce4e5b9ull;
    k = (k ^ (k >> 27)) * 0x94d049bb133111ebull;
    return k ^ (k >> 31);
}

struct CoordHash {
    std::vector<uint64_t> keys;
    std::vector<int32_t> vals;
    uint64_t mask;

    explicit CoordHash(int64_t n) {
        uint64_t cap = 16;
        while (cap < (uint64_t)(n * 2 + 4)) cap <<= 1;
        keys.assign(cap, ~0ull);
        vals.assign(cap, -1);
        mask = cap - 1;
    }

    inline void insert(uint64_t key, int32_t v) {
        uint64_t i = hash_key(key) & mask;
        while (keys[i] != ~0ull) {
            if (keys[i] == key) { vals[i] = v; return; }
            i = (i + 1) & mask;
        }
        keys[i] = key;
        vals[i] = v;
    }

    inline int32_t find(uint64_t key) const {
        uint64_t i = hash_key(key) & mask;
        while (keys[i] != ~0ull) {
            if (keys[i] == key) return vals[i];
            i = (i + 1) & mask;
        }
        return -1;
    }
};

}  // namespace

extern "C" {

// coords (n,3) int32 -> out (n_pad, k) int32 neighbor map (-1 missing;
// rows >= n are all -1).  offsets (k,3) int32.
//
// Fast path: hierarchy levels arrive sorted by packed key (quantize /
// downsample emit ascending-key order), and pack() is linear — the key of
// coord+offset is key+delta with a per-tap constant delta (field arithmetic
// is exact while each axis stays in its 21-bit range).  Each tap then
// resolves by a sequential two-pointer merge of the sorted keys against
// their delta-shifted selves instead of k random hash probes per row:
// ~7.5M scattered lookups for the 125-tap conv0 map at 60k voxels become
// 125 streaming passes.  Rows are tiled so the output block stays in cache
// across taps.  Unsorted input falls back to the hash.
void pq3d_neighbor_map(const int32_t* coords, int64_t n,
                       const int32_t* offsets, int64_t k,
                       int64_t n_pad, int32_t* out) {
    if (n > 0) {
        std::vector<uint64_t> key(n);
        bool sorted = true;
        for (int64_t i = 0; i < n; ++i) {
            key[i] = pack(coords[3 * i], coords[3 * i + 1],
                          coords[3 * i + 2]);
            if (i && key[i] <= key[i - 1]) sorted = false;
        }
        if (sorted) {
            const int64_t TILE = 2048;  // out tile ~1 MB at k=125
            for (int64_t b0 = 0; b0 < n; b0 += TILE) {
                const int64_t b1 = std::min(b0 + TILE, n);
                for (int64_t j = 0; j < k; ++j) {
                    const int64_t d =
                        ((int64_t)offsets[3 * j] << 42) +
                        ((int64_t)offsets[3 * j + 1] << 21) +
                        (int64_t)offsets[3 * j + 2];
                    const uint64_t t0 = (uint64_t)((int64_t)key[b0] + d);
                    int64_t p = std::lower_bound(key.begin(), key.end(), t0)
                                - key.begin();
                    for (int64_t i = b0; i < b1; ++i) {
                        const uint64_t t = (uint64_t)((int64_t)key[i] + d);
                        while (p < n && key[p] < t) ++p;
                        out[i * k + j] =
                            (p < n && key[p] == t) ? (int32_t)p : -1;
                    }
                }
            }
        } else {
            CoordHash h(n);
            for (int64_t i = 0; i < n; ++i) h.insert(key[i], (int32_t)i);
            for (int64_t i = 0; i < n; ++i) {
                const int32_t x = coords[3 * i], y = coords[3 * i + 1],
                              z = coords[3 * i + 2];
                int32_t* row = out + i * k;
                for (int64_t j = 0; j < k; ++j)
                    row[j] = h.find(pack(x + offsets[3 * j],
                                         y + offsets[3 * j + 1],
                                         z + offsets[3 * j + 2]));
            }
        }
    }
    if (n_pad > n)
        std::memset(out + n * k, 0xff, (size_t)(n_pad - n) * k * 4);
}

// stride-2 downsample: coords (n,3) -> unique floor(c/2) coarse coords in
// ascending packed-key order (matches the numpy sort-by-key ordering for
// memory locality), parent index and 8-way offset id per fine voxel.
// Returns n_coarse.  coarse must hold n*3; parent n; off n.
int64_t pq3d_downsample(const int32_t* coords, int64_t n,
                        int32_t* coarse, int32_t* parent, int32_t* off) {
    std::vector<uint64_t> ck(n);
    for (int64_t i = 0; i < n; ++i) {
        // floor division for negatives
        int32_t cx = coords[3 * i] >> 1;
        int32_t cy = coords[3 * i + 1] >> 1;
        int32_t cz = coords[3 * i + 2] >> 1;
        ck[i] = pack(cx, cy, cz);
        off[i] = (int32_t)(((coords[3 * i] & 1) << 2) |
                           ((coords[3 * i + 1] & 1) << 1) |
                           (coords[3 * i + 2] & 1));
    }
    std::vector<uint64_t> uniq(ck);
    std::sort(uniq.begin(), uniq.end());
    uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());
    const int64_t m = (int64_t)uniq.size();
    CoordHash h(m);
    const uint64_t B = 1u << 20;
    for (int64_t i = 0; i < m; ++i) {
        h.insert(uniq[i], (int32_t)i);
        coarse[3 * i] = (int32_t)((uniq[i] >> 42) & 0x1fffff) - B;
        coarse[3 * i + 1] = (int32_t)((uniq[i] >> 21) & 0x1fffff) - B;
        coarse[3 * i + 2] = (int32_t)(uniq[i] & 0x1fffff) - B;
    }
    for (int64_t i = 0; i < n; ++i) parent[i] = h.find(ck[i]);
    return m;
}

// Farthest-point sampling: pts (n,3) float32 -> out (m,) int64 indices.
// Exact iterative FPS (the Python caller applies candidate subsampling for
// the approximate large-cloud mode before calling in).
void pq3d_fps(const float* pts, int64_t n, int64_t m, int64_t start,
              int64_t* out) {
    if (n <= 0 || m <= 0) return;
    std::vector<float> mind(n, 3.4e38f);
    int64_t last = start % n;
    for (int64_t i = 0; i < m; ++i) {
        out[i] = last;
        const float x = pts[3 * last], y = pts[3 * last + 1],
                    z = pts[3 * last + 2];
        float best = -1.f;
        int64_t arg = 0;
        for (int64_t p = 0; p < n; ++p) {
            const float dx = pts[3 * p] - x, dy = pts[3 * p + 1] - y,
                        dz = pts[3 * p + 2] - z;
            const float d = dx * dx + dy * dy + dz * dz;
            if (d < mind[p]) mind[p] = d;
            if (mind[p] > best) { best = mind[p]; arg = p; }
        }
        last = arg;
    }
}

}  // extern "C"
