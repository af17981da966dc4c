// Native host-side loader core — the C++ rebuild of the reference's
// native surface (SURVEY.md §3.2: device PRNG kernels; §4.1: Loader's
// fill_minibatch as the host-side hot-loop bottleneck).
//
// Exposed via ctypes (the reference bound its native pieces the same
// way — pure-Python ctypes wrappers, no pybind).  Three primitives:
//   - xorshift128+ uniform fill (the reference's PRNG family),
//   - Fisher-Yates shuffle of int64 indices,
//   - multithreaded row gather (minibatch assembly from a full-batch
//     dataset: dst[i] = src[idx[i]]), the fill_minibatch kernel.
//
// Build: g++ -O3 -march=native -shared -fPIC (driven by
// znicz_tpu/native/__init__.py, cached by source hash).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// xorshift128+ (Vigna 2014) — the reference's random.cl/random.cu family.
static inline uint64_t xs128p_next(uint64_t *s) {
    uint64_t x = s[0];
    uint64_t const y = s[1];
    s[0] = y;
    x ^= x << 23;
    s[1] = x ^ y ^ (x >> 17) ^ (y >> 26);
    return s[1] + y;
}

// Fill out[0..n) with uniforms in [0, 1).
void xorshift128p_fill(uint64_t *state, float *out, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        out[i] = (float)((xs128p_next(state) >> 11) *
                         (1.0 / 9007199254740992.0));
    }
}

// In-place Fisher-Yates over int64 indices.
void shuffle_indices(uint64_t *state, int64_t *idx, int64_t n) {
    for (int64_t i = n - 1; i > 0; --i) {
        int64_t j = (int64_t)(xs128p_next(state) % (uint64_t)(i + 1));
        int64_t tmp = idx[i];
        idx[i] = idx[j];
        idx[j] = tmp;
    }
}

// dst[i, :] = src[idx[i], :] for i in [0, n_rows); idx < 0 rows zero-fill
// (the loader's tail-padding convention).  row_bytes covers any dtype.
void gather_rows(const char *src, const int64_t *idx, char *dst,
                 int64_t n_rows, int64_t row_bytes, int n_threads) {
    if (n_threads < 1) n_threads = 1;
    auto work = [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
            if (idx[i] < 0) {
                memset(dst + i * row_bytes, 0, (size_t)row_bytes);
            } else {
                memcpy(dst + i * row_bytes, src + idx[i] * row_bytes,
                       (size_t)row_bytes);
            }
        }
    };
    if (n_threads == 1 || n_rows < 64) {
        work(0, n_rows);
        return;
    }
    std::vector<std::thread> threads;
    int64_t chunk = (n_rows + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        int64_t lo = t * chunk;
        int64_t hi = lo + chunk < n_rows ? lo + chunk : n_rows;
        if (lo >= hi) break;
        threads.emplace_back(work, lo, hi);
    }
    for (auto &th : threads) th.join();
}

}  // extern "C"
