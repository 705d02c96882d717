// Parallel stable counting sort over small integer keys (native host tooling).
//
// Two host-side hot paths reduce to "group nnz-sized arrays by a bounded
// int key": building the dual CSR+CSC containers from COO triples
// (data/sparse.py from_coo — the reference preconverts offline for the same
// reason, reference src/tools.cpp:3-85), and splitting the rating COO
// into dense panels + sparse remainder for the hybrid backend
// (solvers/ccd_hybrid.py plan_hybrid). NumPy's stable argsort over 100M
// int64 keys costs tens of seconds; a two-pass OpenMP counting sort is
// bandwidth-bound (~1-2 s at Netflix-100M on 4 cores).
//
// C ABI (ctypes-bound from ../groupsort.py). Keys must lie in [0, nkeys).
// Equal keys keep their input order (stable), so the permutation is
// deterministic and byte-identical to np.argsort(keys, kind="stable").

#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#else
static int omp_get_max_threads() { return 1; }
static int omp_get_thread_num() { return 0; }
#endif

extern "C" {

// counts[k] = |{i : keys[i] == k}|. counts is (nkeys) and is overwritten.
void crtpu_key_count(const int32_t* keys, int64_t nnz, int64_t nkeys,
                     int64_t* counts) {
    const int T = omp_get_max_threads();
    std::vector<int64_t> part((size_t)T * (size_t)nkeys, 0);
#pragma omp parallel num_threads(T)
    {
        const int t = omp_get_thread_num();
        const int64_t lo = nnz * t / T, hi = nnz * (t + 1) / T;
        int64_t* c = part.data() + (size_t)t * (size_t)nkeys;
        for (int64_t i = lo; i < hi; i++) c[keys[i]]++;
    }
#pragma omp parallel for schedule(static)
    for (int64_t k = 0; k < nkeys; k++) {
        int64_t s = 0;
        for (int t = 0; t < T; t++) s += part[(size_t)t * (size_t)nkeys + k];
        counts[k] = s;
    }
}

// Stable counting-sort permutation. On return:
//   ptr (nkeys+1): exclusive prefix sums — group k occupies
//                  perm[ptr[k]:ptr[k+1]] in input order.
//   perm (nnz) int64: keys[perm] is sorted ascending, ties in input order.
void crtpu_stable_perm(const int32_t* keys, int64_t nnz, int64_t nkeys,
                       int64_t* ptr, int64_t* perm) {
    const int T = omp_get_max_threads();
    // pass 1: per-thread histograms over contiguous chunks
    std::vector<int64_t> part((size_t)T * (size_t)nkeys, 0);
#pragma omp parallel num_threads(T)
    {
        const int t = omp_get_thread_num();
        const int64_t lo = nnz * t / T, hi = nnz * (t + 1) / T;
        int64_t* c = part.data() + (size_t)t * (size_t)nkeys;
        for (int64_t i = lo; i < hi; i++) c[keys[i]]++;
    }
    // exclusive prefix over (key, thread) in key-major, thread-minor order:
    // chunk t's slice of key k starts right after chunks t' < t of the same
    // key — this is what makes the sort stable across chunk boundaries.
    int64_t run = 0;
    for (int64_t k = 0; k < nkeys; k++) {
        ptr[k] = run;
        for (int t = 0; t < T; t++) {
            const size_t at = (size_t)t * (size_t)nkeys + k;
            const int64_t v = part[at];
            part[at] = run;
            run += v;
        }
    }
    ptr[nkeys] = run;
    // pass 2: scatter — each thread walks its chunk in order, bumping its
    // own per-key cursor, so within a chunk ties stay in input order too.
    #pragma omp parallel num_threads(T)
    {
        const int t = omp_get_thread_num();
        const int64_t lo = nnz * t / T, hi = nnz * (t + 1) / T;
        int64_t* off = part.data() + (size_t)t * (size_t)nkeys;
        for (int64_t i = lo; i < hi; i++) perm[off[keys[i]]++] = i;
    }
}

// Fused gather of the (idx, val) payload through a permutation:
// out_idx[i] = idx[perm[i]] (int32), out_val[i] = val[perm[i]].
// Saves two 100M-element NumPy fancy-gather passes per orientation.
void crtpu_perm_gather(const int64_t* perm, int64_t nnz,
                       const int32_t* idx, const float* val,
                       int32_t* out_idx, float* out_val) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < nnz; i++) {
        const int64_t p = perm[i];
        out_idx[i] = idx[p];
        out_val[i] = val[p];
    }
}

}  // extern "C"
