// ELL bucket fill (native host tooling, OpenMP).
//
// The padded-ELL layout's fill loop (data/ell.py _fill_side) copies each
// entity's CSR/CSC segment into its lane span and maps neighbor entity ids to
// the other side's slot ids. In Python that is a per-entity loop — minutes at
// Netflix-100M scale; here it is a bandwidth-bound parallel copy.
//
// C ABI (ctypes-bound from ../ellfill.py): one call fills one bucket of one
// orientation. Layout contract mirrors data/ell.py EllBucket: physical row
// r = s * rows_per_shard + j / p holds slot j of shard s in lanes
// [(j % p) * E, (j % p + 1) * E); out arrays are (num_shards*rows_per_shard, L)
// pre-sized by the caller and are fully overwritten here (pad -> zero_slot/0).

#include <cstdint>

extern "C" {

void crtpu_ell_fill(const int64_t* ptr,          // (n_entities + 1) CSR/CSC ptr
                    const int32_t* nbr_idx,      // (nnz) neighbor entity ids
                    const float* nbr_val,        // (nnz) ratings
                    const int32_t* other_slot,   // (n_other_entities) id->slot
                    const int64_t* grid,         // (num_shards, slots_ps), -1 pad
                    int64_t num_shards, int64_t slots_ps,
                    int64_t E, int64_t p, int64_t rows_per_shard, int64_t L,
                    int32_t zero_slot,
                    int32_t* out_idx,            // (num_shards*rows_per_shard, L)
                    float* out_val) {
#pragma omp parallel for collapse(2) schedule(static)
    for (int64_t s = 0; s < num_shards; s++) {
        for (int64_t j = 0; j < slots_ps; j++) {
            const int64_t r = s * rows_per_shard + j / p;
            const int64_t c0 = (j % p) * E;
            int32_t* oi = out_idx + r * L + c0;
            float* ov = out_val + r * L + c0;
            const int64_t e = grid[s * slots_ps + j];
            int64_t d = 0;
            if (e >= 0) {
                const int64_t lo = ptr[e], hi = ptr[e + 1];
                d = hi - lo;
                for (int64_t t = 0; t < d; t++) {
                    oi[t] = other_slot[nbr_idx[lo + t]];
                    ov[t] = nbr_val[lo + t];
                }
            }
            for (int64_t t = d; t < E; t++) {
                oi[t] = zero_slot;
                ov[t] = 0.0f;
            }
        }
    }
}

}  // extern "C"
