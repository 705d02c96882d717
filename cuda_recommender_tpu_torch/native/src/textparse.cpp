// Fast text-ratings parser (native host tooling).
//
// The reference consumes pre-converted binary dumps and reads text test files
// with fscanf one value at a time (reference src/pmf_util.h:155-168).
// This is the TPU-era offline converter's hot path: parse
// "user item rating [extra...]" lines at memory bandwidth instead of
// fscanf/np.loadtxt speed (np.loadtxt is ~50x slower on 100M-line dumps).
//
// C ABI (ctypes-bound from ../textparse.py):
//   crtpu_parse_ratings(path, one_based, capacity, rows, cols, vals) -> n
//     parses up to `capacity` triples into caller-allocated buffers,
//     returning the number parsed, or -1 if the file cannot be read.
//     Lines with fewer than three numeric fields are skipped.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// Read the whole file into a NUL-terminated buffer.
char* slurp(const char* path, size_t* len_out) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return nullptr;
    std::fseek(f, 0, SEEK_END);
    long len = std::ftell(f);
    if (len < 0) { std::fclose(f); return nullptr; }
    std::fseek(f, 0, SEEK_SET);
    char* buf = static_cast<char*>(std::malloc(static_cast<size_t>(len) + 1));
    if (!buf) { std::fclose(f); return nullptr; }
    size_t got = std::fread(buf, 1, static_cast<size_t>(len), f);
    std::fclose(f);
    buf[got] = '\0';
    *len_out = got;
    return buf;
}

}  // namespace

extern "C" {

long long crtpu_count_lines(const char* path) {
    size_t len = 0;
    char* buf = slurp(path, &len);
    if (!buf) return -1;
    long long n = 0;
    for (size_t i = 0; i < len; i++) n += (buf[i] == '\n');
    if (len && buf[len - 1] != '\n') n++;
    std::free(buf);
    return n;
}

long long crtpu_parse_ratings(const char* path, int one_based,
                              long long capacity, long long* rows,
                              long long* cols, float* vals) {
    size_t len = 0;
    char* buf = slurp(path, &len);
    if (!buf) return -1;
    const long long base = one_based ? 1 : 0;
    long long n = 0;
    char* p = buf;
    char* end = buf + len;
    while (p < end && n < capacity) {
        char* next = static_cast<char*>(std::memchr(p, '\n', end - p));
        char* line_end = next ? next : end;
        char* q = p;
        char* q2;
        long long u = std::strtoll(q, &q2, 10);
        if (q2 != q && q2 <= line_end) {
            q = q2;
            long long it = std::strtoll(q, &q2, 10);
            if (q2 != q && q2 <= line_end) {
                q = q2;
                float v = std::strtof(q, &q2);
                if (q2 != q && q2 <= line_end) {
                    rows[n] = u - base;
                    cols[n] = it - base;
                    vals[n] = v;
                    n++;
                }
            }
        }
        p = next ? next + 1 : end;
    }
    std::free(buf);
    return n;
}

}  // extern "C"
