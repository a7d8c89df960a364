// Fast text point-cloud parsing for the data loaders.
//
// The reference loads every ShapeNet-Part shape with np.loadtxt
// (data_utils/ShapeNetDataLoader.py:124), which tokenizes ~2.7k lines of
// 7 floats per shape in pure Python — the dominant host-side cost of its
// input pipeline.  This single-pass C++ parser (mmap-free, one read, a
// fixed-decimal fast path with a strtof fallback) feeds the data loader;
// Python binds it via ctypes (prifit_torch/native/__init__.py), with a
// numpy fallback when no compiler is available.  The port's copy of
// prifit_tpu/native/fastio.cpp.
//
// Build (done at first use): g++ -O3 -shared -fPIC -o _build/libfastio-<hash>.so fastio.cpp

#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// Parse all whitespace/comma/newline-separated floats in `path`.
// Writes up to max_vals floats into out; returns the number of values
// parsed (which may exceed max_vals — callers then retry with a bigger
// buffer), or -1 on I/O error.
long parse_floats_file(const char* path, float* out, long max_vals) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    char* buf = (char*)malloc(size + 1);
    if (!buf) { fclose(f); return -1; }
    long got = (long)fread(buf, 1, size, f);
    fclose(f);
    buf[got] = '\0';

    // negative powers of ten for the fixed-decimal fast path
    static const double kNegPow10[20] = {
        1e0, 1e-1, 1e-2, 1e-3, 1e-4, 1e-5, 1e-6, 1e-7, 1e-8, 1e-9,
        1e-10, 1e-11, 1e-12, 1e-13, 1e-14, 1e-15, 1e-16, 1e-17, 1e-18,
        1e-19};

    long n = 0;
    char* p = buf;
    char* end = buf + got;
    while (p < end) {
        // skip separators (spaces, commas, newlines, tabs, CR)
        while (p < end && (*p == ' ' || *p == ',' || *p == '\n' ||
                           *p == '\t' || *p == '\r')) p++;
        if (p >= end) break;

        // fast path: [+-]ddd[.ddd] — covers %.*f-formatted data;
        // anything else (exponents, nan/inf) falls back to strtof
        char* q = p;
        bool neg = false;
        if (*q == '-') { neg = true; q++; }
        else if (*q == '+') { q++; }
        double ipart = 0.0;
        int idig = 0;
        while (q < end && *q >= '0' && *q <= '9') {
            ipart = ipart * 10.0 + (*q - '0');
            q++; idig++;
        }
        double val = ipart;
        int fdig = 0;
        if (q < end && *q == '.') {
            q++;
            long frac = 0;
            while (q < end && *q >= '0' && *q <= '9' && fdig < 18) {
                frac = frac * 10 + (*q - '0');
                q++; fdig++;
            }
            val += (double)frac * kNegPow10[fdig];
        }
        bool plain_end = (q >= end || *q == ' ' || *q == ',' ||
                          *q == '\n' || *q == '\t' || *q == '\r');
        if ((idig > 0 || fdig > 0) && plain_end) {
            if (n < max_vals) out[n] = (float)(neg ? -val : val);
            n++;
            p = q;
            continue;
        }

        char* next;
        float v = strtof(p, &next);
        if (next == p) { p++; continue; }  // unparsable byte: skip
        if (n < max_vals) out[n] = v;
        n++;
        p = next;
    }
    free(buf);
    return n;
}

// Number of float values in the file (for exact pre-allocation).
long count_floats_file(const char* path) {
    return parse_floats_file(path, nullptr, 0);
}

}  // extern "C"
