// Native Matrix Market coordinate-body tokenizer (spgpu_tpu/io/mm.py).
//
// Build: g++ -O3 -shared -fPIC -fopenmp mm_parse.cpp -o _libspgpu_native.so
// (driven by spgpu_tpu/native/__init__.py at first use).
//
// The reference reads MM files with a per-line fscanf loop
// (src/utils/mmread.cpp:63-, external/mmio.c) at ~1 MB/s-class rates; the
// r4 Python fast path (np.fromstring over the whole body) reached ~1.5M
// nnz/s single-threaded and silently tolerated misaligned bodies (ADVICE
// r4).  This pass splits the body into newline-aligned chunks, counts
// non-blank lines per chunk (prefix-sum -> output offsets), then parses
// each chunk in parallel with STRICT per-line validation: every non-blank
// line must hold exactly `ncols` tokens (2 pattern / 3 real-integer /
// 4 complex) with nothing but whitespace after them.  Any violation
// returns -1 and the caller falls back to np.loadtxt.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>
#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

static inline const char* mm_skip_ws(const char* p, const char* e) {
    while (p < e && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    return p;
}

static inline const char* mm_int(const char* p, const char* e,
                                 int64_t* out, bool* ok) {
    bool neg = false;
    if (p < e && (*p == '+' || *p == '-')) { neg = *p == '-'; ++p; }
    if (p >= e || *p < '0' || *p > '9') { *ok = false; return p; }
    int64_t v = 0;
    while (p < e && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
    *out = neg ? -v : v;
    return p;
}

// Fast decimal->double: the Clinger fast path extended through x86
// long double (64-bit mantissa).  Mantissas up to 19 digits are exact
// in long double and 10^|e| is exact for |e| <= 27, so one long-double
// multiply covers everything the repo's own %.17g writer emits; the
// residual double-rounding ambiguity is < 1 ulp (validated against
// strtod over 10M random %.17g round-trips at build time — see
// tests/test_io.py::test_fast_parse_matches_strtod).  Anything outside
// the window (20+ digits, big exponents, inf/nan, hex) falls back to
// strtod.
static const long double kPow10[] = {
    1e0L, 1e1L, 1e2L, 1e3L, 1e4L, 1e5L, 1e6L, 1e7L, 1e8L, 1e9L, 1e10L,
    1e11L, 1e12L, 1e13L, 1e14L, 1e15L, 1e16L, 1e17L, 1e18L, 1e19L,
    1e20L, 1e21L, 1e22L, 1e23L, 1e24L, 1e25L, 1e26L, 1e27L};

static inline const char* mm_double(const char* p, const char* e,
                                    double* out, bool* ok) {
    const char* p0 = p;
    bool neg = false;
    if (p < e && (*p == '+' || *p == '-')) { neg = *p == '-'; ++p; }
    uint64_t m = 0;
    int nd = 0, frac = 0;
    bool any = false, dot = false;
    while (p < e) {
        const char ch = *p;
        if (ch >= '0' && ch <= '9') {
            any = true;
            if (nd < 19) {
                m = m * 10 + (uint64_t)(ch - '0');
                if (m) ++nd;
                if (dot) ++frac;
            } else {
                goto slow;  // 20+ significant digits: strtod decides
            }
        } else if (ch == '.') {
            if (dot) goto slow;
            dot = true;
        } else {
            break;
        }
        ++p;
    }
    if (!any) goto slow;
    {
        int ex = -frac;
        if (p < e && (*p == 'e' || *p == 'E')) {
            ++p;
            bool eneg = false;
            if (p < e && (*p == '+' || *p == '-')) { eneg = *p == '-'; ++p; }
            if (p >= e || *p < '0' || *p > '9') goto slow;
            int ev = 0;
            while (p < e && *p >= '0' && *p <= '9') {
                ev = ev * 10 + (*p++ - '0');
                if (ev > 400) goto slow;
            }
            ex += eneg ? -ev : ev;
        }
        if (ex > 27 || ex < -27) goto slow;
        long double v = (long double)m;
        v = ex >= 0 ? v * kPow10[ex] : v / kPow10[-ex];
        *out = (double)(neg ? -v : v);
        return p;
    }
slow: {
        char* q;
        double d = strtod(p0, &q);
        if (q == p0) { *ok = false; return p0; }
        *out = d;
        return q;
    }
}

// parse one line starting at p (not at '\n'); returns pointer past the
// parsed line's '\n' (or e), writes fields, sets *ok=false on violation
static inline const char* mm_line(const char* p, const char* e, int nval,
                                  int64_t* r, int64_t* c, double* v,
                                  bool* ok) {
    p = mm_int(p, e, r, ok);
    if (!*ok) return e;
    p = mm_skip_ws(p, e);
    p = mm_int(p, e, c, ok);
    if (!*ok) return e;
    for (int k = 0; k < nval; ++k) {
        p = mm_skip_ws(p, e);
        p = mm_double(p, e, v + k, ok);
        if (!*ok) return e;
    }
    p = mm_skip_ws(p, e);
    if (p < e && *p != '\n') { *ok = false; return e; }
    return p < e ? p + 1 : e;
}

int64_t mm_parse(const char* buf, int64_t len, int64_t ntok,
                 int64_t max_entries, int64_t* rows, int64_t* cols,
                 double* vals) {
    const int nval = (int)(ntok - 2);
    int nt = 1;
#ifdef _OPENMP
    nt = omp_get_max_threads();
    if (nt > 16) nt = 16;
#endif
    if (nt < 1) nt = 1;
    // newline-aligned chunk starts
    std::vector<int64_t> start(nt + 1, 0);
    start[nt] = len;
    for (int t = 1; t < nt; ++t) {
        int64_t s = len * t / nt;
        // s can be 0 when len < nt: buf[s-1] would read one byte
        // BEFORE the buffer (review r5); chunk boundaries at 0 are
        // already newline-aligned by definition
        while (s > 0 && s < len && buf[s - 1] != '\n') ++s;
        start[t] = s;
    }
    for (int t = 1; t < nt; ++t)
        if (start[t] < start[t - 1]) start[t] = start[t - 1];
    // pass 1: count non-blank lines per chunk
    std::vector<int64_t> cnt(nt, 0);
#ifdef _OPENMP
#pragma omp parallel for num_threads(nt) schedule(static, 1)
#endif
    for (int t = 0; t < nt; ++t) {
        const char* p = buf + start[t];
        const char* e = buf + start[t + 1];
        int64_t n = 0;
        while (p < e) {
            const char* q = mm_skip_ws(p, e);
            if (q < e && *q != '\n') ++n;
            const char* nl = (const char*)memchr(q, '\n', e - q);
            p = nl ? nl + 1 : e;
        }
        cnt[t] = n;
    }
    std::vector<int64_t> off(nt + 1, 0);
    for (int t = 0; t < nt; ++t) off[t + 1] = off[t] + cnt[t];
    if (off[nt] > max_entries) return -1;
    // pass 2: strict parse into the prefix offsets
    bool all_ok = true;
#ifdef _OPENMP
#pragma omp parallel for num_threads(nt) schedule(static, 1)
#endif
    for (int t = 0; t < nt; ++t) {
        const char* p = buf + start[t];
        const char* e = buf + start[t + 1];
        int64_t i = off[t];
        bool ok = true;
        while (p < e && ok) {
            p = mm_skip_ws(p, e);
            if (p >= e) break;
            if (*p == '\n') { ++p; continue; }
            double v[2] = {0.0, 0.0};
            p = mm_line(p, e, nval, rows + i, cols + i, v, &ok);
            if (!ok) break;
            if (nval >= 1) vals[i * (nval > 1 ? 2 : 1)] = v[0];
            if (nval == 2) vals[i * 2 + 1] = v[1];
            ++i;
        }
        if (!ok)
#ifdef _OPENMP
#pragma omp atomic write
#endif
            all_ok = false;
    }
    if (!all_ok) return -1;
    return off[nt];
}

}  // extern "C"
