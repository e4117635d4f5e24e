// fastio — native (C++) host parsers for the port's data loaders.
//
// A copy of dislib_tpu/native/fastio.cpp, kept apart so that the port
// imports nothing of the reference.  It is a host parser, not a device
// kernel: multi-threaded delimited-text, svmlight and AMBER-mdcrd parsers
// callable through ctypes, each thread handling a line-aligned byte range
// of the input buffer.  The parsed rows go to the card once, through the
// ds-array constructor (dislib_tpu_torch/data/io.py).
//
// Build: g++ -O3 -shared -fPIC -pthread -std=c++17 fastio.cpp -o <lib>.so,
// driven at first use by dislib_tpu_torch/native/__init__.py into
// dislib_tpu_torch/_build/.  Every entry point signals input it cannot
// parse, and the loaders then defer to NumPy, which raises the user-facing
// error.

#include <cstdlib>
#include <cstring>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

// Line-aligned [lo, hi) byte range for slice idx of count: a line belongs to
// the slice its first byte falls in (the in-buffer thread split; io.py's multi-host slab split
// uses an exact line-offset table instead).
void line_range(const char* buf, int64_t len, int idx, int count,
                int64_t* lo_out, int64_t* hi_out) {
    int64_t lo = len * (int64_t)idx / count;
    int64_t hi = len * (int64_t)(idx + 1) / count;
    if (lo > 0) {
        const char* p = (const char*)memchr(buf + lo - 1, '\n', len - lo + 1);
        lo = p ? (p - buf) + 1 : len;
    }
    if (hi < len) {
        const char* p = (const char*)memchr(buf + hi - 1, '\n', len - hi + 1);
        hi = p ? (p - buf) + 1 : len;
    }
    *lo_out = lo;
    *hi_out = hi < lo ? lo : hi;
}

struct Chunk {
    std::vector<float> vals;
    int64_t rows = 0;
    int64_t cols = -1;       // -1: unset; -2: ragged (error)
};

// Powers of ten for the fast float path (float32 output: |exp10| <= 63 with
// double intermediates is exact far beyond float32 precision).
const double kPow10[] = {
    1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,  1e8,  1e9,  1e10, 1e11,
    1e12, 1e13, 1e14, 1e15, 1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};

inline double pow10i(int e) {
    if (e >= 0)
        return e <= 22 ? kPow10[e] : __builtin_pow(10.0, e);
    return e >= -22 ? 1.0 / kPow10[-e] : __builtin_pow(10.0, e);
}

// Hand-rolled decimal float parse (locale-free, ~5-10x glibc strtof).  On
// ordinary decimal tokens sets *ok and returns one past the token; on
// anything unusual (inf/nan/hex/no digits) leaves *ok false and the caller
// falls back to strtof for that token.
inline const char* fast_float(const char* p, const char* end, float* out,
                              bool* ok) {
    const char* start = p;
    bool neg = false;
    if (p < end && (*p == '+' || *p == '-')) { neg = (*p == '-'); ++p; }
    double mant = 0.0;
    int digits = 0, exp10 = 0;
    while (p < end && *p >= '0' && *p <= '9') {
        mant = mant * 10.0 + (*p - '0');
        ++digits; ++p;
    }
    if (p < end && *p == '.') {
        ++p;
        while (p < end && *p >= '0' && *p <= '9') {
            mant = mant * 10.0 + (*p - '0');
            ++digits; --exp10; ++p;
        }
    }
    if (digits == 0 || digits > 17) { *ok = false; return start; }
    if (p < end && (*p == 'e' || *p == 'E')) {
        const char* ep = p + 1;
        bool eneg = false;
        if (ep < end && (*ep == '+' || *ep == '-')) {
            eneg = (*ep == '-'); ++ep;
        }
        int e = 0, ed = 0;
        while (ep < end && *ep >= '0' && *ep <= '9' && e < 10000) {
            e = e * 10 + (*ep - '0');
            ++ed; ++ep;
        }
        if (!ed) { *ok = false; return start; }
        exp10 += eneg ? -e : e;
        p = ep;
    }
    double v = exp10 ? mant * pow10i(exp10) : mant;
    *out = (float)(neg ? -v : v);
    *ok = true;
    return p;
}

// strtof fallback bounded to [p, eol): copies the token to a NUL-terminated
// scratch first (strtof needs termination; the buffer slice has none).
inline const char* slow_float(const char* p, const char* eol, float* out,
                              bool* ok) {
    char tmp[64];
    int w = (int)(eol - p < 63 ? eol - p : 63);
    memcpy(tmp, p, w);
    tmp[w] = '\0';
    char* q;
    *out = strtof(tmp, &q);
    *ok = (q != tmp);
    return p + (q - tmp);
}

inline bool blank_line(const char* p, const char* e) {
    for (; p < e; ++p)
        if (*p != ' ' && *p != '\t' && *p != '\r') return false;
    return true;
}

// Strict tokenization, matching np.loadtxt's contract: '#' starts a comment,
// fields are single-delimiter-separated (empty/trailing fields are errors),
// any unparseable token is an error.  Errors mark the chunk malformed
// (cols = -2) so the Python caller falls back to np.loadtxt, which raises
// the user-facing error — the native path never silently re-interprets
// input that NumPy would reject.
void parse_delim_chunk(const char* buf, int64_t lo, int64_t hi, char delim,
                       Chunk* out) {
    const char* p = buf + lo;
    const char* end = buf + hi;
    const bool ws_delim = (delim == ' ' || delim == '\t');
    while (p < end && out->cols != -2) {
        const char* nl = (const char*)memchr(p, '\n', end - p);
        const char* eol = nl ? nl : end;
        const char* cm = (const char*)memchr(p, '#', eol - p);
        const char* cend = cm ? cm : eol;        // truncate at comment
        if (!blank_line(p, cend)) {
            int64_t ncol = 0;
            const char* q = p;
            while (true) {
                while (q < cend && (*q == ' ' || *q == '\t' || *q == '\r'))
                    ++q;
                if (q >= cend) {
                    if (!ws_delim && ncol > 0) out->cols = -2;  // trailing delim
                    break;
                }
                float v;
                bool ok;
                const char* q2 = fast_float(q, cend, &v, &ok);
                if (!ok) q2 = slow_float(q, cend, &v, &ok);
                if (!ok) { out->cols = -2; break; }      // unparseable token
                out->vals.push_back(v);
                ++ncol;
                q = q2;
                while (q < cend && (*q == ' ' || *q == '\t' || *q == '\r'))
                    ++q;
                if (q >= cend) break;
                if (ws_delim) continue;                  // runs of ws = 1 sep
                if (*q != delim) { out->cols = -2; break; }
                ++q;                                     // exactly one delim
            }
            if (out->cols == -2) break;
            if (ncol > 0) {
                if (out->cols == -1) out->cols = ncol;
                else if (out->cols != ncol) out->cols = -2;
                ++out->rows;
            }
        }
        p = eol + 1;
    }
}

}  // namespace

extern "C" {

// Multi-threaded delimited-text parse.  Returns a malloc'd float32 buffer of
// rows*cols (caller frees via fastio_free); rows/cols through out-params.
// Returns nullptr with *rows = -1 on ragged rows, nullptr with *rows = 0 on
// empty input.
float* fastio_parse_text(const char* buf, int64_t len, char delim,
                         int nthreads, int64_t* rows, int64_t* cols) {
    if (nthreads < 1) nthreads = 1;
    std::vector<Chunk> chunks(nthreads);
    std::vector<std::thread> threads;
    for (int t = 0; t < nthreads; ++t) {
        int64_t lo, hi;
        line_range(buf, len, t, nthreads, &lo, &hi);
        threads.emplace_back(parse_delim_chunk, buf, lo, hi, delim,
                             &chunks[t]);
    }
    for (auto& th : threads) th.join();

    int64_t ncol = -1, nrow = 0;
    for (auto& c : chunks) {
        if (c.cols == -2 || (c.cols >= 0 && ncol >= 0 && c.cols != ncol)) {
            *rows = -1; *cols = 0;
            return nullptr;
        }
        if (c.cols >= 0) ncol = c.cols;
        nrow += c.rows;
    }
    *rows = nrow;
    *cols = ncol < 0 ? 0 : ncol;
    if (nrow == 0 || ncol <= 0) return nullptr;
    float* out = (float*)malloc(sizeof(float) * (size_t)nrow * (size_t)ncol);
    if (!out) { *rows = -1; *cols = 0; return nullptr; }
    float* w = out;
    for (auto& c : chunks) {
        memcpy(w, c.vals.data(), c.vals.size() * sizeof(float));
        w += c.vals.size();
    }
    return out;
}

// svmlight parse: single pass building CSR.  Outputs (all malloc'd, caller
// frees each via fastio_free): labels[nrows], indptr[nrows+1] (int64),
// indices[nnz] (int64, 0-based), data[nnz] (float32).  Returns 0 on success,
// -1 on malformed input.
int fastio_parse_svmlight(const char* buf, int64_t len,
                          float** labels_out, int64_t** indptr_out,
                          int64_t** indices_out, float** data_out,
                          int64_t* nrows_out, int64_t* nfeat_out) {
    std::vector<float> labels, data;
    std::vector<int64_t> indptr(1, 0), indices;
    int64_t maxfeat = 0;
    const char* p = buf;
    const char* end = buf + len;
    while (p < end) {
        const char* nl = (const char*)memchr(p, '\n', end - p);
        const char* eol = nl ? nl : end;
        while (p < eol && (*p == ' ' || *p == '\t')) ++p;
        if (p >= eol || *p == '#') { p = eol + 1; continue; }
        float y;
        bool ok;
        const char* q = fast_float(p, eol, &y, &ok);
        if (!ok) q = slow_float(p, eol, &y, &ok);
        if (!ok) return -1;
        labels.push_back(y);
        p = q;
        while (p < eol) {
            while (p < eol && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
            if (p >= eol || *p == '#') break;
            long long k = 0;
            int kd = 0;
            while (p < eol && *p >= '0' && *p <= '9') {
                k = k * 10 + (*p - '0');
                ++kd; ++p;
            }
            if (!kd || p >= eol || *p != ':') return -1;
            ++p;
            float v;
            q = fast_float(p, eol, &v, &ok);
            if (!ok) q = slow_float(p, eol, &v, &ok);
            if (!ok) return -1;
            p = q;
            indices.push_back(k - 1);              // svmlight is 1-indexed
            data.push_back(v);
            if (k > maxfeat) maxfeat = k;
        }
        indptr.push_back((int64_t)indices.size());
        p = eol + 1;
    }
    int64_t n = (int64_t)labels.size();
    *nrows_out = n;
    *nfeat_out = maxfeat;
    auto dup = [](const void* src, size_t bytes) -> void* {
        void* d = malloc(bytes ? bytes : 1);
        if (d && bytes) memcpy(d, src, bytes);
        return d;
    };
    *labels_out = (float*)dup(labels.data(), labels.size() * sizeof(float));
    *indptr_out = (int64_t*)dup(indptr.data(), indptr.size() * sizeof(int64_t));
    *indices_out = (int64_t*)dup(indices.data(),
                                 indices.size() * sizeof(int64_t));
    *data_out = (float*)dup(data.data(), data.size() * sizeof(float));
    if (!*labels_out || !*indptr_out || !*indices_out || !*data_out) return -1;
    return 0;
}

// AMBER mdcrd: fixed-width 8-char float columns after a title line.
// Returns malloc'd float32 values (count via *nvals); caller frees.
float* fastio_parse_mdcrd(const char* buf, int64_t len, int64_t* nvals) {
    const char* p = (const char*)memchr(buf, '\n', len);   // skip title
    p = p ? p + 1 : buf + len;
    const char* end = buf + len;
    std::vector<float> vals;
    vals.reserve((size_t)((end - p) / 8));
    while (p < end) {
        const char* nl = (const char*)memchr(p, '\n', end - p);
        const char* eol = nl ? nl : end;
        const char* q = p;
        while (q + 1 <= eol) {
            const char* f_end = q + 8 > eol ? eol : q + 8;
            const char* qs = q;
            while (qs < f_end && (*qs == ' ' || *qs == '\t' || *qs == '\r'))
                ++qs;
            if (qs < f_end) {                // non-blank field MUST parse —
                float v;                     // a dropped field would shift
                bool ok;                     // every later coordinate
                fast_float(qs, f_end, &v, &ok);
                if (!ok) slow_float(qs, f_end, &v, &ok);
                if (!ok) { *nvals = -2; return nullptr; }
                vals.push_back(v);
            }
            q = f_end;
        }
        p = eol + 1;
    }
    *nvals = (int64_t)vals.size();
    if (vals.empty()) return nullptr;
    float* out = (float*)malloc(vals.size() * sizeof(float));
    if (!out) { *nvals = -1; return nullptr; }
    memcpy(out, vals.data(), vals.size() * sizeof(float));
    return out;
}

void fastio_free(void* p) { free(p); }

}  // extern "C"
