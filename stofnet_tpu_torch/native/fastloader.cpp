// Fast ASCII numeric file loader — native replacement for the input
// pipeline's np.loadtxt hot path (the reference reads 3 text files per
// dataset item, datasets/chirp_dataset.py:105-107; SURVEY.md 3.1 marks this
// the disk hot path).
//
// C ABI, consumed via ctypes (stofnet_tpu_torch/native/__init__.py). All calls
// release the GIL on the Python side, so a thread pool parallelizes across
// files. Parsing uses a single read() + strtod sweep: ~20x faster than
// np.loadtxt on the small per-measurement files.
//
// Build: g++ -O3 -shared -fPIC fastloader.cpp -o libfastloader.so (done at
// first use, into build/native/ at the repository root)

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cstdint>

extern "C" {

// Parse all floating-point numbers in `path`.
// Returns the count written to `out` (up to `cap`), -1 on I/O error, or
// -2 if the file contains non-numeric garbage outside comments (silently
// skipping it would shift every later value — np.loadtxt fails loudly at
// a bad token, and so must we; the python wrapper re-parses to name the
// offending line/token). If `out` is null, only counts. `n_cols_out`
// (optional) receives the number of values on the first non-empty line
// (np.loadtxt column count).
long fastload_floats(const char* path, double* out, long cap,
                     long* n_cols_out) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    char* buf = static_cast<char*>(std::malloc(size + 1));
    if (!buf) { std::fclose(f); return -1; }
    long got = static_cast<long>(std::fread(buf, 1, size, f));
    std::fclose(f);
    buf[got] = '\0';

    // blank out '#' comments to end-of-line first (np.loadtxt semantics)
    for (char* c = buf; *c; ++c) {
        if (*c == '#') {
            while (*c && *c != '\n') *c++ = ' ';
            if (!*c) break;
        }
    }

    long n = 0;
    long first_line_end = -1;
    if (n_cols_out) {
        // find the end of the first line that carries a numeric character
        char* q = buf;
        char* line = buf;
        for (; *q; ++q) {
            if (*q == '\n') { line = q + 1; continue; }
            if ((*q >= '0' && *q <= '9') || *q == '-' || *q == '+'
                || *q == '.') break;
        }
        char* e = std::strchr(line, '\n');
        first_line_end = e ? (e - buf) : got;
        *n_cols_out = 0;
    }

    char* p = buf;
    char* end;
    bool garbage = false;
    // a UTF-8 BOM (written by some Windows editors) is not corruption
    if (got >= 3 && (unsigned char)buf[0] == 0xEF
        && (unsigned char)buf[1] == 0xBB && (unsigned char)buf[2] == 0xBF)
        p += 3;
    while (*p) {
        // skip separators: spaces, tabs, commas, newlines and other
        // control bytes; at anything else, let strtod decide — it
        // accepts digits, signs, and nan/inf spellings (np.loadtxt
        // parses nan/inf too), so only a truly unparseable byte is
        // garbage
        while (*p && (*p == ' ' || *p == '\t' || *p == ','
                      || (unsigned char)*p < 0x20)) ++p;
        if (!*p) break;
        double v = std::strtod(p, &end);
        if (end == p) { garbage = true; ++p; continue; }
        if (out) {
            if (n >= cap) break;
            out[n] = v;
        }
        if (n_cols_out && (p - buf) <= first_line_end) ++(*n_cols_out);
        ++n;
        p = end;
    }
    std::free(buf);
    if (garbage) return -2;
    return n;
}

// File size in bytes (upper bound on value count for buffer sizing).
long fastload_filesize(const char* path) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fclose(f);
    return size;
}

}  // extern "C"
