// Fast fixed-width numeric field parsing for Amber file I/O.
//
// The reference delegates Amber prmtop/inpcrd parsing to parmed (pure
// Python); at production scale (100+ MB prmtops for large solvated
// systems) tokenizing fixed-width numeric records dominates load time.
// This is the framework's native data-loader core: it scans the raw bytes
// of a %FORMAT(<count><kind><width>.<prec>) section once, converting every
// <width>-character field per line, skipping newlines, with no Python
// object churn. Bound via ctypes (blues_tpu_torch/core/native.py).
//
// Built at first use by blues_tpu_torch/core/native.py:
//   g++ -O3 -shared -fPIC -o _build/libamber_io_<hash>.so amber_io.cpp

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// Parse fixed-width floating-point fields (Fortran E/F formats, including
// values like " 1.2345678E+02" and "*"-filled overflow fields -> NaN).
// data/len: raw section text (multiple lines). width: field width.
// out/max_out: output buffer. Returns number parsed, or -1 on overflow.
int64_t parse_fixed_floats(const char* data, int64_t len, int width,
                           double* out, int64_t max_out) {
  int64_t count = 0;
  int64_t i = 0;
  char buf[64];
  while (i < len) {
    // find end of line
    int64_t line_end = i;
    while (line_end < len && data[line_end] != '\n') line_end++;
    int64_t pos = i;
    while (pos + 1 <= line_end) {
      int64_t remaining = line_end - pos;
      int w = remaining < width ? (int)remaining : width;
      if (w <= 0) break;
      // skip all-blank trailing fields
      bool blank = true;
      for (int k = 0; k < w; k++) {
        if (data[pos + k] != ' ' && data[pos + k] != '\r') { blank = false; break; }
      }
      if (!blank) {
        if (count >= max_out) return -1;
        int n = w < 63 ? w : 63;
        std::memcpy(buf, data + pos, n);
        buf[n] = '\0';
        char* end = nullptr;
        double v = std::strtod(buf, &end);
        if (end == buf) {
          // Fortran overflow fields ('****') or stray text -> NaN
          v = 0.0 / 0.0;
        }
        out[count++] = v;
      }
      pos += width;
    }
    i = line_end + 1;
  }
  return count;
}

// Parse fixed-width integer fields (Fortran I format).
int64_t parse_fixed_ints(const char* data, int64_t len, int width,
                         int64_t* out, int64_t max_out) {
  int64_t count = 0;
  int64_t i = 0;
  char buf[64];
  while (i < len) {
    int64_t line_end = i;
    while (line_end < len && data[line_end] != '\n') line_end++;
    int64_t pos = i;
    while (pos + 1 <= line_end) {
      int64_t remaining = line_end - pos;
      int w = remaining < width ? (int)remaining : width;
      if (w <= 0) break;
      bool blank = true;
      for (int k = 0; k < w; k++) {
        if (data[pos + k] != ' ' && data[pos + k] != '\r') { blank = false; break; }
      }
      if (!blank) {
        if (count >= max_out) return -1;
        int n = w < 63 ? w : 63;
        std::memcpy(buf, data + pos, n);
        buf[n] = '\0';
        out[count++] = std::strtoll(buf, nullptr, 10);
      }
      pos += width;
    }
    i = line_end + 1;
  }
  return count;
}

}  // extern "C"
