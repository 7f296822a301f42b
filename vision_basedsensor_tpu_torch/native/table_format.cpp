// The body of the tracking CSV (``io/table.py:write_tracking_csv``) in one
// pass: each row is four int64 columns and seven doubles, written as
// ``%d`` and Python's ``'%.4f'`` joined by commas and ended by ``\r\n``
// (the stdlib csv writer's line end).
//
// A double below 2^53 in magnitude is split into its integer part and its
// fraction; the fraction is m * 2^-s exactly (m < 2^53), and m * 10^4 fits
// in 128 bits, so the four digits are rounded half to even on the exact
// remainder, as Python's correctly rounded formatter does. A negative value
// that rounds to zero keeps its sign ("-0.0000"). NaN prints "nan" whatever
// its sign bit (glibc would print "-nan"); infinities and larger values go
// through snprintf, which glibc rounds exactly too: "inf", "-inf", and an
// integer's full digits. Those are the "wide" values the caller counts.
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

constexpr int kInts = 4;
constexpr int kVals = 7;
// Widest field of each kind, its separator included: "-9223372036854775808,";
// a sign, 16 digits (below 2^53), '.', 4 digits and ','; a sign, the 309
// digits of DBL_MAX, '.', 4 digits and ','.
constexpr int64_t kIntWidth = 21;
constexpr int64_t kNarrowWidth = 23;
constexpr int64_t kWideWidth = 316;
constexpr double kTwo53 = 9007199254740992.0;

bool narrow(double x) { return std::fabs(x) < kTwo53; }   // false for nan

int64_t row_bound(const double* v) {
  int64_t n = kInts * kIntWidth + 1;   // +1: "\r\n" after the last field
  for (int k = 0; k < kVals; ++k) n += narrow(v[k]) ? kNarrowWidth : kWideWidth;
  return n;
}

char* put_uint(char* p, uint64_t u) {
  char tmp[20];
  int n = 0;
  do {
    tmp[n++] = static_cast<char>('0' + u % 10);
    u /= 10;
  } while (u);
  while (n) *p++ = tmp[--n];
  return p;
}

char* put_int(char* p, int64_t v) {
  if (v < 0) {
    *p++ = '-';
    return put_uint(p, 0 - static_cast<uint64_t>(v));
  }
  return put_uint(p, static_cast<uint64_t>(v));
}

char* put_double(char* p, double x, int64_t* wide) {
  if (std::isnan(x)) {
    ++*wide;
    std::memcpy(p, "nan", 3);
    return p + 3;
  }
  if (!narrow(x)) {
    ++*wide;
    return p + std::snprintf(p, kWideWidth, "%.4f", x);
  }
  if (std::signbit(x)) *p++ = '-';
  const double a = std::fabs(x);
  const double whole = std::floor(a);
  const double frac = a - whole;            // exact
  uint64_t ip = static_cast<uint64_t>(whole);
  uint32_t digits = 0;
  if (frac != 0.0) {
    int e;
    const double f = std::frexp(frac, &e);  // frac = f * 2^e, e <= 0
    const uint64_t m = static_cast<uint64_t>(std::ldexp(f, 53));
    const int s = 53 - e;                   // frac = m * 2^-s, s >= 53
    // m * 10^4 < 2^67: from s = 68 on it lies below half a unit.
    if (s < 68) {
      const unsigned __int128 n = static_cast<unsigned __int128>(m) * 10000u;
      const unsigned __int128 one = static_cast<unsigned __int128>(1) << s;
      uint64_t q = static_cast<uint64_t>(n >> s);
      const unsigned __int128 rem = n & (one - 1);
      const unsigned __int128 half = one >> 1;
      if (rem > half || (rem == half && (q & 1))) ++q;
      if (q == 10000) {
        ++ip;
        q = 0;
      }
      digits = static_cast<uint32_t>(q);
    }
  }
  p = put_uint(p, ip);
  p[0] = '.';
  p[1] = static_cast<char>('0' + digits / 1000);
  p[2] = static_cast<char>('0' + digits / 100 % 10);
  p[3] = static_cast<char>('0' + digits / 10 % 10);
  p[4] = static_cast<char>('0' + digits % 10);
  return p + 5;
}

}  // namespace

extern "C" {

// The bytes that vbs_table_format may write for these n rows of values.
int64_t vbs_table_bound(const double* vals, int64_t n) {
  int64_t total = 0;
  for (int64_t r = 0; r < n; ++r) total += row_bound(vals + r * kVals);
  return total;
}

// Writes n rows of ints (n, 4) and vals (n, 7), both C-contiguous, into out
// and returns the bytes written, or -1 if a row would pass cap (nothing past
// cap is written). *wide counts the values that took the wide path.
int64_t vbs_table_format(const int64_t* ints, const double* vals, int64_t n,
                         char* out, int64_t cap, int64_t* wide) {
  char* p = out;
  *wide = 0;
  for (int64_t r = 0; r < n; ++r) {
    const int64_t* iv = ints + r * kInts;
    const double* dv = vals + r * kVals;
    if (row_bound(dv) > cap - (p - out)) return -1;
    for (int k = 0; k < kInts; ++k) {
      p = put_int(p, iv[k]);
      *p++ = ',';
    }
    for (int k = 0; k < kVals; ++k) {
      p = put_double(p, dv[k], wide);
      *p++ = ',';
    }
    p[-1] = '\r';
    *p++ = '\n';
  }
  return p - out;
}

}  // extern "C"
