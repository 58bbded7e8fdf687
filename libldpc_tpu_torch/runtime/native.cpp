// Native host runtime of libldpc_tpu_torch.
//
// Two host-side jobs of the reference's C++ layer, kept native for speed on
// large codes: codefile parsing (one read of the file and a branch-light
// integer scanner) and the rank of a GF(2) matrix (word-parallel Gaussian
// elimination on bit-packed rows).  Plain C interface, loaded with ctypes.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <utility>
#include <vector>

extern "C" {

// Parse the "row col [val]" integer pairs of a codefile, skipping every line
// that contains ':' (the header lines of both dialects) and every line whose
// first two fields are not integers.  Writes up to `cap` pairs into
// rows/cols; returns the number of pairs, -1 on an I/O error, -2 when there
// are more than `cap` pairs.
long long ldpc_parse_pairs(const char *path, int32_t *rows, int32_t *cols,
                           long long cap) {
  FILE *f = fopen(path, "rb");
  if (!f) return -1;
  if (fseek(f, 0, SEEK_END) != 0) {
    fclose(f);
    return -1;
  }
  long size = ftell(f);
  if (size < 0 || fseek(f, 0, SEEK_SET) != 0) {
    fclose(f);
    return -1;
  }
  std::vector<char> buf(static_cast<size_t>(size) + 1);
  if (size > 0 && fread(buf.data(), 1, static_cast<size_t>(size), f) !=
                      static_cast<size_t>(size)) {
    fclose(f);
    return -1;
  }
  fclose(f);
  buf[static_cast<size_t>(size)] = '\0';

  long long n = 0;
  char *p = buf.data();
  char *end = p + size;
  while (p < end) {
    char *eol = static_cast<char *>(memchr(p, '\n', static_cast<size_t>(end - p)));
    if (!eol) eol = end;
    bool header = memchr(p, ':', static_cast<size_t>(eol - p)) != nullptr;
    if (!header) {
      char *q = p;
      auto parse_int = [&](int32_t *out) -> bool {
        while (q < eol && (*q == ' ' || *q == '\t' || *q == '\r')) ++q;
        if (q >= eol) return false;
        bool neg = false;
        if (*q == '-') {
          neg = true;
          ++q;
        }
        if (q >= eol || *q < '0' || *q > '9') return false;
        int64_t v = 0;
        while (q < eol && *q >= '0' && *q <= '9') v = v * 10 + (*q++ - '0');
        *out = static_cast<int32_t>(neg ? -v : v);
        return true;
      };
      int32_t r, c;
      if (parse_int(&r) && parse_int(&c)) {
        if (n >= cap) return -2;
        rows[n] = r;
        cols[n] = c;
        ++n;
      }
    }
    p = eol + 1;
  }
  return n;
}

// Rank over GF(2) of m bit-packed rows of `words` uint64 words each, covering
// n_cols columns (bit j of word w is column 64 w + j).  Gaussian elimination
// with a pivot per column, on a local copy.
int ldpc_gf2_rank(const uint64_t *packed, int m, int words, int n_cols) {
  std::vector<uint64_t> a(packed, packed + static_cast<size_t>(m) * words);
  int rank = 0;
  for (int col = 0; col < n_cols && rank < m; ++col) {
    int w = col >> 6;
    uint64_t mask = 1ULL << (col & 63);
    int pivot = -1;
    for (int r = rank; r < m; ++r) {
      if (a[static_cast<size_t>(r) * words + w] & mask) {
        pivot = r;
        break;
      }
    }
    if (pivot < 0) continue;
    if (pivot != rank) {
      for (int j = 0; j < words; ++j)
        std::swap(a[static_cast<size_t>(pivot) * words + j],
                  a[static_cast<size_t>(rank) * words + j]);
    }
    const uint64_t *prow = &a[static_cast<size_t>(rank) * words];
    for (int r = rank + 1; r < m; ++r) {
      uint64_t *row = &a[static_cast<size_t>(r) * words];
      if (row[w] & mask) {
        for (int j = w; j < words; ++j) row[j] ^= prow[j];
      }
    }
    ++rank;
  }
  return rank;
}

}  // extern "C"
