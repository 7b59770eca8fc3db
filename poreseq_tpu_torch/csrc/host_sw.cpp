// Host Smith-Waterman core of the PyTorch / CUDA port: full-matrix and
// banded Smith-Waterman and the descending argsort of the greedy accept.
//
// A copy of the JAX package's csrc/psq_exact.cpp (its Smith-Waterman
// section and psq_srand / psq_argsort_desc), so the port needs nothing of
// that package.  Built with g++ and the same flags (-O3 -std=c++17 -fPIC
// -shared -ffp-contract=off -fno-fast-math) by
// poreseq_tpu_torch/_build.py:build_host on first use, and loaded with
// ctypes by poreseq_tpu_torch/engine/sw.py.  The greedy accept order depends
// on libstdc++ std::sort's tie permutation, so psq_argsort_desc stays
// native.

#include <cstdint>
#include <cstdlib>
#include <vector>
#include <algorithm>
#include <cmath>

extern "C" {

// --------------------------------------------------------------------------
// Smith-Waterman (spec: cpp/swlib.cpp)
// --------------------------------------------------------------------------

static const int kSwMatch = 5, kSwMismatch = -4, kSwGap = -8;

// Full-matrix SW.  Writes up to cap index pairs; returns count (or -1 if cap
// exceeded).  Pairs are (i,j) 1-based with 0 meaning a gap on that side.
int psq_swfull(const char* s1, int n1, const char* s2, int n2, int32_t* out1,
               int32_t* out2, int cap, double* out_acc, int32_t* out_score) {
  std::vector<int32_t> sc(static_cast<size_t>(n1 + 1) * (n2 + 1), 0);
  std::vector<uint8_t> st(static_cast<size_t>(n1 + 1) * (n2 + 1), 0);
  int maxScore = 0, maxI = 0, maxJ = 0;
  for (int j = 1; j <= n2; j++) {
    int32_t* cur = sc.data() + static_cast<size_t>(j) * (n1 + 1);
    int32_t* prv = sc.data() + static_cast<size_t>(j - 1) * (n1 + 1);
    uint8_t* cst = st.data() + static_cast<size_t>(j) * (n1 + 1);
    for (int i = 1; i <= n1; i++) {
      int score = 0;
      uint8_t step = 0;
      int s = prv[i] + kSwGap;
      if (s > score) { score = s; step = 1; }
      s = cur[i - 1] + kSwGap;
      if (s > score) { score = s; step = 2; }
      s = prv[i - 1] + ((s1[i - 1] == s2[j - 1]) ? kSwMatch : kSwMismatch);
      if (s >= score) { score = s; step = 3; }  // >= : diagonal wins ties
      cur[i] = score;
      cst[i] = step;
      if (score > maxScore) { maxScore = score; maxI = i; maxJ = j; }
    }
  }
  // backtrace
  std::vector<int32_t> i1v, i2v;
  int i = maxI, j = maxJ, nmatch = 0;
  while (i > 0 && j > 0) {
    int32_t cs = sc[static_cast<size_t>(j) * (n1 + 1) + i];
    uint8_t cstp = st[static_cast<size_t>(j) * (n1 + 1) + i];
    if (cs <= 0) break;
    if (cstp == 1) {
      i1v.push_back(0); i2v.push_back(j); j--;
    } else if (cstp == 2) {
      i1v.push_back(i); i2v.push_back(0); i--;
    } else if (cstp == 3) {
      i1v.push_back(i); i2v.push_back(j);
      if (s1[i - 1] == s2[j - 1]) nmatch++;
      i--; j--;
    } else {
      break;
    }
  }
  std::reverse(i1v.begin(), i1v.end());
  std::reverse(i2v.begin(), i2v.end());
  *out_acc = 100.0 * nmatch / static_cast<double>(i1v.size());
  *out_score = maxScore;
  if (static_cast<int>(i1v.size()) > cap) return -1;
  std::copy(i1v.begin(), i1v.end(), out1);
  std::copy(i2v.begin(), i2v.end(), out2);
  return static_cast<int>(i1v.size());
}

// Banded SW along the line i = m*j + b (spec: cpp/swlib.cpp:19-209).
int psq_swfast(const char* s1, int n1, const char* s2, int n2, double al_m,
               double al_b, int width, int32_t* out1, int32_t* out2, int cap,
               double* out_acc, int32_t* out_score) {
  int j0 = static_cast<int>(std::floor((-width / 2 - al_b) / al_m));
  int j1 = static_cast<int>(std::floor((n1 + width / 2 - al_b) / al_m));
  if (j0 < 0) j0 = 0;
  if (j0 >= n2) j0 = n2 - 1;
  if (j1 < 2) j1 = 2;
  if (j1 > n2) j1 = n2;
  size_t ncol = static_cast<size_t>(j1 - j0 + 1);
  std::vector<int32_t> sc(ncol * width, 0);
  std::vector<uint8_t> st(ncol * width, 0);
  std::vector<int32_t> i0s(ncol);
  for (int j = j0; j <= j1; j++)
    i0s[j - j0] = static_cast<int>(std::floor(al_m * j + al_b)) - width / 2;
  int maxScore = 0, maxI = 0, maxJ = 0;
  for (int j = j0 + 1; j <= j1; j++) {
    int i0 = i0s[j - j0];
    int i1 = i0 + width - 1;
    int p0 = i0s[j - j0 - 1];
    int p1 = p0 + width - 1;
    if (i0 < 1) i0 = 1;
    if (i0 > n1) i0 = n1;
    if (i1 < 1) i1 = 1;
    if (i1 > n1) i1 = n1;
    int32_t* cur = sc.data() + static_cast<size_t>(j - j0) * width - i0s[j - j0];
    int32_t* prv = sc.data() + static_cast<size_t>(j - j0 - 1) * width - i0s[j - j0 - 1];
    uint8_t* cst = st.data() + static_cast<size_t>(j - j0) * width - i0s[j - j0];
    for (int i = i0; i <= i1; i++) {
      int score = 0;
      uint8_t step = 0;
      if (i >= p0 && i <= p1) {
        int s = prv[i] + kSwGap;
        if (s > score) { score = s; step = 1; }
      }
      if (i > i0) {
        int s = cur[i - 1] + kSwGap;
        if (s > score) { score = s; step = 2; }
      }
      if (i > p0 && i <= p1) {
        int s = prv[i - 1] + ((s1[i - 1] == s2[j - 1]) ? kSwMatch : kSwMismatch);
        if (s >= score) { score = s; step = 3; }
      } else {
        int s = (s1[i - 1] == s2[j - 1]) ? kSwMatch : kSwMismatch;
        if (s >= score) { score = s; step = 255; }
      }
      cur[i] = score;
      cst[i] = step;
      if (score > maxScore) { maxScore = score; maxI = i; maxJ = j; }
    }
  }
  std::vector<int32_t> i1v, i2v;
  int i = maxI, j = maxJ, nmatch = 0;
  while (i > 0 && j > 0) {
    int32_t cs = sc[static_cast<size_t>(j - j0) * width - i0s[j - j0] + i];
    uint8_t cstp = st[static_cast<size_t>(j - j0) * width - i0s[j - j0] + i];
    if (cs <= 0) break;
    if (cstp == 1) {
      i1v.push_back(0); i2v.push_back(j); j--;
    } else if (cstp == 2) {
      i1v.push_back(i); i2v.push_back(0); i--;
    } else if (cstp == 3) {
      i1v.push_back(i); i2v.push_back(j);
      if (s1[i - 1] == s2[j - 1]) nmatch++;
      i--; j--;
    } else if (cstp == 255) {
      i1v.push_back(i); i2v.push_back(j);
      i = 0; j = 0;
    } else {
      break;
    }
  }
  std::reverse(i1v.begin(), i1v.end());
  std::reverse(i2v.begin(), i2v.end());
  *out_acc = 100.0 * nmatch / static_cast<double>(i1v.size());
  *out_score = maxScore;
  if (static_cast<int>(i1v.size()) > cap) return -1;
  std::copy(i1v.begin(), i1v.end(), out1);
  std::copy(i2v.begin(), i2v.end(), out2);
  return static_cast<int>(i1v.size());
}

void psq_srand(unsigned s) { srand(s); }

// Descending argsort using libstdc++ std::sort with a score-only comparator.
// MakeMutations (cpp/MakeMutations.cpp:83) sorts with an *unstable* sort whose
// tie permutation we must reproduce exactly; sorting (score, index) pairs with
// the same comparator through the same libstdc++ introsort yields the
// identical permutation.
void psq_argsort_desc(const double* scores, int n, int32_t* order) {
  struct P {
    double s;
    int32_t i;
  };
  std::vector<P> v(n);
  for (int i = 0; i < n; i++) v[i] = {scores[i], i};
  std::sort(v.begin(), v.end(), [](const P& a, const P& b) { return a.s > b.s; });
  for (int i = 0; i < n; i++) order[i] = v[i].i;
}

}  // extern "C"
