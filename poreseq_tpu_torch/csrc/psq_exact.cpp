// psq_exact.cpp — the exact (CPU, f64) core of the PyTorch / CUDA port.
//
// A copy of the JAX package's csrc/psq_exact.cpp, so the port needs nothing
// of that package: the banded pair-HMM fill, backtrace and mutation scoring
// behind engine/exact (ExactEngine, the oracle of --backend exact), the
// Smith-Waterman aligners and psq_argsort_desc behind engine/sw.py, and the
// 1024-state Viterbi candidate generator, which draws with libc rand()
// (psq_srand seeds it).  Only this header and the references to PoreSeq's
// sources differ from the original; the code is the same line for line.
// Built with g++ -O3 -std=c++17 -fPIC -shared -ffp-contract=off
// -fno-fast-math (no fused multiply-adds, so its results equal the
// original's and the reference's bit for bit) by
// poreseq_tpu_torch/_build.py:build_host on first use, into
// poreseq_tpu_torch/_build/, and loaded with ctypes by engine/exact/_native.py.
//
// The original's header follows.
//
// psq_exact.cpp — CPU exact engine for poreseq_tpu.
//
// Bit-faithful (f64, identical per-cell operation order) re-implementation of
// the numerical behavior specified by the reference PoreSeq C++ core:
//   * banded event<->sequence pair-HMM forward/backward fill, backtrace and
//     splice-based mutation delta-scoring   (spec: PoreSeq's cpp/Alignment.cpp)
//   * full-matrix and banded Smith-Waterman (spec: PoreSeq's cpp/swlib.cpp)
//   * 1024-state Viterbi candidate generator (spec: PoreSeq's cpp/Viterbi.cpp)
//
// This is a from-scratch implementation with a flat C ABI for ctypes; it is
// the CPU/parity backend of the TPU-native framework, and the oracle that the
// Pallas/JAX kernels are validated against.  All quirks of the reference are
// deliberately preserved (reversed log_stdv index in the forward emission,
// backward-pass prev-column emission asymmetry, strict-> tie-breaking in move
// order, the calloc-zero local-restart floor, in-block out-of-band backtrace
// reads, etc.); see comments at each site.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>
#include <string>
#include <algorithm>
#include <memory>

namespace {

constexpr int kNumStates = 1024;
// The reference uses a *finite* "inf" of 1e300 (AlignUtil.h:20); arithmetic on
// it stays finite, which matters for bit-parity.
constexpr double kInf = 1e300;
static const double kLog2Pi = std::log(2.0 * M_PI);

inline double log_norm_pdf(double x, double mu, double sigma, double log_sigma) {
  // AlignUtil.h:34-38
  double d = (x - mu) / sigma;
  return -0.5 * (d * d + kLog2Pi) - log_sigma;
}

inline double log_ig_pdf(double x, double mu, double lambda, double log_x,
                         double log_lambda) {
  // AlignUtil.h:48-53 (inverse Gaussian; log_x is caller-supplied!)
  double d = (x - mu) / mu;
  return 0.5 * (log_lambda - 3 * log_x - kLog2Pi - d * d * lambda / x);
}

// move codes, shared with the Python layer (Alignment.cpp:19-28 order)
enum Move : uint8_t {
  kSkip = 0,
  kMatch = 1,
  kInsert = 2,
  kIgnore = 3,
  kStay = 4,
  kExtend = 5,
  kImplicit = 255,
};

// One band column.  Memory layout mirrors the reference's single calloc block
// (Alignment.h:70-77) so that the reference's out-of-band backtrace pointer
// arithmetic — which stays inside the block — reads the same values here:
//   [ main_lik(len) | stay_lik(len) | obs(len) | step bytes(2*len ...) ]
struct BandCol {
  int i0 = 0;
  int len = 0;
  int col = 0;
  double best = 0.0;
  int best_i = 0;
  int best_j = 0;
  std::vector<double> block;  // zero-initialized, doubles + trailing step bytes

  BandCol(int length, int ind0, int colind) : i0(ind0), len(length), col(colind) {
    block.assign(static_cast<size_t>(len) * 3 + (static_cast<size_t>(len) * 2) / 8 + 1,
                 0.0);
  }

  double* lik(int arr) { return block.data() + static_cast<size_t>(arr) * len; }
  double* obs() { return block.data() + static_cast<size_t>(2) * len; }
  uint8_t* steps() {
    return reinterpret_cast<uint8_t*>(block.data() + static_cast<size_t>(3) * len);
  }

  // Offset-checked reads used by the backtrace: replicate in-block reads for
  // out-of-band indices; report out-of-block so the caller can bail.
  bool read_cell(int ind, int arr, double* score, uint8_t* step) {
    long off = static_cast<long>(arr) * len + (ind - i0);
    long dbl_cap = static_cast<long>(block.size());
    long lik_off = off;  // doubles from start of block
    long step_off = static_cast<long>(3) * len * 8 + off;  // bytes from start
    long byte_cap = dbl_cap * 8;
    if (lik_off < 0 || lik_off >= dbl_cap || step_off < 0 || step_off >= byte_cap)
      return false;
    *score = block[lik_off];
    *step = reinterpret_cast<uint8_t*>(block.data())[step_off];
    return true;
  }
};

using ColPtr = std::shared_ptr<BandCol>;

struct ExactAligner {
  // ---- event data ----
  int n_levels = 0;
  std::vector<double> mean, stdv, log_stdv;
  // ---- model tables (1024 each) ----
  std::vector<double> lev_mean, lev_stdv, log_lev, sd_mean, sd_lambda, log_lambda;
  double lik_skip = 0, lik_stay = 0, lik_extend = 0, lik_insert = 0;
  // ---- align params ----
  double lik_offset = 4.5;
  int realign_width = 300;
  int scoring_width = 150;
  // ---- mutable alignment state (the "event" side of the reference) ----
  std::vector<double> ref_align, ref_like, ref_index;
  int refstart = -1, refend = -1;
  // ---- current sequence + matrices ----
  std::vector<int32_t> states;
  std::vector<ColPtr> fwd, bwd;
  int stripe = 0;

  void set_sequence(const int32_t* st, int n) { states.assign(st, st + n); }

  void update_refs() {
    // cpp/EventData.h:110-169, including the `lastal > 0` no-interp quirk.
    int n = n_levels;
    int ra0 = 0, ra1 = n - 1;
    refstart = -1;
    refend = -1;
    for (ra0 = 0; ra0 < n; ra0++)
      if (ref_align[ra0] > 0) break;
    for (ra1 = n - 1; ra1 >= 0; ra1--)
      if (ref_align[ra1] > 0) break;
    if (ra0 == n || ra1 < 0) {
      ref_index.clear();
      return;
    }
    refstart = static_cast<int>(ref_align[ra0]);
    refend = static_cast<int>(ref_align[ra1]);
    ref_index = ref_align;
    double al_m = (ref_align[ra1] - ref_align[ra0]) / static_cast<double>(ra1 - ra0);
    double al_b = ref_align[ra0] - al_m * ra0;
    int lastal = -1;
    for (int i = 0; i < n; i++) {
      if (i < ra0 || i > ra1) {
        ref_index[i] = al_m * i + al_b;
      } else if (ref_align[i] > 0) {
        if (lastal > 0) {
          double m = (ref_align[i] - ref_align[lastal]) / (i - lastal);
          for (int j = lastal + 1; j < i; j++)
            ref_index[j] = m * (j - lastal) + ref_align[lastal];
        }
        lastal = i;
      }
    }
  }

  int getrefstate(int refind) const {
    // lower_bound over ref_index (cpp/EventData.h:172-183)
    if (ref_index.empty()) return 0;
    return static_cast<int>(
        std::lower_bound(ref_index.begin(), ref_index.end(),
                         static_cast<double>(refind)) -
        ref_index.begin());
  }

  void reset(const int32_t* st, int n) {
    set_sequence(st, n);
    fwd.clear();
    bwd.clear();
    fwd.push_back(std::make_shared<BandCol>(n_levels + 1, 0, 0));
    bwd.push_back(std::make_shared<BandCol>(n_levels + 1, 0, 0));
    stripe = ref_index.empty() ? 0 : realign_width;
  }

  // Compute the band [i0, i1] for a column (Alignment.cpp:127-148).
  void band_for(int refind, int curwid, bool backward, int* out_i0, int* out_i1,
                bool* skip_state) {
    int n0 = n_levels;
    int imid = 1;
    if (!ref_index.empty()) {
      imid = getrefstate(refind);
      if (backward) imid = n0 - imid + 1;
    }
    if (curwid < n0 && (imid < -10 || imid > n0 + 10)) curwid = 5;
    if (imid < 1) imid = 1;
    if (imid > n0) imid = n0;
    int i0 = imid - curwid;
    int i1 = imid + curwid;
    if (i0 < 1) i0 = 1;
    if (i1 > n0) i1 = n0;
    *out_i0 = i0;
    *out_i1 = i1;
    *skip_state = false;
    (void)skip_state;
  }

  // Fill one forward column after `prev`, for sequence-state index `refind`
  // (1-based), into a fresh column.  Recurrence per Alignment.cpp:111-274.
  ColPtr fill_forward_col(const ColPtr& prev, int refind, int curwid,
                          const int32_t* seq_states) {
    return fill_forward_col_single(prev, refind, curwid, seq_states[refind - 1]);
  }

  // Backward column (Alignment.cpp:280-444): event index flipped, emissions of
  // the *previous* column / previous cell feed the match and stay moves, and
  // the implicit match restarts at 0 instead of lobs.
  ColPtr fill_backward_col(const ColPtr& prev, int colind) {
    int n0 = n_levels;
    int refind = static_cast<int>(states.size()) + colind + 1;
    int refstate = states[refind - 1];
    int i0, i1;
    bool dummy;
    band_for(refind, stripe, /*backward=*/true, &i0, &i1, &dummy);
    ColPtr cur = std::make_shared<BandCol>(i1 - i0 + 1, i0, colind);
    cur->best = prev->best;
    cur->best_i = prev->best_i;
    cur->best_j = prev->best_j;
    if (refstate < 0) return cur;

    double* ob = cur->obs() - i0;
    for (int i = i0; i <= i1; i++) {
      double e = log_norm_pdf(mean[n0 - i], lev_mean[refstate], lev_stdv[refstate],
                              log_lev[refstate]);
      e += log_ig_pdf(stdv[n0 - i], sd_mean[refstate], sd_lambda[refstate],
                      log_stdv[n0 - i], log_lambda[refstate]);
      e += lik_offset;
      ob[i] = e;
    }

    double* cm = cur->lik(0) - i0;
    double* cs = cur->lik(1) - i0;
    uint8_t* cms = cur->steps() - i0;
    uint8_t* css = cur->steps() + cur->len - i0;
    double* pm = prev->lik(0) - prev->i0;
    double* pob = prev->obs() - prev->i0;
    cs[i0] = -kInf;
    int p0 = prev->i0;
    int p1 = prev->i0 + prev->len - 1;

    for (int i = i0; i <= i1; i++) {
      double cand[6] = {0.0, 0.0, 0.0, 0.0, -kInf, -kInf};
      uint8_t bp[6] = {0, 1, 2, 3, 4, 5};

      if (i >= p0 && i <= p1) {
        cand[kSkip] = pm[i] + lik_skip;
      } else {
        cand[kSkip] = lik_skip;
        bp[kSkip] = kImplicit;
      }
      if (i > p0 && i <= p1) {
        cand[kMatch] = pm[i - 1] + pob[i - 1];  // prev-column emission!
        cand[kIgnore] = pm[i - 1] + lik_insert;
      } else {
        cand[kMatch] = 0;  // implicit restart with no emission (quirk)
        bp[kMatch] = kImplicit;
      }
      if (i > i0) {
        cand[kStay] = cm[i - 1] + ob[i - 1] + lik_stay;  // prev-cell emission
        cand[kInsert] = cm[i - 1] + lik_insert;
        cand[kExtend] = cs[i - 1] + ob[i - 1] + lik_extend;
      }
      for (int k = 4; k < 6; k++) {
        if (cand[k] > cs[i]) {
          cs[i] = cand[k];
          css[i] = static_cast<uint8_t>(k);
        }
      }
      for (int k = 0; k < 4; k++) {
        if (cand[k] > cm[i]) {
          cm[i] = cand[k];
          cms[i] = bp[k];
        }
      }
      if (cs[i] > cm[i]) {
        cm[i] = cs[i];
        cms[i] = kStay;
      }
      if (cm[i] > cur->best) {
        cur->best = cm[i];
        cur->best_i = i;
        cur->best_j = refind;
      }
    }
    return cur;
  }

  void fill_forward() {
    if (stripe == 0) return;
    int S = static_cast<int>(states.size());
    while (fwd.back()->col < S)
      fwd.push_back(fill_forward_col(fwd.back(), fwd.back()->col + 1, stripe,
                                     states.data()));
  }

  void fill_backward() {
    if (stripe == 0) return;
    int S = static_cast<int>(states.size());
    while (S + bwd.back()->col > 0)
      bwd.push_back(fill_backward_col(bwd.back(), bwd.back()->col - 1));
  }

  double get_max() const {
    return std::max(fwd.back()->best, bwd.back()->best);
  }

  // Fwd x back column join (Alignment.h:181-214).
  double column_max(int raf, int rab) {
    if (raf >= static_cast<int>(fwd.size())) raf = static_cast<int>(fwd.size()) - 1;
    if (rab >= static_cast<int>(bwd.size())) rab = static_cast<int>(bwd.size()) - 1;
    if (raf < 0) raf = 0;
    if (rab < 0) rab = 0;
    return column_max_cols(*fwd[raf], *bwd[rab]);
  }

  double column_max_cols(BandCol& sf, BandCol& sb) {
    double sm = 0;
    for (int jf = 1; jf <= n_levels; jf++) {
      int jb = n_levels - jf + 1;
      for (int k = 0; k < 2; k++) {
        double s = 0;
        if (jf >= sf.i0 && jf < sf.i0 + sf.len) s += sf.lik(k)[jf - sf.i0];
        if (jb >= sb.i0 && jb < sb.i0 + sb.len) s += sb.lik(k)[jb - sb.i0];
        sm = std::max(s, sm);
      }
      sm = std::max(sm, sf.best);
      sm = std::max(sm, sb.best);
    }
    return sm;
  }

  // Splice-and-refill mutation delta score (Alignment.cpp:447-512).
  // mut_win holds the mutated sequence's states for indices
  // [startind, startind + n_win) with startind = max(mut_start-4, 0);
  // mut_nstates is the mutated sequence's full state count.
  double score_mutation(int mut_start, int mut_len, const int32_t* mut_win,
                        int n_win, int mut_nstates) {
    if (stripe == 0) return 0;
    int origsize = static_cast<int>(fwd.size());
    double oldscore = column_max(std::max(mut_start - 3, 1),
                                 static_cast<int>(states.size()) -
                                     std::max(mut_start - 3, 1) + 1);
    int startind = std::max(mut_start - 4, 0);

    // temp columns appended after a shared copy of column `startind`
    std::vector<ColPtr> tmp;
    tmp.push_back(fwd[startind]);
    for (int t = 0; t < mut_len + 6; t++) {
      int refind = tmp.back()->col + 1;
      if (refind > mut_nstates) break;
      int w = refind - 1 - startind;
      int32_t st = (w >= 0 && w < n_win) ? mut_win[w] : -1;
      tmp.push_back(fill_forward_col_single(tmp.back(), refind, scoring_width, st));
    }

    int refind = mut_start + mut_len + 1;
    // scan the virtual combined vector [fwd..., tmp[0](copy), tmp[1..]]
    long total = static_cast<long>(origsize) + static_cast<long>(tmp.size());
    long fwdind = total - 1;
    auto col_of = [&](long idx) -> ColPtr& {
      return idx < origsize ? fwd[idx] : tmp[idx - origsize];
    };
    while (fwdind >= 0 && col_of(fwdind)->col > refind) fwdind--;
    if (fwdind >= 0 && col_of(fwdind)->col >= fwd[startind]->col)
      refind = col_of(fwdind)->col;

    int backind = mut_nstates - refind + 1;
    double newscore = oldscore - 1;
    if (fwdind >= 0 && col_of(fwdind)->col == refind && fwdind > origsize - 1) {
      int rb = backind;
      if (rb >= static_cast<int>(bwd.size())) rb = static_cast<int>(bwd.size()) - 1;
      if (rb < 0) rb = 0;
      newscore = column_max_cols(*col_of(fwdind), *bwd[rb]);
    }
    return newscore - oldscore;
  }

  // The core forward-column fill, taking the column's 5-mer state directly.
  // Emission quirk preserved: the reference's forward pass feeds the
  // *reversed* log_stdv index (log_stdv[n0-i]) into the inverse-Gaussian pdf
  // while its mean/stdv use [i-1] (Alignment.cpp:167-174).
  ColPtr fill_forward_col_single(const ColPtr& prev, int refind, int curwid,
                                 int32_t refstate) {
    int n0 = n_levels;
    int i0, i1;
    bool dummy;
    band_for(refind, curwid, false, &i0, &i1, &dummy);
    ColPtr cur = std::make_shared<BandCol>(i1 - i0 + 1, i0, refind);
    cur->best = prev->best;
    cur->best_i = prev->best_i;
    cur->best_j = prev->best_j;
    if (refstate < 0) return cur;

    double* ob = cur->obs() - i0;
    for (int i = i0; i <= i1; i++) {
      double e = log_norm_pdf(mean[i - 1], lev_mean[refstate], lev_stdv[refstate],
                              log_lev[refstate]);
      e += log_ig_pdf(stdv[i - 1], sd_mean[refstate], sd_lambda[refstate],
                      log_stdv[n0 - i], log_lambda[refstate]);
      e += lik_offset;
      ob[i] = e;
    }
    double* cm = cur->lik(0) - i0;
    double* cs = cur->lik(1) - i0;
    uint8_t* cms = cur->steps() - i0;
    uint8_t* css = cur->steps() + cur->len - i0;
    double* pm = prev->lik(0) - prev->i0;
    cs[i0] = -kInf;
    int p0 = prev->i0;
    int p1 = prev->i0 + prev->len - 1;
    for (int i = i0; i <= i1; i++) {
      double cand[6] = {0.0, 0.0, 0.0, 0.0, -kInf, -kInf};
      uint8_t bp[6] = {0, 1, 2, 3, 4, 5};
      double lobs = ob[i];
      if (i >= p0 && i <= p1) {
        cand[kSkip] = pm[i] + lik_skip;
      } else {
        cand[kSkip] = lik_skip;
        bp[kSkip] = kImplicit;
      }
      if (i > p0 && i <= p1) {
        cand[kMatch] = pm[i - 1] + lobs;
        cand[kIgnore] = pm[i - 1] + lik_insert;
      } else {
        cand[kMatch] = lobs;
        bp[kMatch] = kImplicit;
      }
      if (i > i0) {
        cand[kStay] = cm[i - 1] + lobs + lik_stay;
        cand[kInsert] = cm[i - 1] + lik_insert;
        cand[kExtend] = cs[i - 1] + lobs + lik_extend;
      }
      for (int k = 4; k < 6; k++)
        if (cand[k] > cs[i]) { cs[i] = cand[k]; css[i] = static_cast<uint8_t>(k); }
      for (int k = 0; k < 4; k++)
        if (cand[k] > cm[i]) { cm[i] = cand[k]; cms[i] = bp[k]; }
      if (cs[i] > cm[i]) { cm[i] = cs[i]; cms[i] = kStay; }
      if (cm[i] > cur->best) {
        cur->best = cm[i];
        cur->best_i = i;
        cur->best_j = refind;
      }
    }
    return cur;
  }

  // Best-path backtrace into ref_align / ref_like (Alignment.cpp:516-624).
  void backtrace() {
    if (stripe == 0) return;
    std::vector<int> inds_i, inds_j;
    std::vector<double> like;
    int i = fwd.back()->best_i;
    int j = fwd.back()->best_j;
    int arr = 0;
    while (i > 0) {
      double score;
      uint8_t st;
      if (j < 0 || j >= static_cast<int>(fwd.size())) break;
      if (!fwd[j]->read_cell(i, arr, &score, &st)) break;
      if (score <= 0.0) break;
      switch (st) {
        case kSkip:
          j--;
          break;
        case kMatch:
          inds_i.push_back(i);
          inds_j.push_back(j);
          like.push_back(score);
          i--;
          j--;
          break;
        case kIgnore:
          inds_i.push_back(i);
          inds_j.push_back(-1);
          like.push_back(score);
          i--;
          j--;
          break;
        case kInsert:
          inds_i.push_back(i);
          inds_j.push_back(-1);
          like.push_back(score);
          i--;
          break;
        case kStay:
          if (arr == 1) {
            inds_i.push_back(i);
            inds_j.push_back(j);
            like.push_back(score);
            i--;
          }
          arr = 1 - arr;
          break;
        case kExtend:
          inds_i.push_back(i);
          inds_j.push_back(j);
          like.push_back(score);
          i--;
          break;
        default:  // kImplicit or garbage
          i = 0;
          break;
      }
    }
    std::fill(ref_align.begin(), ref_align.end(), 0.0);
    ref_like = ref_align;
    for (size_t k = 0; k < inds_i.size(); k++) {
      ref_align[inds_i[k] - 1] = inds_j[k];
      ref_like[inds_i[k] - 1] = like[k];
    }
    update_refs();
  }
};

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

void* psq_new(int n_levels, const double* mean, const double* stdv,
              const double* lev_mean, const double* lev_stdv,
              const double* sd_mean, const double* sd_stdv,
              double prob_skip, double prob_stay, double prob_extend,
              double prob_insert, double lik_offset, int realign_width,
              int scoring_width, const double* ref_align_init) {
  ExactAligner* a = new ExactAligner();
  a->n_levels = n_levels;
  a->mean.assign(mean, mean + n_levels);
  a->stdv.assign(stdv, stdv + n_levels);
  a->log_stdv.resize(n_levels);
  for (int i = 0; i < n_levels; i++) a->log_stdv[i] = std::log(a->stdv[i]);
  a->lev_mean.assign(lev_mean, lev_mean + kNumStates);
  a->lev_stdv.assign(lev_stdv, lev_stdv + kNumStates);
  a->sd_mean.assign(sd_mean, sd_mean + kNumStates);
  a->log_lev.resize(kNumStates);
  a->sd_lambda.resize(kNumStates);
  a->log_lambda.resize(kNumStates);
  for (int i = 0; i < kNumStates; i++) {
    a->log_lev[i] = std::log(lev_stdv[i]);
    // ModelData::setData (EventData.h:61-62)
    a->sd_lambda[i] = std::pow(sd_mean[i], 3) / std::pow(sd_stdv[i], 2);
    a->log_lambda[i] = std::log(a->sd_lambda[i]);
  }
  a->lik_skip = std::log(prob_skip);
  a->lik_stay = std::log(prob_stay);
  a->lik_extend = std::log(prob_extend);
  a->lik_insert = std::log(prob_insert);
  a->lik_offset = lik_offset;
  a->realign_width = realign_width;
  a->scoring_width = scoring_width;
  a->ref_align.assign(ref_align_init, ref_align_init + n_levels);
  a->ref_like.assign(n_levels, 0.0);
  a->update_refs();
  return a;
}

void psq_free(void* h) { delete static_cast<ExactAligner*>(h); }

// Reset matrices for a (possibly new) sequence; returns the stripe width in
// effect (0 means the event has no seed alignment and will be skipped).
int psq_reset(void* h, const int32_t* states, int n_states) {
  ExactAligner* a = static_cast<ExactAligner*>(h);
  a->reset(states, n_states);
  return a->stripe;
}

void psq_fill_forward(void* h) { static_cast<ExactAligner*>(h)->fill_forward(); }
void psq_fill_backward(void* h) { static_cast<ExactAligner*>(h)->fill_backward(); }
void psq_backtrace(void* h) { static_cast<ExactAligner*>(h)->backtrace(); }
double psq_get_max(void* h) { return static_cast<ExactAligner*>(h)->get_max(); }

void psq_get_refdata(void* h, double* ref_align, double* ref_like) {
  ExactAligner* a = static_cast<ExactAligner*>(h);
  std::memcpy(ref_align, a->ref_align.data(), a->n_levels * sizeof(double));
  std::memcpy(ref_like, a->ref_like.data(), a->n_levels * sizeof(double));
}

void psq_set_refalign(void* h, const double* ref_align) {
  ExactAligner* a = static_cast<ExactAligner*>(h);
  a->ref_align.assign(ref_align, ref_align + a->n_levels);
  a->update_refs();
}

int psq_get_refstart(void* h) { return static_cast<ExactAligner*>(h)->refstart; }
int psq_get_refend(void* h) { return static_cast<ExactAligner*>(h)->refend; }

// Score a batch of mutations against this (already update()d) aligner.
// For mutation m: starts[m], mutlens[m] (length of replacement string),
// winlens[m] states packed consecutively in `win` (offsets wino[m]),
// mut_nstates[m] the mutated sequence's total state count.
// Scores are *added* into out[m] (caller accumulates across events).
void psq_score_mutations(void* h, int n_muts, const int32_t* starts,
                         const int32_t* mutlens, const int64_t* wino,
                         const int32_t* winlens, const int32_t* win,
                         const int32_t* mut_nstates, int seq_len,
                         double* out) {
  ExactAligner* a = static_cast<ExactAligner*>(h);
  for (int m = 0; m < n_muts; m++) {
    // sanity check, ScoreMutations (MakeMutations.cpp:45-47)
    if (starts[m] > seq_len) continue;
    out[m] += a->score_mutation(starts[m], mutlens[m], win + wino[m], winlens[m],
                                mut_nstates[m]);
  }
}

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

// ---------------------------------------------------------------------------
// 1024-state Viterbi candidate generator (spec: cpp/Viterbi.cpp)
// ---------------------------------------------------------------------------

namespace {

inline int v_prev_state(int state, int ind, int nsteps) {
  return (state >> (2 * nsteps)) + (ind << (10 - 2 * nsteps));
}
inline int v_next_state(int state, int ind, int nsteps) {
  return ((state << (2 * nsteps)) & (kNumStates - 1)) + ind;
}
inline char v_get_base(int state, int ind) {
  static const char* bases = "ACGT";
  return bases[3 & (state >> (2 * (4 - ind)))];
}

inline void v_normvec(double* vec) {
  // Viterbi.h:56-64: multiply by reciprocal, summed in index order.
  double tot = 0;
  for (int i = 0; i < kNumStates; i++) tot += vec[i];
  tot = 1.0 / tot;
  for (int i = 0; i < kNumStates; i++) vec[i] *= tot;
}

struct VitCol {
  std::vector<double> liks;
  std::vector<int> backptrs;
  std::vector<double> fwdprobs;
  VitCol() : liks(kNumStates), backptrs(kNumStates), fwdprobs(kNumStates) {}
};

// One event's view for the Viterbi sweep.
struct VitEvent {
  const double* mean;
  const double* stdv;
  const double* ref_align;
  const double* ref_index;  // may be null (empty)
  int n_levels;
  int n_refindex;
  int refstart;
  int refend;
  // model (1024 each) + precomputed logs
  const double* lev_mean;
  const double* lev_stdv;
  std::vector<double> log_lev;
  const double* sd_mean;
  std::vector<double> sd_lambda, log_lambda;

  // cpp/EventData.h:187-204: exact double == match on ref_index, then walk
  // forward while ref_align <= refind collecting aligned levels.
  std::vector<int> getrefstates(int refind) const {
    std::vector<int> inds;
    if (n_refindex == 0) return inds;
    const double* it = std::find(ref_index, ref_index + n_refindex,
                                 static_cast<double>(refind));
    if (it == ref_index + n_refindex) return inds;
    int i = static_cast<int>(it - ref_index);
    inds.push_back(i);
    for (i++; i < n_levels && ref_align[i] <= refind; i++)
      if (ref_align[i] > 0) inds.push_back(i);
    return inds;
  }
};

// Transition update + forward probs (spec: Viterbi.cpp:39-102).
void vit_advance(const VitCol& prev, const std::vector<double>& obs,
                 double skip_prob, double stay_prob, VitCol* out) {
  const int nskip = 3;
  const double skip_lik = std::log(skip_prob);
  const double stay_lik = std::log(stay_prob);
  for (int curst = 0; curst < kNumStates; curst++) {
    double maxlik = -kInf;
    int maxptr = -1;
    double fwdprob = 0.0;
    double sp = 0.25;
    double lsp = std::log(0.25);
    for (int j = 1; j <= nskip; j++) {
      for (int k = 0; k < (1 << (2 * j)); k++) {
        int prevst = v_prev_state(curst, k, j);
        double l = obs[curst] + lsp;
        l += prev.liks[prevst];
        fwdprob += sp * prev.fwdprobs[prevst];
        if (l > maxlik) {
          maxlik = l;
          maxptr = prevst;
        }
      }
      sp = sp * 0.25 * skip_prob;
      lsp = lsp + std::log(0.25) + skip_lik;
    }
    double l = obs[curst] + stay_lik + prev.liks[curst];
    if (l > maxlik) {
      maxlik = l;
      maxptr = curst;
    }
    fwdprob += stay_prob * prev.fwdprobs[curst];
    fwdprob *= std::exp(obs[curst]);
    out->liks[curst] = maxlik;
    out->backptrs[curst] = maxptr;
    out->fwdprobs[curst] = fwdprob;
  }
  v_normvec(out->fwdprobs.data());
}

// Stochastic backpointer sample (spec: Viterbi.cpp:105-131); uses libc rand()
// exactly like the reference (unseeded -> glibc default seed 1).
int vit_randbp(const VitCol& col, int curstate, double atten,
               const std::vector<double>& T) {
  double r = rand() / (static_cast<double>(RAND_MAX) + 1);
  double cumsum = 0;
  static thread_local std::vector<double> probs(kNumStates);
  for (int i = 0; i < kNumStates; i++)
    probs[i] = T[i + curstate * kNumStates] * std::pow(col.fwdprobs[i], atten);
  v_normvec(probs.data());
  for (int i = 0; i < kNumStates; i++) {
    cumsum += probs[i];
    if (r < cumsum) return i;
  }
  return kNumStates - 1;
}

// Dense transition matrix (spec: Viterbi.cpp:134-169; note nskip=4 here).
std::vector<double> vit_buildT(double skip_prob, double stay_prob) {
  std::vector<double> T(static_cast<size_t>(kNumStates) * kNumStates, 0.0);
  const int nskip = 4;
  for (int curst = 0; curst < kNumStates; curst++) {
    double* Tcol = T.data() + static_cast<size_t>(kNumStates) * curst;
    double sp = 0.25;
    for (int j = 1; j <= nskip; j++) {
      for (int k = 0; k < (1 << (2 * j)); k++) Tcol[v_prev_state(curst, k, j)] += sp;
      sp = sp * 0.25 * skip_prob;
    }
  }
  for (int i = 0; i < kNumStates; i++)
    T[static_cast<size_t>(i) * (1 + kNumStates)] = stay_prob;
  return T;
}

// State path -> bases (spec: Viterbi.cpp:171-237).
std::string vit_states_to_seq(const std::vector<int>& states) {
  std::string seq;
  int curstate = states[0];
  seq.push_back(v_get_base(curstate, 0));
  for (size_t i = 1; i < states.size(); i++) {
    if (curstate == states[i]) continue;  // stay
    for (int nskips = 1; nskips <= 4; nskips++) {
      bool found = false;
      for (int ind = 0; ind < (1 << (2 * nskips)); ind++) {
        if (v_next_state(curstate, ind, nskips) == states[i]) {
          for (int j = 1; j <= nskips; j++) seq.push_back(v_get_base(curstate, j));
          curstate = states[i];
          found = true;
          break;
        }
      }
      if (found) break;
    }
    if (curstate != states[i]) {
      // unreachable transition: treat as mismatch jump
      curstate = states[i];
      seq.push_back(v_get_base(curstate, 0));
    }
  }
  for (int i = 1; i <= 4; i++) seq.push_back(v_get_base(curstate, i));
  return seq;
}

}  // namespace

extern "C" {

// Run ViterbiMutate over a set of events (spec: Viterbi.cpp:239-426).
// Flattened inputs: per-event level arrays at lev_off[e] (length n_levels[e]);
// per-event ref_index lengths ri_len[e] (0 if empty); models are n_ev x 1024
// rows.  Output sequences are written back-to-back into seq_buf (capacity
// seq_cap) with lengths in seq_lens (capacity max(nkeep,1)).
// Returns the number of sequences, or -1 on buffer overflow.
int psq_viterbi_mutate(int n_ev, const int32_t* n_levels, const int64_t* lev_off,
                       const double* mean_flat, const double* stdv_flat,
                       const double* ref_align_flat, const double* ref_index_flat,
                       const int32_t* ri_len, const int32_t* refstart,
                       const int32_t* refend, const double* lev_mean_rows,
                       const double* lev_stdv_rows, const double* sd_mean_rows,
                       const double* sd_stdv_rows, int nkeep, double skip_prob,
                       double stay_prob, double mut_min, double mut_max,
                       char* seq_buf, int64_t seq_cap, int32_t* seq_lens) {
  std::vector<VitEvent> evs(n_ev);
  for (int e = 0; e < n_ev; e++) {
    VitEvent& v = evs[e];
    v.mean = mean_flat + lev_off[e];
    v.stdv = stdv_flat + lev_off[e];
    v.ref_align = ref_align_flat + lev_off[e];
    v.ref_index = ref_index_flat + lev_off[e];
    v.n_levels = n_levels[e];
    v.n_refindex = ri_len[e];
    v.refstart = refstart[e];
    v.refend = refend[e];
    v.lev_mean = lev_mean_rows + static_cast<size_t>(e) * kNumStates;
    v.lev_stdv = lev_stdv_rows + static_cast<size_t>(e) * kNumStates;
    v.sd_mean = sd_mean_rows + static_cast<size_t>(e) * kNumStates;
    const double* sdsd = sd_stdv_rows + static_cast<size_t>(e) * kNumStates;
    v.log_lev.resize(kNumStates);
    v.sd_lambda.resize(kNumStates);
    v.log_lambda.resize(kNumStates);
    for (int i = 0; i < kNumStates; i++) {
      v.log_lev[i] = std::log(v.lev_stdv[i]);
      v.sd_lambda[i] = std::pow(v.sd_mean[i], 3) / std::pow(sdsd[i], 2);
      v.log_lambda[i] = std::log(v.sd_lambda[i]);
    }
  }

  std::vector<std::unique_ptr<VitCol>> cols;
  cols.emplace_back(new VitCol());
  for (int i = 0; i < kNumStates; i++) {
    cols[0]->liks[i] = 0;
    cols[0]->backptrs[i] = -1;
    cols[0]->fwdprobs[i] = 1.0 / kNumStates;
  }

  int refind = evs.empty() ? 0 : evs[0].refstart;
  for (int e = 0; e < n_ev; e++) refind = std::min(refind, evs[e].refstart);

  std::vector<double> obs(static_cast<size_t>(kNumStates) * n_ev);

  while (true) {
    std::fill(obs.begin(), obs.end(), 0.0);
    int nlik = 0;
    for (int k = 0; k < n_ev; k++) {
      std::vector<int> inds = evs[k].getrefstates(refind);
      if (inds.empty()) continue;
      nlik++;
      double lvl = 0, sd = 0;
      for (size_t j = 0; j < inds.size(); j++) {
        lvl += evs[k].mean[inds[j]];
        sd += evs[k].stdv[inds[j]];
      }
      lvl = lvl / inds.size();
      sd = sd / inds.size();
      const VitEvent& v = evs[k];
      for (int j = 0; j < kNumStates; j++) {
        double l = log_norm_pdf(lvl, v.lev_mean[j], v.lev_stdv[j], v.log_lev[j]);
        l += log_ig_pdf(sd, v.sd_mean[j], v.sd_lambda[j], std::log(sd),
                        v.log_lambda[j]);
        obs[static_cast<size_t>(j) * n_ev + nlik - 1] = l;
      }
    }
    int nalhere = 0;
    for (int k = 0; k < n_ev; k++)
      if (refind >= evs[k].refstart && refind <= evs[k].refend) nalhere++;
    if (nlik <= nalhere * 0.2) {
      if (nalhere == 0) break;
      refind++;
      continue;
    }
    if (nlik > 1) {
      // trimmed mean: drop the worst quartile of strand likelihoods
      for (int j = 0; j < kNumStates; j++)
        std::sort(obs.begin() + static_cast<size_t>(j) * n_ev,
                  obs.begin() + static_cast<size_t>(j) * n_ev + nlik);
      int nskip = static_cast<int>(std::floor(nlik * 0.25));
      if (nskip > nlik - 2) nskip = 0;
      for (int j = 0; j < kNumStates; j++) {
        double lik = 0.0;
        for (int k = nskip; k < nlik; k++) lik += obs[static_cast<size_t>(j) * n_ev + k];
        obs[j] = lik / (nlik - nskip);
      }
    } else {
      for (int j = 0; j < kNumStates; j++) obs[j] = obs[static_cast<size_t>(j) * n_ev];
    }
    std::vector<double> obs1(obs.begin(), obs.begin() + kNumStates);
    cols.emplace_back(new VitCol());
    vit_advance(*cols[cols.size() - 2], obs1, skip_prob, stay_prob,
                cols.back().get());
    refind++;
  }

  // backtraces
  const double* mlik =
      std::max_element(cols.back()->liks.data(), cols.back()->liks.data() + kNumStates);
  int startst = static_cast<int>(mlik - cols.back()->liks.data());
  int n = static_cast<int>(cols.size()) - 1;

  auto emit = [&](const std::string& s, int idx, int64_t* used) -> bool {
    if (*used + static_cast<int64_t>(s.size()) > seq_cap) return false;
    std::memcpy(seq_buf + *used, s.data(), s.size());
    *used += s.size();
    seq_lens[idx] = static_cast<int32_t>(s.size());
    return true;
  };

  int64_t used = 0;
  std::vector<int> states;
  if (nkeep == 0) {
    int curst = startst;
    for (int i = n - 1; i >= 0; i--) {
      states.push_back(curst);
      curst = cols[i + 1]->backptrs[curst];
    }
    std::reverse(states.begin(), states.end());
    if (!emit(vit_states_to_seq(states), 0, &used)) return -1;
    return 1;
  }

  std::vector<double> T = vit_buildT(skip_prob, stay_prob);
  for (int k = 0; k < nkeep; k++) {
    states.clear();
    int curst = startst;
    for (int i = n - 1; i >= 0; i--) {
      states.push_back(curst);
      curst = vit_randbp(*cols[i + 1], curst,
                         mut_min + (mut_max - mut_min) * k / static_cast<double>(nkeep),
                         T);
    }
    std::reverse(states.begin(), states.end());
    if (!emit(vit_states_to_seq(states), k, &used)) return -1;
  }
  return nkeep;
}

}  // extern "C"
