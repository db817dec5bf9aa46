// Native float64 golden model — see golden.h.
//
// Design notes (vs the reference it verifies against):
// * One decode pass straight into the RX-major cube (the reference decodes
//   into an intermediate chirp-major buffer and re-permutes with a second
//   pass + malloc per frame, cudaBenchMarking.cpp:152-186).
// * FFT uses a precomputed per-stage twiddle table with per-index angles
//   (no accumulating recurrence), which is the numerically cleaner
//   formulation; agreement with numpy.fft is ~1e-12 relative.
// * Errors fail fast; the streaming loop rejects malformed file sizes that
//   the reference silently truncates.

#include "golden.h"

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <vector>

namespace {

double now_sec() {
  using clock = std::chrono::steady_clock;
  return std::chrono::duration<double>(clock::now().time_since_epoch()).count();
}

// numpy mode='reflect' index (edge sample not repeated), valid for ANY
// offset via the 2*(n-1) period — a single-reflection formula reads out of
// bounds once the window half-width reaches n.
int reflect_index(int j, int n) {
  if (n <= 1) return 0;
  const int period = 2 * (n - 1);
  int m = ((j % period) + period) % period;
  return m < n ? m : period - m;
}

int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

void radar_default_params(RadarParams* p) {
  p->num_samples = 100;
  p->num_chirps = 128;
  p->num_rx = 4;
  p->sample_rate_hz = 2.0e6;
  p->slope_hz_per_s = 5.987e12;
  p->scan_fraction = 0.4;
}

int radar_rx_samples(const RadarParams* p) {
  return p->num_chirps * p->num_samples;
}

int radar_fft_size(const RadarParams* p) {
  return next_pow2(radar_rx_samples(p));
}

int radar_scan_bins(const RadarParams* p) {
  return (int)std::floor(p->scan_fraction * radar_fft_size(p));
}

int radar_shorts_per_frame(const RadarParams* p) {
  return p->num_chirps * p->num_rx * p->num_samples * 2;
}

void radar_decode_frame(const RadarParams* p, const int16_t* shorts,
                        double* out_re, double* out_im) {
  const int ns = p->num_samples, nc = p->num_chirps, nr = p->num_rx;
  // On-disk: chirp-major complex stream c[chirp][rx][sample], with the
  // int16 4-lane interleave (I0,I1,Q0,Q1) -> (I0,Q0),(I1,Q1).
  // Complex index k maps to shorts: re = base + (k&1), im = base + 2 + (k&1)
  // where base = (k/2)*4.  Write directly to the RX-major slot.
  for (int c = 0; c < nc; ++c) {
    for (int r = 0; r < nr; ++r) {
      const int src_row = (c * nr + r) * ns;  // complex index of sample 0
      const int dst_row = (r * nc + c) * ns;
      for (int s = 0; s < ns; ++s) {
        const int k = src_row + s;
        const int base = (k >> 1) * 4 + (k & 1);
        out_re[dst_row + s] = (double)shorts[base];
        out_im[dst_row + s] = (double)shorts[base + 2];
      }
    }
  }
}

void radar_fft(double* re, double* im, int n) {
  if (n <= 0 || (n & (n - 1))) return;  // radix-2 only; refuse non-pow2
  // bit-reversal permutation
  for (int i = 1, j = 0; i < n; ++i) {
    int bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) {
      std::swap(re[i], re[j]);
      std::swap(im[i], im[j]);
    }
  }
  // radix-2 DIT stages with per-index twiddles
  for (int len = 2; len <= n; len <<= 1) {
    const int half = len >> 1;
    std::vector<double> wr(half), wi(half);
    for (int k = 0; k < half; ++k) {
      const double theta = -2.0 * M_PI * k / len;
      wr[k] = std::cos(theta);
      wi[k] = std::sin(theta);
    }
    for (int start = 0; start < n; start += len) {
      for (int k = 0; k < half; ++k) {
        const int lo = start + k, hi = lo + half;
        const double tr = wr[k] * re[hi] - wi[k] * im[hi];
        const double ti = wr[k] * im[hi] + wi[k] * re[hi];
        re[hi] = re[lo] - tr;
        im[hi] = im[lo] - ti;
        re[lo] += tr;
        im[lo] += ti;
      }
    }
  }
}

int radar_find_abs_max(const double* re, const double* im, int size) {
  int max_idx = 0;
  double max_val = -1.0;
  for (int i = 0; i < size; ++i) {
    const double v = re[i] * re[i] + im[i] * im[i];
    if (v > max_val) {
      max_val = v;
      max_idx = i;
    }
  }
  return max_idx;
}

void radar_base_frame(const RadarParams* p, const int16_t* frame0,
                      double* base_re, double* base_im) {
  const int total = radar_rx_samples(p) * p->num_rx;
  std::vector<double> re(total), im(total);
  radar_decode_frame(p, frame0, re.data(), im.data());
  std::memcpy(base_re, re.data(), radar_rx_samples(p) * sizeof(double));
  std::memcpy(base_im, im.data(), radar_rx_samples(p) * sizeof(double));
}

void radar_detect_frame(const RadarParams* p, const int16_t* frame,
                        const double* base_re, const double* base_im,
                        RangeDetection* out) {
  const int rxn = radar_rx_samples(p);
  const int nfft = radar_fft_size(p);
  const int total = rxn * p->num_rx;
  std::vector<double> cre(total), cim(total);
  radar_decode_frame(p, frame, cre.data(), cim.data());

  std::vector<double> re(nfft, 0.0), im(nfft, 0.0);
  for (int i = 0; i < rxn; ++i) {
    re[i] = cre[i] - base_re[i];  // RX0 slice is the cube's first rxn elems
    im[i] = cim[i] - base_im[i];
  }
  radar_fft(re.data(), im.data(), nfft);

  const int peak = radar_find_abs_max(re.data(), im.data(), radar_scan_bins(p));
  const int rescaled = peak * rxn / nfft;  // integer division (parity)
  const double fs_ext = p->sample_rate_hz * nfft / rxn;
  const double kLightSpeed = 3.0e8;
  out->peak_bin = peak;
  out->rescaled_bin = rescaled;
  out->distance_m =
      kLightSpeed * (((double)rescaled / nfft) * fs_ext) /
      (2.0 * p->slope_hz_per_s);
  out->magnitude = std::sqrt(re[peak] * re[peak] + im[peak] * im[peak]);
}

int radar_process_capture(const RadarParams* p, const char* path,
                          double* timings, double* distances,
                          int max_frames) {
  const int shorts_per_frame = radar_shorts_per_frame(p);
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;

  double t_total = 0, t_fft = 0, t_pre = 0, t_max = 0;
  const double t0 = now_sec();

  std::vector<int16_t> buf(shorts_per_frame);
  if (std::fread(buf.data(), sizeof(int16_t), shorts_per_frame, f) !=
      (size_t)shorts_per_frame) {
    std::fclose(f);
    return -1;
  }
  const int rxn = radar_rx_samples(p);
  const int nfft = radar_fft_size(p);
  std::vector<double> base_re(rxn), base_im(rxn);
  radar_base_frame(p, buf.data(), base_re.data(), base_im.data());

  const int total = rxn * p->num_rx;
  std::vector<double> cre(total), cim(total);
  std::vector<double> re(nfft), im(nfft);

  int n = 0;
  while ((max_frames < 0 || n < max_frames) &&
         std::fread(buf.data(), sizeof(int16_t), shorts_per_frame, f) ==
             (size_t)shorts_per_frame) {
    double t = now_sec();
    radar_decode_frame(p, buf.data(), cre.data(), cim.data());
    std::fill(re.begin(), re.end(), 0.0);
    std::fill(im.begin(), im.end(), 0.0);
    for (int i = 0; i < rxn; ++i) {
      re[i] = cre[i] - base_re[i];
      im[i] = cim[i] - base_im[i];
    }
    t_pre += now_sec() - t;

    t = now_sec();
    radar_fft(re.data(), im.data(), nfft);
    t_fft += now_sec() - t;

    t = now_sec();
    const int peak =
        radar_find_abs_max(re.data(), im.data(), radar_scan_bins(p));
    const int rescaled = peak * rxn / nfft;
    const double fs_ext = p->sample_rate_hz * nfft / rxn;
    const double dis = 3.0e8 * (((double)rescaled / nfft) * fs_ext) /
                       (2.0 * p->slope_hz_per_s);
    t_max += now_sec() - t;
    if (distances) distances[n] = dis;
    ++n;
  }
  std::fclose(f);
  t_total = now_sec() - t0;
  if (timings) {
    timings[0] = t_total;
    timings[1] = t_fft;
    timings[2] = t_pre;
    timings[3] = t_max;
  }
  return n;
}

// Periodic cosine-sum window value at index i of n.  Kinds (the int is
// the ABI: 0/1 keep their historical rect/hann meaning):
//   0 rect, 1 hann, 2 hamming, 3 blackman, 4 blackman-harris.
// Independent twin of the Python golden's window_fn coefficients
// (mmradar/golden.py): w = a0 - a1 cos t + a2 cos 2t - a3 cos 3t,
// t = 2*pi*i/n.
static double win_coef(int kind, int i, int n) {
  static const double k[5][4] = {
      {1.0, 0.0, 0.0, 0.0},
      {0.5, 0.5, 0.0, 0.0},
      {0.54, 0.46, 0.0, 0.0},
      {0.42, 0.5, 0.08, 0.0},
      {0.35875, 0.48829, 0.14128, 0.01168},
  };
  if (kind < 0 || kind > 4) kind = 1;
  const double t = 2.0 * M_PI * i / n;
  return k[kind][0] - k[kind][1] * std::cos(t) + k[kind][2] * std::cos(2 * t) -
         k[kind][3] * std::cos(3 * t);
}

void radar_range_doppler(const double* in_re, const double* in_im,
                         int chirps_in, int samples_in, int doppler_fft,
                         int range_fft, int window, double* out_re,
                         double* out_im) {
  // windowed copy into the zero-padded (doppler_fft, range_fft) plane
  std::vector<double> re((size_t)doppler_fft * range_fft, 0.0);
  std::vector<double> im((size_t)doppler_fft * range_fft, 0.0);
  for (int c = 0; c < chirps_in; ++c) {
    const double wc = win_coef(window, c, chirps_in);
    for (int s = 0; s < samples_in; ++s) {
      const double ws = win_coef(window, s, samples_in);
      re[(size_t)c * range_fft + s] = wc * ws * in_re[c * samples_in + s];
      im[(size_t)c * range_fft + s] = wc * ws * in_im[c * samples_in + s];
    }
  }
  // range FFT along rows
  for (int c = 0; c < doppler_fft; ++c) {
    radar_fft(re.data() + (size_t)c * range_fft,
              im.data() + (size_t)c * range_fft, range_fft);
  }
  // Doppler FFT along columns (gather/scatter through a scratch line)
  std::vector<double> col_re(doppler_fft), col_im(doppler_fft);
  for (int s = 0; s < range_fft; ++s) {
    for (int c = 0; c < doppler_fft; ++c) {
      col_re[c] = re[(size_t)c * range_fft + s];
      col_im[c] = im[(size_t)c * range_fft + s];
    }
    radar_fft(col_re.data(), col_im.data(), doppler_fft);
    // fftshift the Doppler axis on write-back
    const int half = doppler_fft / 2;
    for (int c = 0; c < doppler_fft; ++c) {
      const int shifted = (c + half) % doppler_fft;
      out_re[(size_t)shifted * range_fft + s] = col_re[c];
      out_im[(size_t)shifted * range_fft + s] = col_im[c];
    }
  }
}

double radar_ca_cfar_alpha_integrated(int n_train, double pfa,
                                      int n_pulses) {
  // Erlang-N cell / Gamma(n*N) training-sum CA-CFAR Pfa; bisection in
  // [1e-9, 10] (200 iterations) exactly as the Python golden twin.
  if (n_pulses <= 1) return std::pow(pfa, -1.0 / n_train) - 1.0;
  const double nn = (double)n_train * n_pulses;
  auto pfa_of = [&](double t) {
    const double lt = std::log(t), l1t = std::log1p(t);
    double s = 0.0;
    for (int k = 0; k < n_pulses; ++k) {
      s += std::exp(std::lgamma(nn + k) - std::lgamma(k + 1.0) -
                    std::lgamma(nn) + k * lt - (nn + k) * l1t);
    }
    return s;
  };
  double lo = 1e-9, hi = 10.0;
  for (int it = 0; it < 200; ++it) {
    const double mid = 0.5 * (lo + hi);
    if (pfa_of(mid) > pfa) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return 0.5 * (lo + hi);
}

void radar_ca_cfar(const double* power, int d, int r, int guard_d,
                   int guard_r, int train_d, int train_r, double pfa,
                   int n_pulses, int range_mode, double* threshold,
                   uint8_t* hits) {
  const int wd = guard_d + train_d, wr = guard_r + train_r;
  const int n_train =
      (2 * wd + 1) * (2 * wr + 1) - (2 * guard_d + 1) * (2 * guard_r + 1);
  const double alpha =
      n_train * radar_ca_cfar_alpha_integrated(n_train, pfa, n_pulses);

  // separable box sums: Doppler circular, range wrap or reflect (numpy
  // 'reflect': edge sample not repeated) — same convention as the XLA
  // twin
  auto box = [&](const std::vector<double>& src, int half_d, int half_r,
                 std::vector<double>& dst) {
    std::vector<double> rows((size_t)d * r);
    for (int i = 0; i < d; ++i) {
      for (int j = 0; j < r; ++j) {
        double acc = 0.0;
        for (int k = -half_r; k <= half_r; ++k) {
          int jr = j + k;
          if (range_mode == 1) {
            jr = reflect_index(jr, r);
          } else {
            jr = (jr % r + r) % r;
          }
          acc += src[(size_t)i * r + jr];
        }
        rows[(size_t)i * r + j] = acc;
      }
    }
    for (int i = 0; i < d; ++i) {
      for (int j = 0; j < r; ++j) {
        double acc = 0.0;
        for (int k = -half_d; k <= half_d; ++k) {
          acc += rows[(size_t)(((i + k) % d + d) % d) * r + j];
        }
        dst[(size_t)i * r + j] = acc;
      }
    }
  };
  std::vector<double> p(power, power + (size_t)d * r);
  std::vector<double> total((size_t)d * r), inner((size_t)d * r);
  box(p, wd, wr, total);
  box(p, guard_d, guard_r, inner);
  for (size_t i = 0; i < (size_t)d * r; ++i) {
    const double noise = (total[i] - inner[i]) / n_train;
    threshold[i] = alpha * noise;
    hits[i] = power[i] > threshold[i] ? 1 : 0;
  }
}

double radar_go_so_cfar_alpha(int n_half, double pfa, int kind,
                              int n_pulses) {
  if (n_pulses > 1) {
    // Erlang-matched double sum (mmradar.golden._go_so_alpha_integrated):
    // cell Gamma(N), half sums Gamma(M = n_half*N);
    //   Pfa_SO = 2 sum_{k<N} sum_{j<M} G(M+k+j)/(G(M) k! j!)
    //                                  t^k (2+t)^-(M+k+j)
    //   Pfa_GO = 2 sum_{k<N} C(M+k-1,k) t^k (1+t)^-(M+k) - Pfa_SO
    const int np = n_pulses, m = n_half * n_pulses;
    const double lg_m = std::lgamma((double)m);
    std::vector<double> lco((size_t)np * m), lbin(np);
    for (int k = 0; k < np; ++k) {
      lbin[k] = std::lgamma((double)m + k) - std::lgamma(k + 1.0) - lg_m;
      for (int j = 0; j < m; ++j) {
        lco[(size_t)k * m + j] = std::lgamma((double)m + k + j) - lg_m -
                                 std::lgamma(k + 1.0) -
                                 std::lgamma(j + 1.0);
      }
    }
    auto pfa_of = [&](double t) {
      const double lt = std::log(t), l2t = std::log(2.0 + t),
                   l1t = std::log(1.0 + t);
      double mx = -std::numeric_limits<double>::infinity();
      for (int k = 0; k < np; ++k) {
        for (int j = 0; j < m; ++j) {
          mx = std::max(mx, lco[(size_t)k * m + j] + k * lt -
                                (m + k + j) * l2t);
        }
      }
      double s = 0.0;
      for (int k = 0; k < np; ++k) {
        for (int j = 0; j < m; ++j) {
          s += std::exp(lco[(size_t)k * m + j] + k * lt -
                        (m + k + j) * l2t - mx);
        }
      }
      const double so = 2.0 * std::exp(mx) * s;
      if (kind == 1) return so;
      double half = 0.0;
      for (int k = 0; k < np; ++k) {
        half += std::exp(lbin[k] + k * lt - (m + k) * l1t);
      }
      return 2.0 * half - so;
    };
    double lo = 1e-9, hi = 1e9;
    for (int it = 0; it < 200; ++it) {
      const double mid = std::sqrt(lo * hi);
      if (pfa_of(mid) > pfa) {
        lo = mid;
      } else {
        hi = mid;
      }
    }
    return std::sqrt(lo * hi);
  }
  // Exact GO/SO-CFAR false-alarm rates for exponential noise with n
  // cells per half and threshold t * S_half [Gandhi & Kassam 1988]:
  //   Pfa_SO(t) = 2 * sum_{k=0}^{n-1} C(n-1+k, k) * (2+t)^-(n+k)
  //   Pfa_GO(t) = 2 * (1+t)^-n - Pfa_SO(t)
  // Monotone decreasing in t; geometric bisection in log space (matches
  // mmradar.golden.go_so_cfar_alpha).
  const int n = n_half;
  std::vector<double> log_binom(n);
  for (int k = 0; k < n; ++k) {
    log_binom[k] =
        std::lgamma((double)n + k) - std::lgamma(k + 1.0) - std::lgamma((double)n);
  }
  auto pfa_of = [&](double t) {
    const double l2t = std::log(2.0 + t);
    double mx = -std::numeric_limits<double>::infinity();
    for (int k = 0; k < n; ++k) {
      mx = std::max(mx, log_binom[k] - (n + k) * l2t);
    }
    double s = 0.0;
    for (int k = 0; k < n; ++k) {
      s += std::exp(log_binom[k] - (n + k) * l2t - mx);
    }
    const double so = 2.0 * std::exp(mx) * s;
    if (kind == 1) return so;
    return 2.0 * std::pow(1.0 + t, -(double)n) - so;
  };
  double lo = 1e-9, hi = 1e9;
  for (int it = 0; it < 200; ++it) {
    const double mid = std::sqrt(lo * hi);
    if (pfa_of(mid) > pfa) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return std::sqrt(lo * hi);
}

void radar_go_so_cfar(const double* power, int d, int r, int guard_d,
                      int guard_r, int train_d, int train_r, double pfa,
                      int kind, int n_pulses, int range_mode,
                      double* threshold, uint8_t* hits) {
  const int wd = guard_d + train_d, wr = guard_r + train_r;
  const int n_half = (2 * wd + 1) * wr - (2 * guard_d + 1) * guard_r;
  const double t = radar_go_so_cfar_alpha(n_half, pfa, kind,
                                          n_pulses);
  for (int i = 0; i < d; ++i) {
    for (int j = 0; j < r; ++j) {
      double lead = 0.0, lag = 0.0;
      for (int dd = -wd; dd <= wd; ++dd) {
        const int id = ((i + dd) % d + d) % d;  // Doppler wraps
        for (int dr = 1; dr <= wr; ++dr) {
          if (std::abs(dd) <= guard_d && dr <= guard_r) continue;
          int jl = j + dr, jg = j - dr;
          if (range_mode == 1) {
            jl = reflect_index(jl, r);
            jg = reflect_index(jg, r);
          } else {
            jl = (jl % r + r) % r;
            jg = (jg % r + r) % r;
          }
          lead += power[(size_t)id * r + jl];
          lag += power[(size_t)id * r + jg];
        }
      }
      const double noise = kind == 0 ? std::max(lead, lag) : std::min(lead, lag);
      threshold[(size_t)i * r + j] = t * noise;
      hits[(size_t)i * r + j] =
          power[(size_t)i * r + j] > threshold[(size_t)i * r + j] ? 1 : 0;
    }
  }
}

double radar_os_cfar_alpha(int n_train, int k, double pfa,
                           int n_pulses) {
  if (n_pulses > 1) {
    // Erlang-matched OS alpha (mmradar.golden._os_alpha_integrated):
    // Pfa(a) = k C(n,k) INT Q(N, a y) F^{k-1} (1-F)^{n-k} f(y) dy with
    // the integer-shape Erlang CDF, trapezoid rule on a dense grid.
    const int n = n_train, np = n_pulses;
    const int grid = 20001;
    const double y_max = np + 40.0 + 8.0 * std::sqrt((double)np);
    std::vector<double> y(grid), dens(grid);
    std::vector<double> lfact(np);
    for (int i = 0; i < np; ++i) lfact[i] = std::lgamma(i + 1.0);
    const double log_c = std::log((double)k) + std::lgamma(n + 1.0) -
                         std::lgamma(k + 1.0) - std::lgamma(n - k + 1.0);
    for (int g = 0; g < grid; ++g) {
      const double yy = 1e-9 + (y_max - 1e-9) * g / (grid - 1);
      y[g] = yy;
      double s = 0.0;
      for (int i = 0; i < np; ++i) {
        s += std::exp(i * std::log(yy) - lfact[i]);
      }
      const double ccdf = std::max(std::exp(-yy) * s, 1e-300);
      const double cdf = std::max(1.0 - ccdf, 1e-300);
      const double log_f =
          (np - 1) * std::log(yy) - yy - std::lgamma((double)np);
      dens[g] = std::exp(log_c + (k - 1) * std::log(cdf) +
                         (n - k) * std::log(ccdf) + log_f);
    }
    auto pfa_of = [&](double a) {
      double acc = 0.0, prev = 0.0;
      for (int g = 0; g < grid; ++g) {
        const double ay = a * y[g];
        double s = 0.0;
        for (int i = 0; i < np; ++i) {
          s += std::exp(i * std::log(ay) - lfact[i]);
        }
        const double q = std::exp(-ay) * s;
        const double v = q * dens[g];
        if (g) acc += 0.5 * (v + prev) * (y[g] - y[g - 1]);
        prev = v;
      }
      return acc;
    };
    double lo = 1e-6, hi = 1e6;
    for (int it = 0; it < 100; ++it) {
      const double mid = std::sqrt(lo * hi);
      if (pfa_of(mid) > pfa) {
        lo = mid;
      } else {
        hi = mid;
      }
    }
    return std::sqrt(lo * hi);
  }
  // Rohling's exponential-noise OS-CFAR Pfa, solved by bisection on
  // log Pfa(alpha) = log k + lgamma(N+1) - lgamma(k+1) - lgamma(N-k+1)
  //                + lgamma(alpha+N-k+1) + lgamma(k) - lgamma(alpha+N+1)
  // (matches mmradar.golden.os_cfar_alpha bit-for-bit in double).
  const double log_choose = std::log((double)k) + std::lgamma(n_train + 1.0) -
                            std::lgamma(k + 1.0) -
                            std::lgamma(n_train - k + 1.0);
  const double target = std::log(pfa);
  double lo = 1e-6, hi = 1e6;
  for (int it = 0; it < 200; ++it) {
    const double mid = 0.5 * (lo + hi);
    const double a = mid + n_train - k + 1.0;
    const double lp =
        log_choose + std::lgamma(a) + std::lgamma((double)k) - std::lgamma(a + k);
    if (lp > target) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return 0.5 * (lo + hi);
}

double radar_clutter_map_alpha(double pfa, double beta, int block,
                               int n_pulses) {
  // Twin of mmradar.golden.clutter_map_alpha: the background m is a
  // weighted sum of per-block Gamma(N*block)/block means with weights
  // w_i = beta*(1-beta)^i/block, so
  //   log M(-a)   = -s * sum_i log1p(a*w_i),   s = N*block
  //   Pfa(a)      = sum_{k<N} a^k/k! * M^(k)(-a)
  // with M^(k) from the log-derivative recursion carried as positive
  // ratios R_k = M^(k)/M (log-space stable); same truncation, same
  // geometric-midpoint bisection as the Python twin.
  if (beta <= 0.0 || beta >= 1.0 || block < 1 || n_pulses < 1) return -1.0;
  int n_terms = 1;
  while (beta * std::pow(1.0 - beta, (double)n_terms) > 1e-14 &&
         n_terms < 100000) {
    ++n_terms;
  }
  std::vector<double> w((size_t)n_terms);
  for (int i = 0; i < n_terms; ++i) {
    w[i] = beta * std::pow(1.0 - beta, (double)i) / block;
  }
  const double s = (double)block * n_pulses;
  auto log_pfa = [&](double a) {
    double logm = 0.0;
    for (int i = 0; i < n_terms; ++i) logm -= s * std::log1p(a * w[i]);
    if (n_pulses == 1) return logm;
    std::vector<double> lr((size_t)n_pulses, 0.0);  // lr[r] = L^(r)(-a)
    for (int rr = 1; rr < n_pulses; ++rr) {
      double acc = 0.0;
      for (int i = 0; i < n_terms; ++i) {
        acc += std::pow(w[i] / (1.0 + a * w[i]), (double)rr);
      }
      lr[rr] = s * std::tgamma((double)rr) * acc;
    }
    std::vector<double> ratio((size_t)n_pulses, 0.0);
    ratio[0] = 1.0;
    for (int k = 1; k < n_pulses; ++k) {
      double acc = 0.0;
      for (int j = 0; j < k; ++j) {
        // C(k-1, j) via lgamma (exact for these small integers)
        const double comb = std::exp(std::lgamma((double)k) -
                                     std::lgamma((double)j + 1.0) -
                                     std::lgamma((double)(k - j)));
        acc += comb * ratio[j] * lr[k - j];
      }
      ratio[k] = acc;
    }
    double series = 0.0, ak = 1.0, kf = 1.0;
    for (int k = 0; k < n_pulses; ++k) {
      if (k > 0) {
        ak *= a;
        kf *= k;
      }
      series += ak / kf * ratio[k];
    }
    return logm + std::log(series);
  };
  double lo = 1e-6, hi = 1e9;
  const double target = std::log(pfa);
  for (int it = 0; it < 200; ++it) {
    const double mid = std::sqrt(lo * hi);
    if (log_pfa(mid) > target) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return std::sqrt(lo * hi);
}

void radar_clutter_map_cfar(const double* power, int frames, int d,
                            int r, double pfa, double beta, int block,
                            int n_pulses, const double* m0,
                            uint8_t* hits, double* m_out) {
  const double alpha = radar_clutter_map_alpha(pfa, beta, block, n_pulses);
  const size_t cells = (size_t)d * r;
  std::vector<double> m(cells, 0.0);
  int start = 0;
  if (m0 == nullptr) {
    // first block seeds the map with its mean; those frames emit no hits
    start = frames < block ? frames : block;
    for (int f = 0; f < start; ++f) {
      for (size_t c = 0; c < cells; ++c) m[c] += power[(size_t)f * cells + c];
    }
    for (size_t c = 0; c < cells; ++c) m[c] /= start > 0 ? start : 1;
    for (int f = 0; f < start; ++f) {
      std::memset(hits + (size_t)f * cells, 0, cells);
    }
  } else {
    std::memcpy(m.data(), m0, cells * sizeof(double));
  }
  for (int f0 = start; f0 < frames; f0 += block) {
    const int f1 = std::min(f0 + block, frames);
    for (int f = f0; f < f1; ++f) {
      for (size_t c = 0; c < cells; ++c) {
        hits[(size_t)f * cells + c] =
            power[(size_t)f * cells + c] > alpha * m[c] ? 1 : 0;
      }
    }
    // update with the (possibly partial) block mean, same beta
    std::vector<double> blk(cells, 0.0);
    for (int f = f0; f < f1; ++f) {
      for (size_t c = 0; c < cells; ++c) blk[c] += power[(size_t)f * cells + c];
    }
    const double inv = 1.0 / (f1 - f0);
    for (size_t c = 0; c < cells; ++c) {
      m[c] = (1.0 - beta) * m[c] + beta * blk[c] * inv;
    }
  }
  std::memcpy(m_out, m.data(), cells * sizeof(double));
}

void radar_os_cfar(const double* power, int d, int r, int guard_d,
                   int guard_r, int train_d, int train_r, double pfa,
                   double k_frac, int stride, int n_pulses,
                   int range_mode, double* threshold, uint8_t* hits) {
  const int wd = guard_d + train_d, wr = guard_r + train_r;
  if (stride < 1) stride = 1;
  // training ring size (window minus guard block), decimated by stride in
  // the deterministic (dd, dr) ring order — identical to the Python twins
  const int n_full =
      (2 * wd + 1) * (2 * wr + 1) - (2 * guard_d + 1) * (2 * guard_r + 1);
  const int n_train = (n_full + stride - 1) / stride;
  int k = (int)std::llround(k_frac * n_train);
  if (k < 1) k = 1;
  if (k > n_train) k = n_train;
  const double alpha = radar_os_cfar_alpha(n_train, k, pfa,
                                           n_pulses);

  std::vector<double> ring((size_t)n_train);
  for (int i = 0; i < d; ++i) {
    for (int j = 0; j < r; ++j) {
      int m = 0, pos = 0;
      for (int dd = -wd; dd <= wd; ++dd) {
        for (int dr = -wr; dr <= wr; ++dr) {
          if (std::abs(dd) <= guard_d && std::abs(dr) <= guard_r) continue;
          if (pos++ % stride != 0) continue;
          const int id = ((i + dd) % d + d) % d;  // Doppler wraps
          int jr = j + dr;
          if (range_mode == 1) {
            jr = reflect_index(jr, r);
          } else {
            jr = (jr % r + r) % r;
          }
          ring[m++] = power[(size_t)id * r + jr];
        }
      }
      std::nth_element(ring.begin(), ring.begin() + (k - 1), ring.end());
      const double kth = ring[k - 1];
      threshold[(size_t)i * r + j] = alpha * kth;
      hits[(size_t)i * r + j] =
          power[(size_t)i * r + j] > threshold[(size_t)i * r + j] ? 1 : 0;
    }
  }
}

}  // extern "C"
