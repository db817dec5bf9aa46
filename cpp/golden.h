// Native float64 golden model for the mmWave range-detection pipeline.
//
// C twin of mmradar/golden.py: decode/reshape (reference
// cudaBenchMarking.cpp:149-188), radix-2 FFT (:61-105), peak scan
// (:191-206) and the distance formula (:301-303), re-designed as a
// reusable C library (parameter struct + C ABI for ctypes) instead of the
// reference's file-scope #defines and benchmark-embedded logic.
#ifndef RADAR_GOLDEN_H_
#define RADAR_GOLDEN_H_

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

// Radar geometry + waveform parameters (defaults mirror the reference).
typedef struct {
  int num_samples;       // samples per chirp            (100)
  int num_chirps;        // chirps per frame             (128)
  int num_rx;            // RX antennas                  (4)
  double sample_rate_hz; // Fs                           (2.0e6)
  double slope_hz_per_s; // FM slope mu                  (5.987e12)
  double scan_fraction;  // peak-scan window fraction    (0.4)
} RadarParams;

typedef struct {
  int peak_bin;      // argmax over the scan window of the extended FFT
  int rescaled_bin;  // peak_bin * rx_samples / fft_size (integer division)
  double distance_m; // reference distance formula
  double magnitude;  // |X[peak_bin]|
} RangeDetection;

// Fill params with the reference defaults.
void radar_default_params(RadarParams* p);

// Derived sizes.
int radar_rx_samples(const RadarParams* p);   // chirps * samples
int radar_fft_size(const RadarParams* p);     // nextPow2(rx_samples)
int radar_scan_bins(const RadarParams* p);    // floor(scan_fraction * fft)
int radar_shorts_per_frame(const RadarParams* p);

// Decode one frame of interleaved (I0,I1,Q0,Q1) int16 into an RX-major
// complex cube: out[(rx*chirps + chirp)*samples + sample] split into
// re/im planes of rx_samples*num_rx doubles each.
void radar_decode_frame(const RadarParams* p, const int16_t* shorts,
                        double* out_re, double* out_im);

// In-place iterative radix-2 DIT FFT over n (power of two) points.
void radar_fft(double* re, double* im, int n);

// First index of max magnitude over [0, size).
int radar_find_abs_max(const double* re, const double* im, int size);

// Full per-frame pipeline: decode -> rx0 -> subtract base -> pad -> FFT ->
// peak scan -> distance.  base_re/base_im hold rx_samples doubles
// (frame 0's RX0 slice).  scratch_re/scratch_im (fft_size doubles each)
// may be NULL (internal allocation).
void radar_detect_frame(const RadarParams* p, const int16_t* frame,
                        const double* base_re, const double* base_im,
                        RangeDetection* out);

// Compute the base frame (frame 0 RX0 slice) from raw shorts.
void radar_base_frame(const RadarParams* p, const int16_t* frame0,
                      double* base_re, double* base_im);

// Streaming capture benchmark over a file.  Returns the number of
// processed frames (excluding the base frame), or -1 on I/O error.
// timings: [total, fft, preprocess, findmax] seconds; distances (may be
// NULL) receives one value per processed frame (caller-sized).
int radar_process_capture(const RadarParams* p, const char* path,
                          double* timings, double* distances,
                          int max_frames);

// Windowed range-Doppler map for one channel: input (chirps_in, samples_in)
// complex -> output (doppler_fft, range_fft) complex, Doppler axis
// fftshifted.  `window` selects the periodic cosine-sum window applied on
// both axes: 0 rect, 1 hann, 2 hamming, 3 blackman, 4 blackman-harris
// (0/1 keep their historical bool meaning).  Matches
// mmradar.golden.range_doppler_map / golden.window_fn.
void radar_range_doppler(const double* in_re, const double* in_im,
                         int chirps_in, int samples_in, int doppler_fft,
                         int range_fft, int window, double* out_re,
                         double* out_im);

// 2D cell-averaging CFAR (matches mmradar.golden.ca_cfar_2d): Doppler
// axis wraps, range axis per range_mode (0 = wrap, 1 = reflect — range is
// not circular).  power: (d, r) row-major; outputs threshold (d, r) and
// hit flags (0/1).
// n_pulses: non-coherent integration depth the alpha is solved for
// (1 = exponential closed form; N > 1 = Erlang-matched, see
// radar_ca_cfar_alpha_integrated).
void radar_ca_cfar(const double* power, int d, int r, int guard_d,
                   int guard_r, int train_d, int train_r, double pfa,
                   int n_pulses, int range_mode, double* threshold,
                   uint8_t* hits);

// CA-CFAR threshold RATIO t (threshold = t * training_sum) for N-pulse
// non-coherently integrated maps: cells Erlang-N, training sum
// Gamma(n*N), Pfa(t) = sum_{k<N} C(nN+k-1,k) t^k (1+t)^-(nN+k); reduces
// to pfa^{-1/n}-1 at N=1.  Matches mmradar.golden
// .ca_cfar_alpha_integrated (same bisection, double precision).
double radar_ca_cfar_alpha_integrated(int n_train, double pfa,
                                      int n_pulses);

// Ordered-statistic CFAR: threshold = alpha * k-th smallest training cell,
// k = round(k_frac * n_train); alpha from Rohling's exponential-noise Pfa
// (radar_os_cfar_alpha).  Same window geometry / edge conventions as
// radar_ca_cfar.
// n_pulses: non-coherent integration depth (1 = Rohling's Beta form;
// N > 1 = Erlang-matched via the numerical order-statistic integral,
// matching mmradar.golden.os_cfar_alpha).
double radar_os_cfar_alpha(int n_train, int k, double pfa, int n_pulses);
void radar_os_cfar(const double* power, int d, int r, int guard_d,
                   int guard_r, int train_d, int train_r, double pfa,
                   double k_frac, int stride, int n_pulses,
                   int range_mode, double* threshold, uint8_t* hits);

// Greatest-of (kind=0) / smallest-of (kind=1) cell-averaging CFAR:
// the training ring splits into range-leading (dr > 0) and range-lagging
// (dr < 0) halves (the dr == 0 column is excluded, n_half cells each);
// threshold = t * max/min(half sums) with t from the exact Gandhi-Kassam
// exponential-noise Pfa (radar_go_so_cfar_alpha).  Matches
// mmradar.golden.go_so_cfar_2d; same edge conventions as radar_ca_cfar.
// n_pulses: non-coherent integration depth (1 = the exponential
// Gandhi-Kassam forms; N > 1 = the Erlang-matched double-sum
// generalization, matching mmradar.golden.go_so_cfar_alpha).
double radar_go_so_cfar_alpha(int n_half, double pfa, int kind,
                              int n_pulses);
void radar_go_so_cfar(const double* power, int d, int r, int guard_d,
                      int guard_r, int train_d, int train_r, double pfa,
                      int kind, int n_pulses, int range_mode,
                      double* threshold, uint8_t* hits);

// Clutter-map (Nitzberg) CFAR threshold multiplier: per-cell recursive
// background updated once per `block` frames with the block mean,
// decision p > alpha * m against the pre-update map.  n_pulses = 1:
// the classic product form Pfa = prod_i (1 + a*b*(1-b)^i/s)^-s with
// s = block; N > 1: the Erlang-matched MGF-derivative series (matches
// mmradar.golden.clutter_map_alpha bit-for-bit in double).
double radar_clutter_map_alpha(double pfa, double beta, int block,
                               int n_pulses);

// Clutter-map CFAR over a (frames, d, r) power sequence (twin of
// mmradar.golden.clutter_map_cfar).  m0 may be NULL (the first block
// seeds the map and emits no hits); m_out receives the final map.
void radar_clutter_map_cfar(const double* power, int frames, int d,
                            int r, double pfa, double beta, int block,
                            int n_pulses, const double* m0,
                            uint8_t* hits, double* m_out);

#ifdef __cplusplus
}  // extern "C"
#endif

#endif  // RADAR_GOLDEN_H_
