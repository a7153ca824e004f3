// Host decode kernels of the data loader: WAV decode + polyphase resample +
// peak normalize (a copy of dmel_codec_tpu/native/audio_kernels.cpp; host
// C++, no CUDA). Built at first use by native/build.py with the host
// compiler and driven from the loader's decode threads through ctypes, which
// releases the GIL for the whole call.
//
// Semantics contract (held in tests/test_torch_data_host.py against the
// scipy backend of data/audio.py and against the JAX package's copy):
//   * WAV: RIFF/WAVE, PCM 8/16/24/32-bit, IEEE float32/64, and
//     WAVE_FORMAT_EXTENSIBLE wrappers; channel downmix by mean, exactly
//     data/audio.py::read_wav.
//   * Resample: scipy.signal.resample_poly(x, up, down,
//     window=('kaiser', 5.0)): the same firwin taps (windowed sinc, DC-gain
//     normalized, Kaiser beta 5.0, half length 10*max(up,down)), the same
//     zero-pad/slice alignment, polyphase evaluation.
//   * Normalize: peak scale to 0.95.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <utility>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Kaiser-windowed sinc lowpass (scipy.signal.firwin semantics)
// ---------------------------------------------------------------------------

double bessel_i0(double x) {
  // power series; converges fast for the beta=5 range we use
  double sum = 1.0, term = 1.0;
  const double hx = x / 2.0;
  for (int k = 1; k < 64; ++k) {
    term *= (hx / k) * (hx / k);
    sum += term;
    if (term < 1e-18 * sum) break;
  }
  return sum;
}

// firwin(numtaps, cutoff, window=('kaiser', beta)) for odd numtaps,
// cutoff as fraction of Nyquist, scale=True (unity DC gain).
std::vector<double> firwin_kaiser(long numtaps, double cutoff, double beta) {
  std::vector<double> h(numtaps);
  const double m = (numtaps - 1) / 2.0;
  const double i0b = bessel_i0(beta);
  for (long n = 0; n < numtaps; ++n) {
    const double x = n - m;
    // sinc lowpass at `cutoff` (Nyquist-normalized): cutoff * sinc(cutoff*x)
    double s = (x == 0.0) ? cutoff
                          : std::sin(M_PI * cutoff * x) / (M_PI * x);
    const double r = 2.0 * n / (numtaps - 1) - 1.0;  // [-1, 1]
    const double w = bessel_i0(beta * std::sqrt(std::max(0.0, 1.0 - r * r))) / i0b;
    h[n] = s * w;
  }
  // scale=True: unity gain at DC
  double sum = 0.0;
  for (double v : h) sum += v;
  for (double& v : h) v /= sum;
  return h;
}

struct ResampleFilter {
  std::vector<float> taps;  // zero-padded like scipy resample_poly
  long n_pre_remove;
  // polyphase decomposition: phase p holds taps[j*up + p] REVERSED in j so
  // the inner product runs over contiguous x and contiguous taps
  std::vector<float> poly;  // [up][poly_len]
  long poly_len;
};

long upfirdn_len(long n_h, long n_x, long up, long down) {
  return ((n_x - 1) * up + n_h + down - 1) / down;
}

// Build the padded filter exactly as scipy.signal.resample_poly does.
const ResampleFilter& get_filter(int up, int down) {
  static std::map<std::pair<int, int>, ResampleFilter> cache;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  auto key = std::make_pair(up, down);
  auto it = cache.find(key);
  if (it != cache.end()) return it->second;

  const long max_rate = std::max(up, down);
  const double f_c = 1.0 / max_rate;
  const long half_len = 10 * max_rate;
  std::vector<double> h = firwin_kaiser(2 * half_len + 1, f_c, 5.0);
  for (double& v : h) v *= up;

  const long n_pre_pad = down - (half_len % down);
  long n_post_pad = 0;
  const long n_pre_remove = (half_len + n_pre_pad) / down;
  // scipy grows the post-pad until every requested output index exists;
  // up + down is a safe upper bound on that fixpoint (the per-call length
  // check below returns an error rather than reading past the filter)
  n_post_pad = up + down;

  ResampleFilter f;
  f.taps.resize(n_pre_pad + h.size() + n_post_pad, 0.0f);
  for (size_t i = 0; i < h.size(); ++i)
    f.taps[n_pre_pad + i] = static_cast<float>(h[i]);
  f.n_pre_remove = n_pre_remove;
  // rows padded to a SIMD-friendly multiple; the extra leading zeros (in
  // reversed storage) multiply x samples further back, contributing 0
  f.poly_len = ((((long)f.taps.size() + up - 1) / up + 15) / 16) * 16;
  f.poly.assign((size_t)up * f.poly_len, 0.0f);
  for (long j = 0; j < (long)f.taps.size(); ++j) {
    const long p = j % up, q = j / up;
    // reversed within the phase: inner product walks x FORWARD while the
    // filter walks BACKWARD, so store backward
    f.poly[(size_t)p * f.poly_len + (f.poly_len - 1 - q)] = f.taps[j];
  }
  return cache.emplace(key, std::move(f)).first->second;
}

// y[k] = sum_m x[m] * h[k*down - m*up]  (polyphase form)
//
// With t = (k + k0)*down, p = t % up, m_hi = t / up:
//   y[k] = sum_q x[m_hi - q] * h[q*up + p]
//        = sum_j x[m_hi - (poly_len-1) + j] * poly[p][j]   (j reversed)
// — a contiguous dot product the compiler auto-vectorizes.
inline float dot_block(const float* xp, const float* hp, long n) {
  // independent accumulators break the FP-add dependency chain so the
  // dot product pipelines / vectorizes (equivalent up to reassociation)
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  float a4 = 0.0f, a5 = 0.0f, a6 = 0.0f, a7 = 0.0f;
  long j = 0;
  for (; j + 8 <= n; j += 8) {
    a0 += xp[j] * hp[j];
    a1 += xp[j + 1] * hp[j + 1];
    a2 += xp[j + 2] * hp[j + 2];
    a3 += xp[j + 3] * hp[j + 3];
    a4 += xp[j + 4] * hp[j + 4];
    a5 += xp[j + 5] * hp[j + 5];
    a6 += xp[j + 6] * hp[j + 6];
    a7 += xp[j + 7] * hp[j + 7];
  }
  for (; j < n; ++j) a0 += xp[j] * hp[j];
  return ((a0 + a1) + (a2 + a3)) + ((a4 + a5) + (a6 + a7));
}

void upfirdn(const float* x, long n_x, const ResampleFilter& f, long up,
             long down, float* y, long k0, long n_out) {
  const long plen = f.poly_len;
  // phase/index recurrences replace the per-sample div/mod
  long t0 = k0 * down;
  long p = t0 % up;
  long m_hi = t0 / up;
  const long dp = down % up;
  const long dm = down / up;
  // outputs with no edge clamping: m_hi - plen + 1 >= 0 and m_hi <= n_x-1
  for (long k = 0; k < n_out; ++k) {
    const long m_start = m_hi - (plen - 1);
    const float* hp = &f.poly[(size_t)p * plen];
    if (m_start >= 0 && m_hi < n_x) {
      y[k] = dot_block(x + m_start, hp, plen);
    } else {
      long j_lo = m_start < 0 ? -m_start : 0;
      long j_hi = m_hi > n_x - 1 ? plen - (m_hi - (n_x - 1)) : plen;
      y[k] = j_hi > j_lo
                 ? dot_block(x + m_start + j_lo, hp + j_lo, j_hi - j_lo)
                 : 0.0f;
    }
    p += dp;
    m_hi += dm;
    if (p >= up) {
      p -= up;
      ++m_hi;
    }
  }
}

// ---------------------------------------------------------------------------
// Minimal RIFF/WAVE reader
// ---------------------------------------------------------------------------

struct WavInfo {
  int sample_rate = 0;
  int channels = 0;
  int bits = 0;
  int format = 0;  // 1 = PCM, 3 = IEEE float
  long n_frames = 0;
  long data_offset = 0;
};

bool read_header(FILE* f, WavInfo* info) {
  unsigned char buf[64];
  if (std::fread(buf, 1, 12, f) != 12) return false;
  if (std::memcmp(buf, "RIFF", 4) || std::memcmp(buf + 8, "WAVE", 4))
    return false;
  long data_size = -1;
  while (std::fread(buf, 1, 8, f) == 8) {
    const uint32_t chunk_size = buf[4] | (buf[5] << 8) | (buf[6] << 16) |
                                ((uint32_t)buf[7] << 24);
    if (!std::memcmp(buf, "fmt ", 4)) {
      unsigned char fmt[40];
      const size_t want = std::min<size_t>(chunk_size, sizeof(fmt));
      if (std::fread(fmt, 1, want, f) != want) return false;
      if (chunk_size > want) std::fseek(f, chunk_size - want, SEEK_CUR);
      info->format = fmt[0] | (fmt[1] << 8);
      info->channels = fmt[2] | (fmt[3] << 8);
      info->sample_rate =
          fmt[4] | (fmt[5] << 8) | (fmt[6] << 16) | ((uint32_t)fmt[7] << 24);
      info->bits = fmt[14] | (fmt[15] << 8);
      if (info->format == 0xFFFE && chunk_size >= 40)
        info->format = fmt[24] | (fmt[25] << 8);  // extensible subformat
    } else if (!std::memcmp(buf, "data", 4)) {
      info->data_offset = std::ftell(f);
      data_size = chunk_size;
      std::fseek(f, (chunk_size + 1) & ~1L, SEEK_CUR);
    } else {
      std::fseek(f, (chunk_size + 1) & ~1L, SEEK_CUR);
    }
    if (info->sample_rate && data_size >= 0) break;
  }
  if (!info->sample_rate || data_size < 0 || !info->channels || !info->bits)
    return false;
  info->n_frames = data_size / (info->channels * (info->bits / 8));
  return true;
}

// decode `frames` frames starting at frame `start` into mono float32
bool decode_mono(FILE* f, const WavInfo& wi, long start, long frames,
                 float* out) {
  const int bytes = wi.bits / 8;
  const long frame_bytes = (long)bytes * wi.channels;
  std::fseek(f, wi.data_offset + start * frame_bytes, SEEK_SET);
  std::vector<unsigned char> raw(frame_bytes * std::min<long>(frames, 65536));
  long done = 0;
  const double inv_ch = 1.0 / wi.channels;
  while (done < frames) {
    const long batch = std::min<long>(frames - done, 65536);
    if (std::fread(raw.data(), 1, frame_bytes * batch, f) !=
        (size_t)(frame_bytes * batch))
      return false;
    // vectorizable fast paths for the common formats
    if (wi.channels == 1 && wi.bits == 16 && wi.format != 3) {
      const int16_t* s = reinterpret_cast<const int16_t*>(raw.data());
      constexpr float k = 1.0f / 32768.0f;
      for (long i = 0; i < batch; ++i) out[done + i] = s[i] * k;
      done += batch;
      continue;
    }
    if (wi.channels == 1 && wi.bits == 32 && wi.format == 3) {
      std::memcpy(out + done, raw.data(), batch * sizeof(float));
      done += batch;
      continue;
    }
    if (wi.channels == 2 && wi.bits == 16 && wi.format != 3) {
      const int16_t* s = reinterpret_cast<const int16_t*>(raw.data());
      constexpr float k = 0.5f / 32768.0f;
      for (long i = 0; i < batch; ++i)
        out[done + i] = ((float)s[2 * i] + (float)s[2 * i + 1]) * k;
      done += batch;
      continue;
    }
    for (long i = 0; i < batch; ++i) {
      double acc = 0.0;
      const unsigned char* p = raw.data() + i * frame_bytes;
      for (int c = 0; c < wi.channels; ++c, p += bytes) {
        double v;
        if (wi.format == 3 && wi.bits == 32) {
          float fv;
          std::memcpy(&fv, p, 4);
          v = fv;
        } else if (wi.format == 3 && wi.bits == 64) {
          double dv;
          std::memcpy(&dv, p, 8);
          v = dv;
        } else if (wi.bits == 16) {
          int16_t s = p[0] | (p[1] << 8);
          v = s / 32768.0;
        } else if (wi.bits == 32) {
          int32_t s = p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24);
          v = s / 2147483648.0;
        } else if (wi.bits == 24) {
          int32_t s = (p[0] << 8) | (p[1] << 16) | ((uint32_t)p[2] << 24);
          v = (s >> 8) / 8388608.0;
        } else if (wi.bits == 8) {
          v = (p[0] - 128.0) / 128.0;
        } else {
          return false;
        }
        acc += v;
      }
      out[done + i] = static_cast<float>(acc * inv_ch);
    }
    done += batch;
  }
  return true;
}

long gcd_long(long a, long b) { return b ? gcd_long(b, a % b) : a; }

}  // namespace

extern "C" {

// Header probe: returns 0 on success.
int dmel_wav_info(const char* path, int* sample_rate, long* n_frames,
                  int* channels) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  WavInfo wi;
  const bool ok = read_header(f, &wi);
  std::fclose(f);
  if (!ok) return -2;
  *sample_rate = wi.sample_rate;
  *n_frames = wi.n_frames;
  *channels = wi.channels;
  return 0;
}

// Expected output length for a [start_s, start_s+dur_s) slice resampled to
// target_sr (dur_s < 0 means to EOF). Returns <0 on error.
long dmel_load_len(const char* path, double start_s, double dur_s,
                   int target_sr) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  WavInfo wi;
  const bool ok = read_header(f, &wi);
  std::fclose(f);
  if (!ok) return -2;
  long i0 = (long)std::lround(start_s * wi.sample_rate);
  long i1 = dur_s < 0 ? wi.n_frames
                      : i0 + (long)std::lround(dur_s * wi.sample_rate);
  i0 = std::max(0L, std::min(i0, wi.n_frames));
  i1 = std::max(i0, std::min(i1, wi.n_frames));
  const long n = i1 - i0;
  if (wi.sample_rate == target_sr) return n;
  const long g = gcd_long(wi.sample_rate, target_sr);
  const long up = target_sr / g, down = wi.sample_rate / g;
  return (n * up + down - 1) / down;  // ceil — scipy resample_poly length
}

// Decode + resample + (optionally) peak-normalize. Returns samples written
// (== dmel_load_len) or <0 on error. `peak` <= 0 disables normalization.
long dmel_load_wav(const char* path, double start_s, double dur_s,
                   int target_sr, float peak, float* out, long capacity) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  WavInfo wi;
  if (!read_header(f, &wi)) {
    std::fclose(f);
    return -2;
  }
  long i0 = (long)std::lround(start_s * wi.sample_rate);
  long i1 = dur_s < 0 ? wi.n_frames
                      : i0 + (long)std::lround(dur_s * wi.sample_rate);
  i0 = std::max(0L, std::min(i0, wi.n_frames));
  i1 = std::max(i0, std::min(i1, wi.n_frames));
  const long n = i1 - i0;

  std::vector<float> mono(n);
  const bool ok = decode_mono(f, wi, i0, n, mono.data());
  std::fclose(f);
  if (!ok) return -3;

  long n_out;
  float* dst;
  std::vector<float> resampled;
  if (wi.sample_rate == target_sr) {
    n_out = n;
    if (n_out > capacity) return -4;
    std::memcpy(out, mono.data(), n_out * sizeof(float));
    dst = out;
  } else {
    const long g = gcd_long(wi.sample_rate, target_sr);
    const long up = target_sr / g, down = wi.sample_rate / g;
    n_out = (n * up + down - 1) / down;
    if (n_out > capacity) return -4;
    const ResampleFilter& flt = get_filter((int)up, (int)down);
    const long avail =
        upfirdn_len((long)flt.taps.size(), n, up, down) - flt.n_pre_remove;
    if (avail < n_out) return -5;  // filter slack insufficient (see build)
    upfirdn(mono.data(), n, flt, up, down, out, flt.n_pre_remove, n_out);
    dst = out;
  }

  if (peak > 0.0f && n_out > 0) {
    float m = 0.0f;
    for (long i = 0; i < n_out; ++i) m = std::max(m, std::fabs(dst[i]));
    if (m >= 1e-10f) {
      const float s = peak / m;
      for (long i = 0; i < n_out; ++i) dst[i] *= s;
    }
  }
  return n_out;
}

}  // extern "C"
