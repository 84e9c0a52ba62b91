// The port's host library: the render's host-side hot paths in C++, with a
// plain C interface (caller-owned buffers, an int status, the last error's
// message from jtn_error) loaded by ctypes from native/__init__.py.  No
// Python or NumPy header is included, so one build serves any interpreter.
//
//   jtn_wav_header / jtn_decode_wav   WAV bytes -> frames, channels, rate;
//                                     then float32 [frames, channels]
//   jtn_encode_pcm                    float32 -> PCM 16/24/32 bytes
//   jtn_fed_stream                    the wrapping playhead stream
//   jtn_build_segments                overlap-save windows [B, pad]
//   jtn_pick_hrtf                     nearest KEMAR filter per position
//   jtn_interp_plan                   interpolationCalculations per position
//   jtn_distance_phase_split          the distance cue's 12-bit phase split
//
// Each computes what the NumPy form beside its Python wrapper computes, bit
// for bit (tests/test_torch_native.py), and what the JAX package's
// extension computes (jefferson_tpu/native/_native.cpp): the reference's
// host runtime is C++ throughout (reference: Jefferson/src/Audio.cu:119-157,
// Jefferson/src/cudaPart.cu:21-63, Jefferson/src/SoundSource.cu:65-105).
// Built with -ffp-contract=off: a contracted a*b+c moves 1 + fsvs*r*r and
// the azimuth scan's distances by an ulp against NumPy.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

thread_local char g_error[256] = "";

int fail(const char* msg) {
  std::snprintf(g_error, sizeof g_error, "%s", msg);
  return 1;
}

// ---------------------------------------------------------------------------
// WAV codec

struct Wav {
  uint16_t tag = 0;
  uint16_t channels = 0;
  uint32_t rate = 0;
  uint16_t bits = 0;
  size_t data_off = 0;
  size_t data_len = 0;
};

// RIFF/WAVE: the first fmt chunk of at least 16 bytes and the first data
// chunk; a chunk that runs past the end is cut at the end.
bool parse_wav(const uint8_t* d, size_t len, Wav* w) {
  if (len < 12 || std::memcmp(d, "RIFF", 4) || std::memcmp(d + 8, "WAVE", 4)) return false;
  size_t pos = 12;
  bool have_fmt = false, have_data = false;
  while (pos + 8 <= len) {
    uint32_t size;
    std::memcpy(&size, d + pos + 4, 4);
    const uint8_t* id = d + pos;
    size_t body = pos + 8;
    size_t body_end = len - body < size ? len : body + size;
    if (!have_fmt && !std::memcmp(id, "fmt ", 4) && body_end - body >= 16) {
      std::memcpy(&w->tag, d + body, 2);
      std::memcpy(&w->channels, d + body + 2, 2);
      std::memcpy(&w->rate, d + body + 4, 4);
      std::memcpy(&w->bits, d + body + 14, 2);
      if (w->tag == 0xFFFE && body_end - body >= 26)
        std::memcpy(&w->tag, d + body + 24, 2);  // EXTENSIBLE: the SubFormat's tag
      have_fmt = true;
    } else if (!have_data && !std::memcmp(id, "data", 4)) {
      w->data_off = body;
      w->data_len = body_end - body;
      have_data = true;
    }
    pos = body + size + (size & 1);
  }
  return have_fmt && have_data;
}

bool supported(const Wav& w) {
  return (w.tag == 3 && (w.bits == 32 || w.bits == 64)) ||
         (w.tag == 1 && (w.bits == 8 || w.bits == 16 || w.bits == 24 || w.bits == 32));
}

int check_wav(const uint8_t* d, size_t len, Wav* w) {
  if (!parse_wav(d, len, w)) return fail("malformed WAV (missing fmt/data)");
  if (w->channels == 0) return fail("malformed fmt chunk (channels=0)");
  if (w->bits / 8 == 0) return fail("zero bit depth");
  if (!supported(*w)) {
    std::snprintf(g_error, sizeof g_error, "unsupported WAV format tag=%d bits=%d", w->tag,
                  w->bits);
    return 1;
  }
  return 0;
}

int64_t wav_frames(const Wav& w) {
  return static_cast<int64_t>(w.data_len / (static_cast<size_t>(w.bits / 8) * w.channels));
}

template <typename T>
T load(const uint8_t* p) {
  T v;
  std::memcpy(&v, p, sizeof v);
  return v;
}

// the quantizer of io/wavio._encode: x * 2^(bits-1) in float64, clipped to
// [-2^(bits-1), 2^(bits-1) - 1], rounded half to even (np.rint)
int64_t quantize(float x, double scale) {
  double v = static_cast<double>(x) * scale;
  v = v < -scale ? -scale : (v > scale - 1 ? scale - 1 : v);
  return static_cast<int64_t>(std::nearbyint(v));
}

// ---------------------------------------------------------------------------
// The plan core (reference: Jefferson/src/SoundSource.cu:65-105,
// Jefferson/src/hrtf_signals.cu:20-51, Jefferson/src/CPUSoundSource.cpp:
// 174-242,255-273): float32 throughout, C truncation at every int cast,
// non-normalized omegas.

const int kNumElev = 14;
const int kElev[kNumElev] = {-40, -30, -20, -10, 0, 10, 20, 30, 40, 50, 60, 70, 80, 90};
const float kAzIncr[kNumElev] = {6.43f, 6.00f, 5.00f, 5.00f, 5.00f, 5.00f, 5.00f,
                                 6.00f, 6.43f, 8.00f, 10.00f, 15.00f, 30.00f, 361.0f};
// azimuths per elevation row and each row's first filter
const int kAzCount[kNumElev] = {56, 60, 72, 72, 72, 72, 72, 60, 56, 45, 36, 24, 12, 1};
const int kAzOffset[kNumElev] = {0, 56, 116, 188, 260, 332, 404, 476, 536, 592, 637, 673, 697,
                                 709};

// two first-minimum linear scans: the elevation snapped to a multiple of 10
// (std::round rounds halves away from zero, as hrtf/kemar.round_half_away)
int32_t pick_one(float ele, float azi) {
  float ele_snap = std::round(ele / 10.0f) * 10.0f;
  int row = 0;
  float best = std::fabs(ele_snap - static_cast<float>(kElev[0]));
  for (int i = 1; i < kNumElev; i++) {
    float d = std::fabs(ele_snap - static_cast<float>(kElev[i]));
    if (d < best) {
      best = d;
      row = i;
    }
  }
  float azi_r = std::round(azi);
  float inc = kAzIncr[row];
  int best_i = 0;
  float bd = std::fabs(azi_r - 0.0f * inc);
  for (int i = 1; i < kAzCount[row]; i++) {
    float d = std::fabs(azi_r - static_cast<float>(i) * inc);
    if (d < bd) {
      bd = d;
      best_i = i;
    }
  }
  return kAzOffset[row] + best_i;
}

// the deltaTheta row of a phi; a phi outside the table is clamped to it
int row_of_phi(int phi) {
  int p = phi < kElev[0] ? kElev[0] : (phi > kElev[kNumElev - 1] ? kElev[kNumElev - 1] : phi);
  return (p - kElev[0]) / 10;
}

void interp_one(float ele, float azi, int32_t* idx, float* w, float* om, int8_t* case_out) {
  int phi0 = static_cast<int>(ele) / 10 * 10;  // C truncation, C integer division
  int phi1 = static_cast<int>(ele + 9.0f) / 10 * 10;
  float omega_e = (ele - static_cast<float>(phi0)) / 10.0f;
  float omega_f = (static_cast<float>(phi1) - ele) / 10.0f;
  float dt1 = kAzIncr[row_of_phi(phi0)];
  float dt2 = kAzIncr[row_of_phi(phi1)];
  auto theta_lo = [azi](float dt) {
    return static_cast<int>(static_cast<float>(static_cast<int>(azi / dt)) * dt);
  };
  auto theta_hi = [azi](float dt) {
    return static_cast<int>(static_cast<float>(static_cast<int>((azi + dt - 1.0f) / dt)) * dt);
  };
  int theta0 = theta_lo(dt1), theta1 = theta_hi(dt1);
  int theta2 = theta_lo(dt2), theta3 = theta_hi(dt2);
  float omega_a = (azi - static_cast<float>(theta0)) / dt1;
  float omega_b = (static_cast<float>(theta1) - azi) / dt1;
  float omega_c = (azi - static_cast<float>(theta2)) / dt2;
  float omega_d = (static_cast<float>(theta3) - azi) / dt2;

  idx[0] = pick_one(static_cast<float>(phi0), static_cast<float>(theta0));
  idx[1] = pick_one(static_cast<float>(phi0), static_cast<float>(theta1));
  idx[2] = pick_one(static_cast<float>(phi1), static_cast<float>(theta2));
  idx[3] = pick_one(static_cast<float>(phi1), static_cast<float>(theta3));
  om[0] = omega_a;
  om[1] = omega_b;
  om[2] = omega_c;
  om[3] = omega_d;
  om[4] = omega_e;
  om[5] = omega_f;

  int8_t c;
  if (idx[0] == idx[1] && idx[1] == idx[2] && idx[2] == idx[3]) c = 1;
  else if (idx[0] == idx[2]) c = 2;
  else if (idx[0] == idx[1]) c = 3;
  else c = 4;
  *case_out = c;
  switch (c) {
    case 1: w[0] = 1.0f; w[1] = 0.0f; w[2] = 0.0f; w[3] = 0.0f; break;
    case 2: w[0] = omega_b; w[1] = omega_a; w[2] = 0.0f; w[3] = 0.0f; break;
    case 3: w[0] = omega_f; w[1] = 0.0f; w[2] = omega_e; w[3] = 0.0f; break;
    default:
      w[0] = omega_f * omega_b;
      w[1] = omega_f * omega_a;
      w[2] = omega_e * omega_d;
      w[3] = omega_e * omega_c;
  }
}

}  // namespace

extern "C" {

const char* jtn_error(void) { return g_error; }

// Validate a WAV and give its sample count: frames, channels, sample rate.
int jtn_wav_header(const uint8_t* data, int64_t len, int64_t* frames, int32_t* channels,
                   int32_t* rate) {
  Wav w;
  if (len < 0) return fail("negative length");
  if (int rc = check_wav(data, static_cast<size_t>(len), &w)) return rc;
  *frames = wav_frames(w);
  *channels = w.channels;
  *rate = static_cast<int32_t>(w.rate);
  return 0;
}

// Decode a WAV's samples into out[frames * channels], interleaved; PCM
// scaled by 1 / 2^(bits-1) (libsndfile's sf_read_float).
int jtn_decode_wav(const uint8_t* data, int64_t len, float* out, int64_t n_out) {
  Wav w;
  if (len < 0) return fail("negative length");
  if (int rc = check_wav(data, static_cast<size_t>(len), &w)) return rc;
  const int64_t n = wav_frames(w) * w.channels;
  if (n != n_out) return fail("output size does not match the WAV's samples");
  const uint8_t* p = data + w.data_off;
  if (w.tag == 3 && w.bits == 32) {
    std::memcpy(out, p, static_cast<size_t>(n) * 4);
  } else if (w.tag == 3) {
    for (int64_t i = 0; i < n; i++) out[i] = static_cast<float>(load<double>(p + 8 * i));
  } else if (w.bits == 16) {
    const float k = 1.0f / 32768.0f;
    for (int64_t i = 0; i < n; i++) out[i] = load<int16_t>(p + 2 * i) * k;
  } else if (w.bits == 24) {
    const double k = 1.0 / 8388608.0;
    for (int64_t i = 0; i < n; i++) {
      int32_t v = p[3 * i] | (p[3 * i + 1] << 8) | (p[3 * i + 2] << 16);
      if (v >= (1 << 23)) v -= (1 << 24);
      out[i] = static_cast<float>(v * k);
    }
  } else if (w.bits == 32) {
    const double k = 1.0 / 2147483648.0;
    for (int64_t i = 0; i < n; i++) out[i] = static_cast<float>(load<int32_t>(p + 4 * i) * k);
  } else {  // 8-bit PCM is unsigned
    const float k = 1.0f / 128.0f;
    for (int64_t i = 0; i < n; i++) out[i] = (static_cast<int>(p[i]) - 128) * k;
  }
  return 0;
}

// x[n] -> little-endian PCM in out[n * bits / 8].
int jtn_encode_pcm(const float* x, int64_t n, int32_t bits, uint8_t* out) {
  if (bits != 16 && bits != 24 && bits != 32) return fail("bits must be 16, 24 or 32");
  const double scale = static_cast<double>(1LL << (bits - 1));
  for (int64_t i = 0; i < n; i++) {
    const int32_t v = static_cast<int32_t>(quantize(x[i], scale));
    if (bits == 16) {
      const int16_t s = static_cast<int16_t>(v);
      std::memcpy(out + 2 * i, &s, 2);
    } else if (bits == 24) {
      out[3 * i] = v & 0xFF;
      out[3 * i + 1] = (v >> 8) & 0xFF;
      out[3 * i + 2] = (v >> 16) & 0xFF;
    } else {
      std::memcpy(out + 4 * i, &v, 4);
    }
  }
  return 0;
}

// signal[n] repeated from its start (the wrapping playhead, reference:
// Jefferson/src/Audio.cu:121-139) into out[num_blocks * fpb].
int jtn_fed_stream(const float* x, int64_t n, int64_t num_blocks, int64_t fpb, float* out) {
  if (n <= 0) return fail("empty signal");
  if (num_blocks < 0 || fpb < 0) return fail("negative size");
  const int64_t total = num_blocks * fpb;
  int64_t pos = 0;
  for (int64_t i = 0; i < total;) {
    int64_t chunk = n - pos < total - i ? n - pos : total - i;
    std::memcpy(out + i, x + pos, static_cast<size_t>(chunk) * sizeof(float));
    i += chunk;
    pos += chunk;
    if (pos == n) pos = 0;
  }
  return 0;
}

// [hist | stream] -> out[B, pad] overlap-save windows, B = n_stream / fpb,
// window i starting at sample i * fpb.
int jtn_build_segments(const float* stream, int64_t n_stream, const float* hist, int64_t n_hist,
                       int64_t fpb, int64_t pad, float* out) {
  if (fpb <= 0 || pad < fpb || n_hist != pad - fpb || n_stream < 0 || n_stream % fpb)
    return fail("bad stream/history sizes");
  const int64_t b = n_stream / fpb;
  for (int64_t i = 0; i < b; i++) {
    float* row = out + i * pad;
    const int64_t s0 = i * fpb;  // window start in [hist | stream]
    const int64_t from_hist = s0 < n_hist ? n_hist - s0 : 0;
    if (from_hist) std::memcpy(row, hist + s0, static_cast<size_t>(from_hist) * sizeof(float));
    std::memcpy(row + from_hist, stream + (s0 + from_hist - n_hist),
                static_cast<size_t>(pad - from_hist) * sizeof(float));
  }
  return 0;
}

int jtn_pick_hrtf(const float* ele, const float* azi, int64_t n, int32_t* out) {
  for (int64_t i = 0; i < n; i++) out[i] = pick_one(ele[i], azi[i]);
  return 0;
}

// per position: idx[4] int32, the case's weights w[4], omegas A-F om[6], case
int jtn_interp_plan(const float* ele, const float* azi, int64_t n, int32_t* idx, float* w,
                    float* om, int8_t* c) {
  for (int64_t i = 0; i < n; i++)
    interp_one(ele[i], azi[i], idx + 4 * i, w + 4 * i, om + 6 * i, c + i);
  return 0;
}

// u = fsvs * r / num_bins in float64, split into a 12-bit head u_hi (its
// product with any bin k < 4096 is exact in fp32) and a tail u_lo; and
// 1 / (1 + fsvs * r * r) in float32 (ops/filters.distance_phase_split).
int jtn_distance_phase_split(double fsvs, const float* r, int64_t n, int64_t num_bins, float* hi,
                             float* lo, float* inv_frac) {
  const float fsvs32 = static_cast<float>(fsvs);
  for (int64_t i = 0; i < n; i++) {
    const double u =
        static_cast<double>(fsvs32) * static_cast<double>(r[i]) / static_cast<double>(num_bins);
    float uh = static_cast<float>(u);
    uint32_t bits;
    std::memcpy(&bits, &uh, 4);
    bits &= 0xFFFFF000u;  // sign, exponent and the top 11 mantissa bits
    std::memcpy(&uh, &bits, 4);
    hi[i] = uh;
    lo[i] = static_cast<float>(u - static_cast<double>(uh));
    const float frac = 1.0f + fsvs32 * r[i] * r[i];
    inv_frac[i] = 1.0f / frac;
  }
  return 0;
}

}  // extern "C"
