// Frozen for the benchmark from zang_tpu_torch/csrc/zang_oracle.cpp (unchanged below).
// zang_oracle.cpp — reference-exact sequential inner loops for the golden
// oracle engine. Every loop reproduces the corresponding Zig module's
// per-sample float32 arithmetic (expression shapes and rounding order
// preserved; citations give file:line in the reference zang sources).
//
// Build: g++ -O2 -std=c++17 -fPIC -shared -ffp-contract=off
// (-ffp-contract=off is load-bearing: FMA contraction would change rounding.)

#include <cstdint>
#include <cmath>
#include <cstring>

namespace {

inline float utof23(uint32_t x) {
  // 32-bit value into float with 23 bits precision (PulseOsc.zig:19-21)
  uint32_t bits = (x >> 9) | 0x3f800000u;
  float f;
  std::memcpy(&f, &bits, 4);
  return f - 1.0f;
}

inline uint32_t ftou32(float v) {
  // float [0,1) into 0.32 fixed point (PulseOsc.zig:23-25)
  return (uint32_t)(v * 4294967296.0f * 0.99995f);
}

inline float clamp01(float v) { return v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v); }

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// SineOsc (src/modules/SineOsc.zig:23-87), exact mode: float phase accumulator.
// sin argument is (t + phase) * pi * 2.0 evaluated in that order (SineOsc.zig:4-6).
// Caller wraps t per mix block (t -= trunc(t), SineOsc.zig:38-40).
void zo_sine_exact(float* out, int n, float* t_io, int freq_is_buf, float freq_c,
                   const float* freq_b, int phase_is_buf, float phase_c,
                   const float* phase_b, float sample_rate) {
  float t = *t_io;
  const float pi = 3.14159265358979323846264338327950288f;  // f32-rounded
  if (!freq_is_buf) {
    float t_step = freq_c / sample_rate;
    for (int i = 0; i < n; i++) {
      float ph = phase_is_buf ? phase_b[i] : phase_c;
      out[i] += sinf((t + ph) * pi * 2.0f);
      t += t_step;
    }
  } else {
    float inv_sr = 1.0f / sample_rate;
    for (int i = 0; i < n; i++) {
      float ph = phase_is_buf ? phase_b[i] : phase_c;
      out[i] += sinf((t + ph) * pi * 2.0f);
      t += freq_b[i] * inv_sr;
    }
  }
  *t_io = t;
}

// SineOsc, parity mode: u32 fixed-point phase (order-free; the device contract).
// ifreq = u32(f32(2^32 / sr) * freq) mirroring PulseOsc's SRfcobasefrq scheme.
void zo_sine_parity(float* out, int n, uint32_t* cnt_io, int freq_is_buf,
                    float freq_c, const float* freq_b, int phase_is_buf,
                    float phase_c, const float* phase_b, float sample_rate) {
  uint32_t cnt = *cnt_io;
  const float pi = 3.14159265358979323846264338327950288f;
  const float srbase = 4294967296.0f / sample_rate;
  uint32_t ifreq_c = freq_is_buf ? 0 : (uint32_t)(int64_t)(srbase * freq_c);
  for (int i = 0; i < n; i++) {
    float ph = phase_is_buf ? phase_b[i] : phase_c;
    float t = utof23(cnt);
    out[i] += sinf((t + ph) * pi * 2.0f);
    uint32_t ifreq = freq_is_buf ? (uint32_t)(int64_t)(srbase * freq_b[i]) : ifreq_c;
    cnt += ifreq;
  }
  *cnt_io = cnt;
}

// ---------------------------------------------------------------------------
// PulseOsc (src/modules/PulseOsc.zig:77-157). Both modes identical: the
// reference is already u32 fixed-point. Constant-frequency path.
void zo_pulse_const(float* out, int n, uint32_t* cnt_io, float sample_rate,
                    float freq, float color) {
  if (freq < 0.0f || freq > sample_rate / 8.0f) return;  // PulseOsc.zig:82-84
  uint32_t cnt = *cnt_io;
  const float SRfcobasefrq = 4294967296.0f / sample_rate;
  uint32_t ifreq = (uint32_t)(SRfcobasefrq * freq);
  uint32_t brpt = ftou32(clamp01(color));
  const float gain = 0.7f;
  float gdf = gain / utof23(ifreq);
  float col = utof23(brpt);
  float cc121 = gdf * 2.0f * (col - 1.0f) + gain;
  float cc212 = gdf * 2.0f * col - gain;
  uint32_t state = ((uint32_t)(cnt - ifreq) < brpt) ? 0b011u : 0b000u;
  for (int i = 0; i < n; i++) {
    float p = utof23(cnt);
    state = ((state << 1) | (cnt < brpt ? 1u : 0u)) & 3u;
    uint32_t transition = state | ((cnt < ifreq ? 1u : 0u) << 2);
    float v;
    switch (transition) {
      case 0b011: v = gain; break;                          // up
      case 0b000: v = -gain; break;                         // down
      case 0b010: v = gdf * 2.0f * (col - p) + gain; break; // up down
      case 0b101: v = gdf * 2.0f * p - gain; break;         // down up
      case 0b111: v = cc121; break;                         // up down up
      case 0b100: v = cc212; break;                         // down up down
      default: v = 0.0f; break;                             // unreachable
    }
    out[i] += v;
    cnt += ifreq;
  }
  *cnt_io = cnt;
}

// PulseOsc controlled-frequency path (PulseOsc.zig:116-157): state derived
// per sample; out-of-range samples skip output AND phase advance.
void zo_pulse_ctl(float* out, int n, uint32_t* cnt_io, float sample_rate,
                  const float* freq, float color) {
  uint32_t cnt = *cnt_io;
  const float SRfcobasefrq = 4294967296.0f / sample_rate;
  uint32_t brpt = ftou32(clamp01(color));
  const float gain = 0.7f;
  float col = utof23(brpt);
  for (int i = 0; i < n; i++) {
    float s_freq = freq[i];
    if (s_freq < 0.0f || s_freq > sample_rate / 8.0f) continue;
    uint32_t ifreq = (uint32_t)(SRfcobasefrq * s_freq);
    float gdf = gain / utof23(ifreq);
    float cc121 = gdf * 2.0f * (col - 1.0f) + gain;
    float cc212 = gdf * 2.0f * col - gain;
    float p = utof23(cnt);
    uint32_t c = ((uint32_t)(cnt - ifreq) < brpt) ? 1u : 0u;
    uint32_t state = (cnt < brpt ? 1u : 0u) | (c << 1);
    uint32_t transition = state | ((cnt < ifreq ? 1u : 0u) << 2);
    float v;
    switch (transition) {
      case 0b011: v = gain; break;
      case 0b000: v = -gain; break;
      case 0b010: v = gdf * 2.0f * (col - p) + gain; break;
      case 0b101: v = gdf * 2.0f * p - gain; break;
      case 0b111: v = cc121; break;
      case 0b100: v = cc212; break;
      default: v = 0.0f; break;
    }
    out[i] += v;
    cnt += ifreq;
  }
  *cnt_io = cnt;
}

// ---------------------------------------------------------------------------
// TriSawOsc (src/modules/TriSawOsc.zig:77-156).
void zo_trisaw_const(float* out, int n, uint32_t* cnt_io, float sample_rate,
                     float freq, float color) {
  if (freq < 0.0f || freq > sample_rate / 8.0f) return;  // TriSawOsc.zig:84-86
  uint32_t cnt = *cnt_io;
  const float SRfcobasefrq = 4294967296.0f / sample_rate;
  uint32_t ifreq = (uint32_t)(SRfcobasefrq * freq);
  uint32_t brpt = ftou32(clamp01(color));
  const float gain = 0.7f;
  float f = utof23(ifreq);
  float omf = 1.0f - f;
  float rcpf = 1.0f / f;
  float col = utof23(brpt);
  float c1 = gain / col;
  float c2 = -gain / (1.0f - col);
  uint32_t state = ((uint32_t)(cnt - ifreq) < brpt) ? 3u : 0u;
  for (int i = 0; i < n; i++) {
    float p = utof23(cnt) - col;
    state = ((state << 1) | (cnt < brpt ? 1u : 0u)) & 3u;
    uint32_t s = state | ((cnt < ifreq ? 1u : 0u) << 2);
    float v;
    switch (s) {
      case 0b011: v = c1 * (p + p - f); break;  // up
      case 0b000: v = c2 * (p + p - f); break;  // down
      case 0b010: v = rcpf * (c2 * (p * p) - c1 * ((p - f) * (p - f))); break;
      case 0b101: v = -rcpf * (gain + c2 * ((p + omf) * (p + omf)) - c1 * (p * p)); break;
      case 0b111: v = -rcpf * (gain + c1 * omf * (p + p + omf)); break;
      case 0b100: v = -rcpf * (gain + c2 * omf * (p + p + omf)); break;
      default: v = 0.0f; break;
    }
    out[i] += gain + v;
    cnt += ifreq;
  }
  *cnt_io = cnt;
}

// TriSawOsc controlled frequency (TriSawOsc.zig:120-156): naive
// non-antialiased fallback on a float phase accumulator (exact mode).
void zo_trisaw_ctl_exact(float* out, int n, float* t_io, float sample_rate,
                         const float* freq, float color) {
  float t = *t_io;
  const float gain = 0.7f;
  for (int i = 0; i < n; i++) {
    float frac;
    if (color < 0.25f || color > 0.75f) {
      frac = (t - std::floor(t)) * 2.0f - 1.0f;
    } else {
      frac = t - std::floor(t);
      if (frac < 0.25f) frac = frac * 4.0f;
      else if (frac < 0.75f) frac = 1.0f - (frac - 0.25f) * 4.0f;
      else frac = (frac - 0.75f) * 4.0f - 1.0f;
    }
    out[i] += gain * frac;
    t += freq[i] / sample_rate;
  }
  *t_io = t - std::trunc(t);  // TriSawOsc.zig:154-155
}

// parity mode: same waveform shaping on a u32 phase.
void zo_trisaw_ctl_parity(float* out, int n, uint32_t* cnt_io, float sample_rate,
                          const float* freq, float color) {
  uint32_t cnt = *cnt_io;
  const float srbase = 4294967296.0f / sample_rate;
  const float gain = 0.7f;
  for (int i = 0; i < n; i++) {
    float t = utof23(cnt);
    float frac;
    if (color < 0.25f || color > 0.75f) {
      frac = t * 2.0f - 1.0f;
    } else {
      frac = t;
      if (frac < 0.25f) frac = frac * 4.0f;
      else if (frac < 0.75f) frac = 1.0f - (frac - 0.25f) * 4.0f;
      else frac = (frac - 0.75f) * 4.0f - 1.0f;
    }
    out[i] += gain * frac;
    cnt += (uint32_t)(int64_t)(srbase * freq[i]);
  }
  *cnt_io = cnt;
}

// ---------------------------------------------------------------------------
// Painter.paintToward (src/zang/painter.zig:67-120). Returns new index i;
// *finished set when the goal was reached before the end of the buffer.
// curve_kind: 0 instantaneous, 1 linear, 2 squared, 3 cubed.
int zo_paint_toward(float* buf, int n, int i, float* t_io, float* last_io,
                    float start, int curve_kind, float duration,
                    float sample_rate, float goal, int* finished) {
  float t = *t_io;
  float last = *last_io;
  *finished = 0;
  if (t >= 1.0f) { *finished = 1; return i; }
  if (curve_kind == 0) {
    *t_io = 1.0f;
    *last_io = goal;
    *finished = 1;
    return i;
  }
  float t_step = 1.0f / (duration * sample_rate);
  int fin = 0;
  while (!fin && i < n) {
    t += t_step;
    if (t >= 1.0f) { t = 1.0f; fin = 1; }
    float it = 1.0f - t;
    float tp;
    if (curve_kind == 1) tp = t;
    else if (curve_kind == 2) tp = 1.0f - it * it;
    else tp = 1.0f - it * it * it;
    last = start + tp * (goal - start);
    buf[i] += last;
    i++;
  }
  *t_io = t;
  *last_io = last;
  *finished = fin;
  return i;
}

// ---------------------------------------------------------------------------
// Filter SVF (src/modules/Filter.zig:96-151): 2x oversampled state-variable
// filter with denormal bias; type mix via l_mul/b_mul/h_mul (bypass in caller).
void zo_filter(float* out, const float* in, int n, float* l_io, float* b_io,
               float l_mul, float b_mul, float h_mul, int cutoff_is_buf,
               float cutoff_c, const float* cutoff_b, int res_is_buf,
               float res_c, const float* res_b) {
  const float fcdcoffset = 3.814697265625e-6f;  // 2^-18 (Filter.zig:8)
  float cut = 0.0f, res = 0.0f;
  if (!cutoff_is_buf) cut = clamp01(cutoff_c);
  if (!res_is_buf) res = 1.0f - clamp01(res_c);
  float l = *l_io, b = *b_io;
  for (int i = 0; i < n; i++) {
    if (cutoff_is_buf) cut = clamp01(cutoff_b[i]);
    if (res_is_buf) res = 1.0f - clamp01(res_b[i]);
    float inv = in[i] + fcdcoffset;
    l += cut * b - fcdcoffset;  // undo bias (1 sample delay)
    b += cut * (inv - b * res - l);
    l += cut * b;
    float h = inv - b * res - l;
    b += cut * h;
    out[i] += l * l_mul + b * b_mul + h * h_mul;
  }
  *l_io = l;
  *b_io = b;
}

// ---------------------------------------------------------------------------
// Noise pink filter (src/modules/Noise.zig:54-69), Paul Kellett taps.
// Driven by a caller-provided uniform [0,1) tape. Preserves the reference
// quirk: the b[] state is never written back, so it restarts at the caller's
// b values (zeros) every paint call (Noise.zig:68).
void zo_noise_pink(float* out, const float* tape, int n, const float* b_in) {
  float b0 = b_in[0], b1 = b_in[1], b2 = b_in[2], b3 = b_in[3], b4 = b_in[4],
        b5 = b_in[5], b6 = b_in[6];
  for (int i = 0; i < n; i++) {
    float white = tape[i] * 2.0f - 1.0f;
    b0 = 0.99886f * b0 + white * 0.0555179f;
    b1 = 0.99332f * b1 + white * 0.0750759f;
    b2 = 0.96900f * b2 + white * 0.1538520f;
    b3 = 0.86650f * b3 + white * 0.3104856f;
    b4 = 0.55000f * b4 + white * 0.5329522f;
    b5 = -0.7616f * b5 - white * 0.0168980f;
    out[i] += b0 + b1 + b2 + b3 + b4 + b5 + b6 + white * 0.5362f;
    b6 = white * 0.115926f;
  }
}

// ---------------------------------------------------------------------------
// Decimator (src/modules/Decimator.zig:39-56), exact mode.
void zo_decimator_exact(float* out, const float* in, int n, float* dval_io,
                        float* dcount_io, float ratio) {
  float dval = *dval_io, dcount = *dcount_io;
  for (int i = 0; i < n; i++) {
    dcount += ratio;
    if (dcount >= 1.0f) {
      dval = in[i];
      dcount -= 1.0f;
    }
    out[i] += dval;
  }
  *dval_io = dval;
  *dcount_io = dcount;
}

// ---------------------------------------------------------------------------
// Distortion (src/modules/Distortion.zig:40-66). type: 0 overdrive, 1 clip.
void zo_distortion(float* out, const float* in, int n, int type, float ingain,
                   float outgain, float offset) {
  float gain1 = std::pow(2.0f, ingain * 8.0f - 2.0f);
  if (type == 0) {
    float gain2 = outgain / std::atan(gain1);
    float offs = gain1 * offset;
    for (int i = 0; i < n; i++) {
      out[i] += gain2 * std::atan(in[i] * gain1 + offs);
    }
  } else {
    float gain2 = outgain;
    float offs = gain1 * offset;
    for (int i = 0; i < n; i++) {
      float a = in[i] * gain1 + offs;
      float b = a < -1.0f ? -1.0f : (a > 1.0f ? 1.0f : a);
      out[i] += gain2 * b;
    }
  }
}

// ---------------------------------------------------------------------------
// Cycle (src/modules/Cycle.zig:22-58): phasor 0..1 wrapping each sample.
void zo_cycle_exact(float* out, int n, float* t_io, int speed_is_buf,
                    float speed_c, const float* speed_b, float sample_rate) {
  float t = *t_io;
  if (!speed_is_buf) {
    float step = speed_c / sample_rate;
    for (int i = 0; i < n; i++) {
      out[i] += t;
      t += step;
      t -= std::trunc(t);
    }
  } else {
    float isr = 1.0f / sample_rate;
    for (int i = 0; i < n; i++) {
      out[i] += t;
      t += speed_b[i] * isr;
      t -= std::trunc(t);
    }
  }
  *t_io = t;
}

// ---------------------------------------------------------------------------
// Sampler (src/modules/Sampler.zig:24-136).
// format: 0 u8, 1 s16, 2 s24, 3 s32.
static inline float zo_get_sample(const uint8_t* data, int64_t data_len,
                                  int format, int num_channels, int channel,
                                  int loop, int32_t index1) {
  int bytes_per_sample = format == 0 ? 1 : (format == 1 ? 2 : (format == 2 ? 3 : 4));
  int32_t num_samples = (int32_t)(data_len / bytes_per_sample / num_channels);
  int32_t index = index1;
  if (loop) {
    index = index1 % num_samples;          // Zig @mod: result sign of divisor
    if (index < 0) index += num_samples;
  }
  if (index < 0 || index >= num_samples) return 0.0f;
  int64_t i = (int64_t)index * num_channels + channel;
  switch (format) {
    case 0:
      return ((float)data[i] - 127.5f) / 127.5f;
    case 1: {
      int16_t v;
      std::memcpy(&v, data + i * 2, 2);
      return (float)v / 32768.0f;
    }
    case 2: {
      int32_t v = data[i * 3] | (data[i * 3 + 1] << 8) | (data[i * 3 + 2] << 16);
      if (v >= (1 << 23)) v -= (1 << 24);
      return (float)v / 8388608.0f;
    }
    default: {
      int32_t v;
      std::memcpy(&v, data + i * 4, 4);
      return (float)v / 2147483648.0f;
    }
  }
}

// exact-mode resampling loop (Sampler.zig:115-130): t accumulates per sample.
void zo_sampler_resample_exact(float* out, int n, float* t_io, float ratio,
                               const uint8_t* data, int64_t data_len, int format,
                               int num_channels, int channel, int loop) {
  float t = *t_io;
  for (int i = 0; i < n; i++) {
    int32_t t0 = (int32_t)std::floor(t);
    int32_t t1 = t0 + 1;
    float tfrac = (float)t1 - t;
    float s0 = zo_get_sample(data, data_len, format, num_channels, channel, loop, t0);
    float s1 = zo_get_sample(data, data_len, format, num_channels, channel, loop, t1);
    // note: reference's interpolation weights are inverted vs standard lerp
    // (Sampler.zig:119-125); preserved.
    float s = s0 * (1.0f - tfrac) + s1 * tfrac;
    out[i] += s;
    t += ratio;
  }
  *t_io = t;
}

// parity-mode resampling: closed-form positions t_i = t0 + f32(i * ratio).
void zo_sampler_resample_parity(float* out, int n, float* t_io, float ratio,
                                const uint8_t* data, int64_t data_len, int format,
                                int num_channels, int channel, int loop) {
  float tstart = *t_io;
  for (int i = 0; i < n; i++) {
    float t = tstart + (float)i * ratio;
    int32_t t0 = (int32_t)std::floor(t);
    int32_t t1 = t0 + 1;
    float tfrac = (float)t1 - t;
    float s0 = zo_get_sample(data, data_len, format, num_channels, channel, loop, t0);
    float s1 = zo_get_sample(data, data_len, format, num_channels, channel, loop, t1);
    float s = s0 * (1.0f - tfrac) + s1 * tfrac;
    out[i] += s;
  }
  *t_io = tstart + (float)n * ratio;
}

// no-resample fast path (Sampler.zig:105-114)
void zo_sampler_copy(float* out, int n, float t_round, const uint8_t* data,
                     int64_t data_len, int format, int num_channels, int channel,
                     int loop) {
  int32_t t = (int32_t)t_round;
  for (int i = 0; i < n; i++) {
    out[i] += zo_get_sample(data, data_len, format, num_channels, channel, loop, t + i);
  }
}

// ---------------------------------------------------------------------------
// Curve interpolation inner loops (src/modules/Curve.zig:103-123).
void zo_curve_linear_exact(float* out, int n, float y0, float ystep) {
  float y = y0;
  for (int i = 0; i < n; i++) {
    out[i] += y;
    y += ystep;
  }
}

void zo_curve_smoothstep_exact(float* out, int n, float x0, float xstep,
                               float start_value, float delta) {
  float x = x0;
  for (int i = 0; i < n; i++) {
    float v = x * x * (3.0f - 2.0f * x) * delta;
    out[i] += start_value + v;
    x += xstep;
  }
}

// parity versions: closed-form index arithmetic (device contract).
void zo_curve_linear_parity(float* out, int n, float y0, float ystep) {
  for (int i = 0; i < n; i++) {
    out[i] += y0 + (float)i * ystep;
  }
}

void zo_curve_smoothstep_parity(float* out, int n, float x0, float xstep,
                                float start_value, float delta) {
  for (int i = 0; i < n; i++) {
    float x = x0 + (float)i * xstep;
    float v = x * x * (3.0f - 2.0f * x) * delta;
    out[i] += start_value + v;
  }
}


// ---------------------------------------------------------------------------
// FM feedback oscillator (examples/example_fmsynth.zig:70-88): the output
// feeds back through the wave shaper, so the loop is inherently sequential.
// base[i] = (t_i + phase) * 2pi, precomputed by the caller from the u32
// phase counter (the parity contract shared with ops/fm.py).
void zo_fm_feedback(float* out, const float* base, int n, float feedback,
                    int waveform, float* fb1_io, float* fb2_io) {
  float fb1 = *fb1_io, fb2 = *fb2_io;
  for (int i = 0; i < n; ++i) {
    const float p = base[i] + (fb1 + fb2) * feedback;
    const float s = sinf(p);
    float v;
    switch (waveform) {
      case 0: v = s; break;
      case 1: v = s > 0.0f ? s : 0.0f; break;
      case 2: v = fabsf(s); break;
      default: v = sinf(p * 2.0f) >= 0.0f ? fabsf(s) : 0.0f; break;
    }
    out[i] = v;
    fb2 = fb1;
    fb1 = v;
  }
  *fb1_io = fb1;
  *fb2_io = fb2;
}

}  // extern "C"
