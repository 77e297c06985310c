// Native host event compiler: NoteTracker + PolyphonyDispatcher + Trigger
// over the full song, emitting per-subvoice segment tables.
//
// Port of the Python pipeline in core/timeline.py (compile_timelines), which
// itself mirrors the reference semantics:
//   - NoteTracker block consumption with float32 clock arithmetic
//     (src/zang/notes.zig:162-206) — frame positions depend on f32 rounding,
//     so all time math here is plain `float` and the TU is compiled with
//     -ffp-contract=off (no FMA contractions).
//   - PolyphonyDispatcher slot routing with note-off matching, oldest-
//     released reuse, oldest-note-on stealing (src/zang/notes.zig:246-306).
//   - Trigger span splitting with cross-block carry and same-frame
//     later-impulse-wins (src/zang/trigger.zig:107-196).
//
// Params stay in Python; events are referenced by index, and segment dedup
// (continuation spans with equal params) uses caller-provided equality-class
// ids so dict value-equality semantics are preserved exactly.

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Impulse {
  int frame;     // block-relative frame
  int note_id;
  int event_id;
  int event_idx; // index into the song arrays
};

struct Slot {
  int note_id = 0;
  int event_id = 0;
  bool note_on = false;
  bool used = false;
};

struct TriggerState {
  bool has_note = false;
  int note_id = 0;
  int event_idx = 0;
};

}  // namespace

extern "C" {

// Returns 0 on success, 1 = events out of chronological order,
// 2 = segment capacity exceeded.
int zt_compile_timelines(
    const float* ev_t, const int32_t* ev_note_id,
    const uint8_t* ev_note_on, const int32_t* ev_eq_class, int num_events,
    int polyphony, float sample_rate, int64_t total_frames, int block_size,
    int64_t* seg_starts, uint8_t* seg_resets, int32_t* seg_event,
    int cap, int32_t* seg_counts) {
  // tracker state
  int next_song_event = 0;
  float t = 0.0f;

  std::vector<Slot> slots(polyphony);
  std::vector<TriggerState> trig(polyphony);
  std::vector<std::vector<Impulse>> per_voice(polyphony);
  for (int v = 0; v < polyphony; ++v) {
    seg_counts[v] = 0;
    per_voice[v].reserve(32);
  }

  auto append_seg = [&](int v, int64_t abs_start, bool reset,
                        int event_idx) -> bool {
    int32_t& count = seg_counts[v];
    if (count > 0 && !reset) {
      int prev_ev = seg_event[(int64_t)v * cap + count - 1];
      // continuation with value-equal params: skip (timeline.py dedup)
      if (ev_eq_class[prev_ev] == ev_eq_class[event_idx]) return true;
    }
    if (count >= cap) return false;
    int64_t base = (int64_t)v * cap + count;
    seg_starts[base] = abs_start;
    seg_resets[base] = reset ? 1 : 0;
    seg_event[base] = event_idx;
    ++count;
    return true;
  };

  for (int64_t block_start = 0; block_start < total_frames;
       block_start += block_size) {
    const int out_len = (int)(total_frames - block_start < block_size
                                  ? total_frames - block_start
                                  : block_size);

    // --- NoteTracker.consume (f32 arithmetic, notes.py:119-151) ---
    const float buf_time = (float)out_len / sample_rate;
    const float end_t = t + buf_time;
    std::vector<Impulse> impulses;
    float start_t = t;
    while (next_song_event < num_events) {
      const float note_t = ev_t[next_song_event];
      if (note_t < start_t) return 1;  // out of order
      if (!(note_t < end_t)) break;
      const float f = (note_t - t) / buf_time;
      int rel = (int)(f * (float)out_len);  // trunc toward zero
      if (rel > out_len - 1) rel = out_len - 1;
      ++next_song_event;
      impulses.push_back(Impulse{rel, ev_note_id[next_song_event - 1],
                                 next_song_event, next_song_event - 1});
      start_t = note_t;
    }
    t = end_t;

    // --- PolyphonyDispatcher.dispatch (notes.py:196-211) ---
    for (int v = 0; v < polyphony; ++v) per_voice[v].clear();
    for (const Impulse& imp : impulses) {
      const bool note_on = ev_note_on[imp.event_idx] != 0;
      int chosen = -1;
      if (!note_on) {
        for (int s = 0; s < polyphony; ++s) {
          if (slots[s].used && slots[s].note_id == imp.note_id &&
              slots[s].note_on) {
            chosen = s;
            break;
          }
        }
      } else {
        int best = -1;
        for (int s = 0; s < polyphony; ++s) {
          if (!slots[s].used) {
            chosen = s;
            break;
          }
          if (!slots[s].note_on &&
              (best < 0 || slots[s].event_id < slots[best].event_id)) {
            best = s;
          }
        }
        if (chosen < 0) {
          if (best >= 0) {
            chosen = best;
          } else {
            chosen = 0;
            for (int s = 1; s < polyphony; ++s) {
              if (slots[s].event_id < slots[chosen].event_id) chosen = s;
            }
          }
        }
      }
      if (chosen < 0) continue;
      slots[chosen] = Slot{imp.note_id, imp.event_id, note_on, true};
      per_voice[chosen].push_back(imp);
    }

    // --- Trigger.iterate per voice (trigger.py:42-107) ---
    for (int v = 0; v < polyphony; ++v) {
      const std::vector<Impulse>& imps = per_voice[v];
      TriggerState& tr = trig[v];
      std::size_t idx = 0;
      int start = 0;
      const int end = out_len;
      while (start < end) {
        int seg_start, seg_end;
        bool have_note = false;
        int note_id = 0, event_idx = 0;
        bool carried = false;
        if (tr.has_note) {
          if (idx < imps.size()) {
            const int next_frame = imps[idx].frame;
            if (next_frame > start) {
              seg_start = start;
              seg_end = next_frame < end ? next_frame : end;
              have_note = true;
              note_id = tr.note_id;
              event_idx = tr.event_idx;
              carried = true;
            }
          } else {
            seg_start = start;
            seg_end = end;
            have_note = true;
            note_id = tr.note_id;
            event_idx = tr.event_idx;
            carried = true;
          }
        }
        if (!carried) {
          // _next_note_span
          seg_start = start;
          seg_end = end;
          std::size_t i = idx;
          bool found = false;
          while (i < imps.size()) {
            const Impulse& imp = imps[i];
            if (imp.frame >= end) break;  // shouldn't happen
            if (imp.frame > start) {
              seg_end = imp.frame;  // silent gap span, no note
              break;
            }
            ++i;
            int note_end = end;
            if (i < imps.size() && imps[i].frame < end)
              note_end = imps[i].frame;
            if (note_end <= start) continue;  // same frame: later wins
            seg_end = note_end;
            have_note = true;
            note_id = imp.note_id;
            event_idx = imp.event_idx;
            found = true;
            break;
          }
          idx = i;
          (void)found;
        }
        start = seg_end;
        if (have_note) {
          const bool changed = !tr.has_note || note_id != tr.note_id;
          tr.has_note = true;
          tr.note_id = note_id;
          tr.event_idx = event_idx;
          if (!append_seg(v, block_start + seg_start, changed, event_idx))
            return 2;
        }
      }
    }
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Envelope compiler: C++ twin of ops/control.py compile_envelope +
// _PainterWalk (which mirror src/zang/painter.zig:67-120 and
// src/modules/Envelope.zig:38-108). All t accumulation is plain float with
// -ffp-contract=off, matching the Python f32 tables (np.cumsum f32) bit for
// bit. Segment tuples are (start, a, b, t_step, t0, shape).

namespace {

constexpr int SHAPE_CONST = 0;
constexpr int SHAPE_LINEAR = 1;
constexpr int SHAPE_SQUARED = 2;
constexpr int SHAPE_CUBED = 3;
// PaintCurve kind codes from the caller: 0 instantaneous, 1 linear,
// 2 squared, 3 cubed (shape ids align for 1..3).

struct SegOut {
  int64_t* start;
  float* a;
  float* b;
  float* t_step;
  float* t0;
  int32_t* shape;
  int cap;
  int count = 0;

  bool emit(int64_t s, float av, float bv, float ts, float tz, int sh) {
    if (bv == 0.0f && count > 0 && b[count - 1] == 0.0f && a[count - 1] == av)
      return true;  // merge equal consecutive constants
    if (count >= cap) return false;
    start[count] = s;
    a[count] = av;
    b[count] = bv;
    t_step[count] = ts;
    t0[count] = tz;
    shape[count] = sh;
    ++count;
    return true;
  }
};

struct PainterWalk {
  float t_value = 0.0f;
  bool finished = false;
  float last = 0.0f;
  float start = 0.0f;
  // current stage "table" context
  bool have_stage = false;
  int stage_kind = -1;
  float stage_dur = 0.0f;
  float stage_t_step = 0.0f;
  float stage_t = 0.0f;       // t after the last consumed sample
  float stage_t_prev = 0.0f;  // t before the next sample (t_base semantics)
  bool stage_crossed = false;
  float sr;
  SegOut* out;

  static float tp_of(int kind, float t) {
    const float it = 1.0f - t;
    if (kind == 1) return t;
    if (kind == 2) return 1.0f - it * it;
    return 1.0f - it * it * it;  // cubed
  }

  void new_curve() {
    start = last;
    t_value = 0.0f;
    finished = false;
    have_stage = false;
  }

  bool emit_const(int64_t s, float value) {
    return out->emit(s, value, 0.0f, 0.0f, 0.0f, SHAPE_CONST);
  }

  bool paint_flat(int64_t s, int64_t e, float value) {
    if (e > s) return emit_const(s, value);
    return true;
  }

  // returns new pos; sets *fin; *ok false on capacity overflow
  int64_t paint_toward(int64_t s, int64_t e, int kind, float dur, float goal,
                       bool* fin, bool* ok) {
    *ok = true;
    if (finished) {
      *fin = true;
      return s;
    }
    if (kind == 0) {  // instantaneous
      finished = true;
      t_value = 1.0f;
      last = goal;
      *fin = true;
      return s;
    }
    if (!have_stage || stage_kind != kind ||
        std::memcmp(&stage_dur, &dur, sizeof(float)) != 0) {
      // stage (re)parameterized mid-flight: continue from current t
      stage_kind = kind;
      stage_dur = dur;
      stage_t_step = 1.0f / (dur * sr);
      stage_t = t_value;
      stage_t_prev = t_value;
      stage_crossed = false;
      have_stage = true;
    }
    if (stage_crossed) {
      finished = true;
      *fin = true;
      return s;
    }
    const int64_t avail = e - s;
    if (avail <= 0) {
      *fin = false;
      return s;
    }
    const float t_base = stage_t;  // t before the first emitted sample
    const float bv = goal - start;
    int64_t n = 0;
    float t = stage_t;
    while (n < avail) {
      float tn = t + stage_t_step;
      ++n;
      if (tn >= 1.0f) {
        t = 1.0f;  // clamp (painter.zig:102-105)
        stage_crossed = true;
        break;
      }
      t = tn;
    }
    if (n > 0) {
      if (!out->emit(s, start, bv, stage_t_step, t_base,
                     kind == 1 ? SHAPE_LINEAR
                               : (kind == 2 ? SHAPE_SQUARED : SHAPE_CUBED))) {
        *ok = false;
        *fin = false;
        return s;
      }
      last = start + tp_of(kind, t) * bv;
      t_value = t;
      stage_t = t;
    }
    if (stage_crossed) {
      finished = true;
      *fin = true;
      return s + n;
    }
    *fin = false;
    return s + n;
  }
};

constexpr int ENV_IDLE = 0;
constexpr int ENV_ATTACK = 1;
constexpr int ENV_DECAY = 2;
constexpr int ENV_SUSTAIN = 3;
constexpr int ENV_RELEASE = 4;

}  // namespace

extern "C" {

// Returns 0 ok, 2 = capacity exceeded, 3 = note_on during release without a
// new note id (the reference asserts here — Envelope.zig:45).
int zt_compile_envelope(
    const int64_t* starts, const uint8_t* resets, int num_segs, int64_t total,
    const uint8_t* note_on, const int32_t* attack_kind, const float* attack_dur,
    const int32_t* decay_kind, const float* decay_dur,
    const int32_t* release_kind, const float* release_dur,
    const float* sustain, float sample_rate,
    int64_t* seg_start, float* a, float* b, float* t_step, float* t0,
    int32_t* shape, int cap, int32_t* out_count) {
  SegOut out{seg_start, a, b, t_step, t0, shape, cap};
  PainterWalk w;
  w.sr = sample_rate;
  w.out = &out;
  int state = ENV_IDLE;
  if (!w.emit_const(0, 0.0f)) return 2;

  auto change = [&](int ns) {
    state = ns;
    w.new_curve();
  };

  for (int k = 0; k < num_segs; ++k) {
    const int64_t s = starts[k];
    const int64_t e = (k + 1 < num_segs) ? starts[k + 1] : total;
    if (e <= s) continue;
    const bool reset = resets[k] != 0;
    int64_t pos = s;
    bool fin, ok;
    if (note_on[k]) {
      if (reset) change(ENV_ATTACK);
      if (state == ENV_IDLE) change(ENV_ATTACK);
      if (state == ENV_RELEASE) return 3;
      if (state == ENV_ATTACK) {
        pos = w.paint_toward(pos, e, attack_kind[k], attack_dur[k], 1.0f,
                             &fin, &ok);
        if (!ok) return 2;
        if (fin) change(sustain[k] < 1.0f ? ENV_DECAY : ENV_SUSTAIN);
      }
      if (state == ENV_DECAY) {
        pos = w.paint_toward(pos, e, decay_kind[k], decay_dur[k], sustain[k],
                             &fin, &ok);
        if (!ok) return 2;
        if (fin) change(ENV_SUSTAIN);
      }
      if (state == ENV_SUSTAIN) {
        if (!w.paint_flat(pos, e, sustain[k])) return 2;
        pos = e;
      }
    } else {
      if (state == ENV_IDLE) {
        if (!w.paint_flat(pos, e, 0.0f)) return 2;
      } else {
        if (state != ENV_RELEASE) change(ENV_RELEASE);
        pos = w.paint_toward(pos, e, release_kind[k], release_dur[k], 0.0f,
                             &fin, &ok);
        if (!ok) return 2;
        if (fin) change(ENV_IDLE);
        if (!w.paint_flat(pos, e, 0.0f)) return 2;
      }
    }
  }
  *out_count = out.count;
  return 0;
}

}  // extern "C"
