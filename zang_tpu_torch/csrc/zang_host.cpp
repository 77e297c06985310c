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
// Envelope compiler: C++ twin of ops/control.py _PainterWalk and the JAX
// package's Python envelope walk (which mirror src/zang/painter.zig:67-120
// and src/modules/Envelope.zig:38-108). One call walks every voice of a
// part. All t accumulation is plain float with -ffp-contract=off, matching
// the Python f32 tables (np.cumsum f32) bit for bit. Segment tuples are
// (start, a, b, t_step, t0, shape).

#include <unordered_map>

namespace {

constexpr int SHAPE_CONST = 0;
constexpr int SHAPE_LINEAR = 1;
constexpr int SHAPE_SQUARED = 2;
constexpr int SHAPE_CUBED = 3;
// PaintCurve kind codes from the caller: 0 instantaneous, 1 linear,
// 2 squared, 3 cubed (shape ids align for 1..3).

// A stage with t_step below this (more than 2^22 samples to its crossing)
// is stepped a sample at a time and builds no table.
constexpr float MIN_TABLE_STEP = 1.0f / 4194304.0f;

struct SegOut {
  int64_t* start;
  float* a;
  float* b;
  float* t_step;
  float* t0;
  int32_t* shape;
  int64_t cap;
  int64_t count = 0;

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

// The t a stage reaches from t = 0: t[i] = fl(t[i-1] + t_step), t[-1] = 0,
// up to and including the crossing, which is clamped to 1
// (painter.zig:102-105). A stage that starts at t = 0 walks the same
// sequence whatever its kind, so the tables of one call are keyed by
// t_step's bits and grown only as far as a walk has asked.
struct StageTable {
  float step;
  std::vector<float> t;
  bool complete = false;  // t.back() is the crossing

  void grow_to(int64_t len) {
    float cur = t.empty() ? 0.0f : t.back();
    while (!complete && (int64_t)t.size() < len) {
      const float tn = cur + step;
      if (tn >= 1.0f) {
        t.push_back(1.0f);
        complete = true;
      } else {
        t.push_back(tn);
        cur = tn;
      }
    }
  }
};

struct StageTables {
  std::unordered_map<uint32_t, StageTable> by_step;  // nodes do not move
  int64_t table_walks = 0;
  int64_t stepped_walks = 0;

  StageTable* get(float step) {
    uint32_t key;
    std::memcpy(&key, &step, sizeof key);
    auto it = by_step.find(key);
    if (it == by_step.end()) {
      it = by_step.emplace(key, StageTable{}).first;
      it->second.step = step;
    }
    return &it->second;
  }
};

struct PainterWalk {
  float t_value = 0.0f;
  bool finished = false;
  float last = 0.0f;
  float start = 0.0f;
  // current stage context
  bool have_stage = false;
  int stage_kind = -1;
  float stage_dur = 0.0f;
  float stage_t_step = 0.0f;
  float stage_t = 0.0f;  // t after the last consumed sample
  bool stage_crossed = false;
  StageTable* table = nullptr;  // the stage's t sequence, if it began at t = 0
  int64_t table_pos = 0;        // samples of it consumed
  float sr;
  SegOut* out;
  StageTables* tables;

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

  // The samples of [s, s + avail) the stage paints, and its t after them:
  // read from the table in O(1), or stepped a sample at a time where the
  // stage began mid-flight (t != 0).
  int64_t advance(int64_t avail, float* t) {
    if (table != nullptr) {
      ++tables->table_walks;
      table->grow_to(table_pos + avail);
      const int64_t left = (int64_t)table->t.size() - table_pos;
      const int64_t n = avail < left ? avail : left;
      table_pos += n;
      *t = table->t[table_pos - 1];
      stage_crossed = table->complete && table_pos == (int64_t)table->t.size();
      return n;
    }
    ++tables->stepped_walks;
    int64_t n = 0;
    float tc = stage_t;
    while (n < avail) {
      const float tn = tc + stage_t_step;
      ++n;
      if (tn >= 1.0f) {
        tc = 1.0f;  // clamp (painter.zig:102-105)
        stage_crossed = true;
        break;
      }
      tc = tn;
    }
    *t = tc;
    return n;
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
      stage_crossed = false;
      have_stage = true;
      const bool fresh = t_value == 0.0f && stage_t_step >= MIN_TABLE_STEP;
      table = fresh ? tables->get(stage_t_step) : nullptr;
      table_pos = 0;
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
    float t;
    const int64_t n = advance(avail, &t);
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

// The per-segment inputs of a part, flat: segment j of every column.
struct EnvColumns {
  const int64_t* starts;
  const uint8_t* resets;
  const uint8_t* note_on;
  const int32_t* attack_kind;
  const float* attack_dur;
  const int32_t* decay_kind;
  const float* decay_dur;
  const int32_t* release_kind;
  const float* release_dur;
  const float* sustain;
};

// One voice's segments [lo, hi) of the columns. Returns 0 ok, 2 = capacity
// exceeded, 3 = note_on during release without a new note id.
int walk_voice(const EnvColumns& c, int64_t lo, int64_t hi, int64_t total,
               float sample_rate, SegOut* out, StageTables* tables) {
  PainterWalk w;
  w.sr = sample_rate;
  w.out = out;
  w.tables = tables;
  int state = ENV_IDLE;
  if (!w.emit_const(0, 0.0f)) return 2;

  auto change = [&](int ns) {
    state = ns;
    w.new_curve();
  };

  for (int64_t k = lo; k < hi; ++k) {
    const int64_t s = c.starts[k];
    const int64_t e = (k + 1 < hi) ? c.starts[k + 1] : total;
    if (e <= s) continue;
    const bool reset = c.resets[k] != 0;
    int64_t pos = s;
    bool fin, ok;
    if (c.note_on[k]) {
      if (reset) change(ENV_ATTACK);
      if (state == ENV_IDLE) change(ENV_ATTACK);
      if (state == ENV_RELEASE) return 3;
      if (state == ENV_ATTACK) {
        pos = w.paint_toward(pos, e, c.attack_kind[k], c.attack_dur[k], 1.0f,
                             &fin, &ok);
        if (!ok) return 2;
        if (fin) change(c.sustain[k] < 1.0f ? ENV_DECAY : ENV_SUSTAIN);
      }
      if (state == ENV_DECAY) {
        pos = w.paint_toward(pos, e, c.decay_kind[k], c.decay_dur[k],
                             c.sustain[k], &fin, &ok);
        if (!ok) return 2;
        if (fin) change(ENV_SUSTAIN);
      }
      if (state == ENV_SUSTAIN) {
        if (!w.paint_flat(pos, e, c.sustain[k])) return 2;
        pos = e;
      }
    } else {
      if (state == ENV_IDLE) {
        if (!w.paint_flat(pos, e, 0.0f)) return 2;
      } else {
        if (state != ENV_RELEASE) change(ENV_RELEASE);
        pos = w.paint_toward(pos, e, c.release_kind[k], c.release_dur[k], 0.0f,
                             &fin, &ok);
        if (!ok) return 2;
        if (fin) change(ENV_IDLE);
        if (!w.paint_flat(pos, e, 0.0f)) return 2;
      }
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// The envelopes of a part's voices in one call. Voice v's segments are
// [seg_offsets[v], seg_offsets[v + 1]) of the per-segment columns; its
// painter segments go to [out_offsets[v], out_offsets[v + 1]) of the
// outputs, their number to out_counts[v]. stage_walks[0] counts the stage
// walks read from a table, stage_walks[1] those stepped a sample at a time.
// Returns 0 ok, 2 = capacity exceeded, 3 = note_on during release without a
// new note id (the reference asserts here — Envelope.zig:45); *failed_voice
// is the voice that failed.
int zt_compile_envelopes(
    int num_voices, const int64_t* seg_offsets, const int64_t* starts,
    const uint8_t* resets, int64_t total, const uint8_t* note_on,
    const int32_t* attack_kind, const float* attack_dur,
    const int32_t* decay_kind, const float* decay_dur,
    const int32_t* release_kind, const float* release_dur,
    const float* sustain, float sample_rate, const int64_t* out_offsets,
    int64_t* seg_start, float* a, float* b, float* t_step, float* t0,
    int32_t* shape, int32_t* out_counts, int64_t* stage_walks,
    int32_t* failed_voice) {
  const EnvColumns cols{starts, resets, note_on, attack_kind, attack_dur,
                        decay_kind, decay_dur, release_kind, release_dur,
                        sustain};
  StageTables tables;
  int rc = 0;
  for (int v = 0; v < num_voices && rc == 0; ++v) {
    const int64_t o = out_offsets[v];
    SegOut out{seg_start + o, a + o, b + o, t_step + o, t0 + o, shape + o,
               out_offsets[v + 1] - o};
    rc = walk_voice(cols, seg_offsets[v], seg_offsets[v + 1], total,
                    sample_rate, &out, &tables);
    out_counts[v] = (int32_t)out.count;
    if (rc != 0) *failed_voice = v;
  }
  stage_walks[0] = tables.table_walks;
  stage_walks[1] = tables.stepped_walks;
  return rc;
}

}  // extern "C"
