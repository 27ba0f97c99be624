// midiparse — native Standard MIDI File parser of midi_vae_tpu_torch, a copy
// of the JAX package's midi_vae_tpu/native/midiparse.cc.
//
// The production-path implementation of the note-event contract defined
// by the pure-Python oracle in midi/smf.py (same tempo-map, running-
// status, and note-pairing semantics — the tests cross-check the two
// on generated files). Parsing thousands of .mid files is host-bound
// byte work, which is why it lives in the native runtime next to
// rollloader.cc rather than in Python.
//
// C ABI (ctypes):
//   void* midi_open(const char* path)      — parse; NULL on error
//   long  midi_n_notes(void*)
//   void  midi_get_notes(void*, double* onset, double* duration,
//                        int32_t* pitch, int32_t* velocity)
//   void  midi_close(void*)

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <vector>

namespace {

constexpr long kDefaultTempoUs = 500000;

struct Note {
  double onset, duration;
  int32_t pitch, velocity;
  bool operator<(const Note& o) const {
    // full (onset, duration, pitch, velocity) order — must match the Python
    // oracle's tuple sort exactly (midi/smf.py) or chord-doubled notes with
    // equal timing would make the cross-check order-dependent
    if (onset != o.onset) return onset < o.onset;
    if (duration != o.duration) return duration < o.duration;
    if (pitch != o.pitch) return pitch < o.pitch;
    return velocity < o.velocity;
  }
};

struct Parsed {
  std::vector<Note> notes;
};

struct RawEvent {
  long tick;
  int on;  // 0 = off, 1 = on; offs sort before ons at equal tick
  int pitch, vel;
  bool operator<(const RawEvent& o) const {
    if (tick != o.tick) return tick < o.tick;
    return on < o.on;
  }
};

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  uint8_t u8() {
    if (p >= end) {
      ok = false;
      return 0;
    }
    return *p++;
  }
  uint32_t u32be() {
    uint32_t v = 0;
    for (int i = 0; i < 4; ++i) v = (v << 8) | u8();
    return v;
  }
  uint16_t u16be() {
    uint16_t v = 0;
    for (int i = 0; i < 2; ++i) v = static_cast<uint16_t>((v << 8) | u8());
    return v;
  }
  long varlen() {
    // SMF spec caps variable-length quantities at 4 bytes; enforcing it
    // both rejects malformed streams and keeps the shift defined (an
    // unbounded loop of continuation bytes would shift into the sign bit)
    long v = 0;
    for (int i = 0; i < 4; ++i) {
      uint8_t b = u8();
      if (!ok) return 0;
      v = (v << 7) | (b & 0x7F);
      if (!(b & 0x80)) return v;
    }
    ok = false;
    return 0;
  }
  void skip(long n) {
    if (end - p < n) {
      ok = false;
      p = end;
    } else {
      p += n;
    }
  }
};

bool parse_buffer(const uint8_t* data, size_t size, Parsed* out) {
  Cursor c{data, data + size};
  if (size < 14 || std::memcmp(data, "MThd", 4) != 0) return false;
  c.skip(4);
  uint32_t hlen = c.u32be();
  c.u16be();  // format
  uint16_t ntrks = c.u16be();
  uint16_t division = c.u16be();
  if (hlen < 6) return false;  // negative skip would walk the cursor backward
  if ((division & 0x8000) && (division & 0xFF) == 0)
    return false;  // SMPTE with zero ticks/frame: tick→seconds would divide by zero
  c.skip(static_cast<long>(hlen) - 6);

  std::vector<std::pair<long, long>> tempo_changes;  // (tick, us/quarter)
  std::vector<RawEvent> raw;

  for (int trk = 0; trk < ntrks && c.ok; ++trk) {
    if (c.end - c.p < 8 || std::memcmp(c.p, "MTrk", 4) != 0) return false;
    c.skip(4);
    uint32_t tlen = c.u32be();
    if (c.end - c.p < static_cast<long>(tlen)) return false;
    Cursor t{c.p, c.p + tlen};
    c.skip(tlen);

    long tick = 0;
    uint8_t running = 0;
    while (t.p < t.end && t.ok) {
      tick += t.varlen();
      uint8_t status = t.u8();
      if (status & 0x80) {
        if (status < 0xF0) running = status;
      } else {
        --t.p;  // data byte: reuse running status
        status = running;
        if (!(status & 0x80)) return false;
      }
      uint8_t kind = status & 0xF0;
      if (kind == 0x90 || kind == 0x80) {
        int pitch = t.u8(), vel = t.u8();
        // data bytes are 7-bit; a high bit here means the stream is
        // desynchronized (and an unchecked pitch would index out of the
        // 128-row piano roll downstream)
        if ((pitch | vel) & 0x80) return false;
        bool on = kind == 0x90 && vel > 0;
        raw.push_back({tick, on ? 1 : 0, pitch, vel});
      } else if (kind == 0xA0 || kind == 0xB0 || kind == 0xE0) {
        t.skip(2);
      } else if (kind == 0xC0 || kind == 0xD0) {
        t.skip(1);
      } else if (status == 0xFF) {
        uint8_t meta = t.u8();
        long length = t.varlen();
        if (meta == 0x51 && length == 3) {
          long tempo = 0;
          for (int i = 0; i < 3; ++i) tempo = (tempo << 8) | t.u8();
          tempo_changes.emplace_back(tick, tempo);
        } else {
          t.skip(length);
        }
      } else if (status == 0xF0 || status == 0xF7) {
        t.skip(t.varlen());
      } else {
        return false;
      }
    }
    if (!t.ok) return false;
  }
  if (!c.ok) return false;

  // Tick → seconds (piecewise-linear tempo map, matching smf.py).
  std::sort(tempo_changes.begin(), tempo_changes.end());
  std::vector<long> anchor_t{0};
  std::vector<double> anchor_s{0.0};
  std::vector<long> tempos{kDefaultTempoUs};
  double smpte_rate = 0.0;
  if (division & 0x8000) {
    int fps = 256 - (division >> 8);
    int tpf = division & 0xFF;
    smpte_rate = static_cast<double>(fps) * tpf;
  } else {
    long ppq = division ? division : 96;
    long tempo = kDefaultTempoUs;
    for (auto& [ctick, ctempo] : tempo_changes) {
      anchor_s.push_back(anchor_s.back() +
                         static_cast<double>(ctick - anchor_t.back()) * tempo / (ppq * 1e6));
      anchor_t.push_back(ctick);
      tempos.push_back(ctempo);
      tempo = ctempo;
    }
    // negative sentinel carries ppq into the lambda; positive means SMPTE
    smpte_rate = -static_cast<double>(ppq);
  }
  auto tick_to_sec = [&](long tk) -> double {
    if (smpte_rate > 0) return tk / smpte_rate;
    double ppq = -smpte_rate;
    size_t i = std::upper_bound(anchor_t.begin(), anchor_t.end(), tk) - anchor_t.begin() - 1;
    return anchor_s[i] + static_cast<double>(tk - anchor_t[i]) * tempos[i] / (ppq * 1e6);
  };

  // Pair note-ons with matching offs (FIFO per pitch, offs first on ties).
  std::stable_sort(raw.begin(), raw.end());
  std::map<int, std::vector<std::pair<long, int>>> open;  // pitch → [(tick, vel)]
  long max_tick = 0;
  for (auto& e : raw) {
    max_tick = std::max(max_tick, e.tick);
    if (e.on) {
      open[e.pitch].emplace_back(e.tick, e.vel);
    } else {
      auto it = open.find(e.pitch);
      if (it != open.end() && !it->second.empty()) {
        auto [start, vel] = it->second.front();
        it->second.erase(it->second.begin());
        double s0 = tick_to_sec(start);
        out->notes.push_back({s0, tick_to_sec(e.tick) - s0, e.pitch, vel});
      }
    }
  }
  for (auto& [pitch, stack] : open) {  // unterminated notes close at track end
    for (auto& [start, vel] : stack) {
      double s0 = tick_to_sec(start);
      out->notes.push_back({s0, tick_to_sec(max_tick) - s0, pitch, vel});
    }
  }
  std::sort(out->notes.begin(), out->notes.end());
  return true;
}

}  // namespace

extern "C" {

void* midi_open(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(size);
  if (size > 0 && std::fread(buf.data(), 1, size, f) != static_cast<size_t>(size)) {
    std::fclose(f);
    return nullptr;
  }
  std::fclose(f);
  auto* parsed = new Parsed();
  if (!parse_buffer(buf.data(), buf.size(), parsed)) {
    delete parsed;
    return nullptr;
  }
  return parsed;
}

long midi_n_notes(void* handle) { return static_cast<Parsed*>(handle)->notes.size(); }

void midi_get_notes(void* handle, double* onset, double* duration, int32_t* pitch, int32_t* velocity) {
  auto* p = static_cast<Parsed*>(handle);
  for (size_t i = 0; i < p->notes.size(); ++i) {
    onset[i] = p->notes[i].onset;
    duration[i] = p->notes[i].duration;
    pitch[i] = p->notes[i].pitch;
    velocity[i] = p->notes[i].velocity;
  }
}

void midi_close(void* handle) { delete static_cast<Parsed*>(handle); }

}  // extern "C"
