// evio — the native event readers of evflow_tpu_torch (a copy of
// evflow_tpu/native/evio.cpp less its OPTICS sweep, which the port keeps in
// optics_sweep.cpp, and its unbound ring batcher): the CSV reader, the
// Metavision EVT3 / EVT2 / EVT2.1 payload decoders and the exact coordinate
// analyzer. Exposed as a C ABI for ctypes.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 evio.cpp -o libevio.so
//        (native/__init__.py builds it at first use)

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// CSV event reader: parses "x,y[,t[,p]]" integer rows at fread speed.
// Returns number of events parsed, or -1 on open failure. Caller provides
// capacity-sized buffers; rows beyond capacity are dropped.
// ---------------------------------------------------------------------------
int64_t evio_load_csv(const char* path, int32_t* xs, int32_t* ys, int64_t* ts,
                      int32_t* ps, int64_t capacity) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  // Read whole file.
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> buf(sz + 1);
  size_t rd = fread(buf.data(), 1, sz, f);
  fclose(f);
  buf[rd] = '\0';

  int64_t n = 0;
  const char* p = buf.data();
  const char* end = buf.data() + rd;
  while (p < end && n < capacity) {
    // skip blank / header lines that don't start with a digit or '-'
    if (!((*p >= '0' && *p <= '9') || *p == '-')) {
      while (p < end && *p != '\n') p++;
      if (p < end) p++;
      continue;
    }
    int64_t vals[4] = {0, 0, n, 0};  // default t = row index, p = 0
    int col = 0;
    while (p < end && *p != '\n') {
      bool neg = false;
      if (*p == '-') { neg = true; p++; }
      int64_t v = 0;
      while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
      if (col < 4) vals[col] = neg ? -v : v;
      col++;
      if (p < end && *p == ',') p++;
      else break;
    }
    while (p < end && *p != '\n') p++;
    if (p < end) p++;
    if (col >= 2) {
      xs[n] = (int32_t)vals[0];
      ys[n] = (int32_t)vals[1];
      ts[n] = vals[2];
      ps[n] = (int32_t)vals[3];
      n++;
    }
  }
  return n;
}

// ---------------------------------------------------------------------------
// EVT3 decoder — Prophesee's 16-bit-word event format (the reference's actual
// camera input: Metavision Camera::from_file, …store.cpp:336). Word layout
// per the public EVT 3.0 spec (OpenEB evt3_raw_format.h): 4-bit type in
// bits 15:12 —
//   0x0 EVT_ADDR_Y   bits 10:0 = y (bit 11 = master/slave, ignored)
//   0x2 EVT_ADDR_X   bits 10:0 = x, bit 11 = polarity; emits one event
//   0x3 VECT_BASE_X  bits 10:0 = x base, bit 11 = polarity for vectors
//   0x4 VECT_12      bits 11:0 validity mask; emits <=12 events, base += 12
//   0x5 VECT_8       bits  7:0 validity mask; emits <=8 events,  base += 8
//   0x6 EVT_TIME_LOW bits 11:0 = t[11:0]
//   0x8 EVT_TIME_HIGH bits 11:0 = t[23:12]; wrap => +2^24 epoch
//   0x7/0xA/0xE/0xF CONTINUED_4 / EXT_TRIGGER / OTHERS / CONTINUED_12: skipped
// `data` is the binary payload AFTER the ASCII '%' header (parsed in Python).
// Returns events decoded (events beyond capacity are dropped).
// ---------------------------------------------------------------------------
int64_t evio_decode_evt3(const uint8_t* data, int64_t nbytes, int32_t* xs,
                         int32_t* ys, int64_t* ts, int32_t* ps,
                         int64_t capacity) {
  const uint16_t* w = reinterpret_cast<const uint16_t*>(data);
  int64_t nwords = nbytes / 2;
  int64_t n = 0;
  int32_t y = 0, vpol = 0, base_x = 0;
  int64_t t_high = 0, t_low = 0, epoch = 0;
  int64_t last_high = -1;
  for (int64_t i = 0; i < nwords; i++) {
    uint16_t v = w[i];
    switch (v >> 12) {
      case 0x0:
        y = v & 0x7FF;
        break;
      case 0x2:
        if (n < capacity) {
          xs[n] = v & 0x7FF;
          ys[n] = y;
          ps[n] = (v >> 11) & 1;
          ts[n] = epoch + (t_high << 12) + t_low;
          n++;
        }
        break;
      case 0x3:
        base_x = v & 0x7FF;
        vpol = (v >> 11) & 1;
        break;
      case 0x4: {
        uint16_t mask = v & 0xFFF;
        int64_t t = epoch + (t_high << 12) + t_low;
        for (int b = 0; b < 12; b++) {
          if ((mask >> b) & 1) {
            if (n < capacity) {
              xs[n] = base_x + b;
              ys[n] = y;
              ps[n] = vpol;
              ts[n] = t;
              n++;
            }
          }
        }
        base_x += 12;
        break;
      }
      case 0x5: {
        uint16_t mask = v & 0xFF;
        int64_t t = epoch + (t_high << 12) + t_low;
        for (int b = 0; b < 8; b++) {
          if ((mask >> b) & 1) {
            if (n < capacity) {
              xs[n] = base_x + b;
              ys[n] = y;
              ps[n] = vpol;
              ts[n] = t;
              n++;
            }
          }
        }
        base_x += 8;
        break;
      }
      case 0x6:
        t_low = v & 0xFFF;
        break;
      case 0x8: {
        int64_t th = v & 0xFFF;
        if (last_high >= 0 && th < last_high) epoch += (int64_t)1 << 24;
        last_high = th;
        t_high = th;
        break;
      }
      default:
        break;  // EXT_TRIGGER / OTHERS / CONTINUED_*: no CD events
    }
  }
  return n;
}

// ---------------------------------------------------------------------------
// EVT2 decoder — 32-bit little-endian words (OpenEB evt2_raw_format.h):
// type in bits 31:28 — 0x0 CD_OFF / 0x1 CD_ON carry t[5:0] in bits 27:22,
// x in 21:11, y in 10:0 (polarity = type); 0x8 TIME_HIGH carries t[33:6] in
// bits 27:0 (a wrap adds a 2^34 µs epoch). Mirrors io/evt2.py's vectorized
// numpy decoder (cross-checked in tests/test_io.py).
// ---------------------------------------------------------------------------
int64_t evio_decode_evt2(const uint8_t* data, int64_t nbytes, int32_t* xs,
                         int32_t* ys, int64_t* ts, int32_t* ps,
                         int64_t capacity) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(data);
  int64_t nwords = nbytes / 4;
  int64_t n = 0;
  int64_t t_high = 0, epoch = 0, last_high = -1;
  for (int64_t i = 0; i < nwords; i++) {
    uint32_t v = w[i];
    uint32_t typ = v >> 28;
    if (typ <= 0x1) {
      if (n < capacity) {
        xs[n] = (v >> 11) & 0x7FF;
        ys[n] = v & 0x7FF;
        ps[n] = (int32_t)typ;
        ts[n] = epoch + (t_high << 6) + ((v >> 22) & 0x3F);
        n++;
      }
    } else if (typ == 0x8) {
      int64_t th = v & 0x0FFFFFFF;
      if (last_high >= 0 && th < last_high) epoch += (int64_t)1 << 34;
      last_high = th;
      t_high = th;
    }  // EXT_TRIGGER / OTHERS / CONTINUED: no CD events
  }
  return n;
}

// ---------------------------------------------------------------------------
// EVT2.1 decoder — 64-bit little-endian words (OpenEB evt21_raw_format.h):
// type in bits 63:60 — 0x0 EVT_NEG / 0x1 EVT_POS are VECTOR events: t[5:0]
// in 59:54, x base in 53:43, y in 42:32, 32-bit validity mask in 31:0 (bit
// i => event at x+i); 0x8 TIME_HIGH carries t[33:6] in bits 59:32.
// swapped_halves != 0 reads the legacy layout (each 64-bit word stored with
// its high 32-bit half first); detection lives in Python (io/evt2.py).
// ---------------------------------------------------------------------------
int64_t evio_decode_evt21(const uint8_t* data, int64_t nbytes, int32_t* xs,
                          int32_t* ys, int64_t* ts, int32_t* ps,
                          int64_t capacity, int32_t swapped_halves) {
  const uint64_t* w = reinterpret_cast<const uint64_t*>(data);
  int64_t nwords = nbytes / 8;
  int64_t n = 0;
  int64_t t_high = 0, epoch = 0, last_high = -1;
  for (int64_t i = 0; i < nwords; i++) {
    uint64_t v = w[i];
    if (swapped_halves) v = (v << 32) | (v >> 32);
    uint32_t typ = (uint32_t)(v >> 60);
    if (typ <= 0x1) {
      int32_t xb = (int32_t)((v >> 43) & 0x7FF);
      int32_t y = (int32_t)((v >> 32) & 0x7FF);
      int64_t t = epoch + (t_high << 6) + (int64_t)((v >> 54) & 0x3F);
      uint32_t mask = (uint32_t)(v & 0xFFFFFFFFu);
      while (mask) {
        int b = __builtin_ctz(mask);
        mask &= mask - 1;
        if (n < capacity) {
          xs[n] = xb + b;
          ys[n] = y;
          ps[n] = (int32_t)typ;
          ts[n] = t;
          n++;
        }
      }
    } else if (typ == 0x8) {
      int64_t th = (int64_t)((v >> 32) & 0x0FFFFFFF);
      if (last_high >= 0 && th < last_high) epoch += (int64_t)1 << 34;
      last_high = th;
      t_high = th;
    }
  }
  return n;
}

// ---------------------------------------------------------------------------
// Exact coordinate analyzer — the CPU dedup oracle (group_track.cpp:648-700)
// but hash-map based (O(N) instead of O(N^2)). Returns unique count;
// unique coords written in first-occurrence stream order.
// ---------------------------------------------------------------------------
int64_t evio_analyze_coordinates(const int32_t* xs, const int32_t* ys,
                                 int64_t n, int32_t* ux, int32_t* uy) {
  std::vector<int64_t> seen;
  seen.reserve(n);
  // simple open-addressing table keyed on (x<<32)|y
  int64_t cap = 1;
  while (cap < n * 2) cap <<= 1;
  std::vector<int64_t> table(cap, -1);
  int64_t uniq = 0;
  for (int64_t i = 0; i < n; i++) {
    int64_t key = ((int64_t)xs[i] << 32) | (uint32_t)ys[i];
    int64_t h = (key * 0x9E3779B97F4A7C15LL) & (cap - 1);
    bool found = false;
    while (table[h] != -1) {
      if (table[h] == key) { found = true; break; }
      h = (h + 1) & (cap - 1);
    }
    if (!found) {
      table[h] = key;
      ux[uniq] = xs[i];
      uy[uniq] = ys[i];
      uniq++;
    }
  }
  return uniq;
}

}  // extern "C"
