// rustradio_tpu native host runtime.
//
// The reference implements its entire inter-block transport as an mmap'd,
// double-mapped SPSC circular buffer (reference src/nowasm/circular_buffer.rs:
// Circ::new maps one memfd twice back-to-back so every window is linear;
// produce/consume move atomic cursors; Condvar wakeups).  In this
// framework the *device* path needs no such buffer — but the host feed does:
// file/SDR/TCP bytes must be read, converted to planar f32 I/Q, and staged
// for device_put without stalling the compute stream.  This library is that
// host runtime: a lock-free SPSC ring with the same double-map trick, a
// background reader thread, and vectorizable sample-format converters.
//
// Build: g++ -O3 -march=native -shared -fPIC -o librr_native.so rr_native.cpp -lpthread

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cmath>
#include <vector>
#include <thread>
#include <chrono>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------- ring

struct RrRing {
  uint8_t* base;       // double-mapped region, 2*size bytes of address space
  size_t size;         // capacity in bytes (page multiple)
  std::atomic<uint64_t> head;  // write cursor (bytes, monotonically increasing)
  std::atomic<uint64_t> tail;  // read cursor
  std::atomic<int> eof;        // producer signalled end-of-stream
  std::atomic<int> err;        // producer error
};

static size_t round_up_pages(size_t n) {
  size_t p = (size_t)sysconf(_SC_PAGESIZE);
  return (n + p - 1) / p * p;
}

// Create a ring of at least `min_size` bytes. Returns NULL on failure.
RrRing* rr_ring_create(size_t min_size) {
  size_t size = round_up_pages(min_size);
  int fd = memfd_create("rr_ring", 0);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, (off_t)size) != 0) {
    close(fd);
    return nullptr;
  }
  // Reserve 2*size of address space, then map the fd twice into it: the
  // double-map trick (reference circular_buffer.rs Map::with_addr,
  // :34-74) — any window of `size` bytes is linear.
  void* reserve = mmap(nullptr, 2 * size, PROT_NONE,
                       MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
  if (reserve == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  void* a = mmap(reserve, size, PROT_READ | PROT_WRITE,
                 MAP_SHARED | MAP_FIXED, fd, 0);
  void* b = mmap((uint8_t*)reserve + size, size, PROT_READ | PROT_WRITE,
                 MAP_SHARED | MAP_FIXED, fd, 0);
  close(fd);
  if (a == MAP_FAILED || b == MAP_FAILED) {
    munmap(reserve, 2 * size);
    return nullptr;
  }
  auto* r = new RrRing();
  r->base = (uint8_t*)reserve;
  r->size = size;
  r->head.store(0);
  r->tail.store(0);
  r->eof.store(0);
  r->err.store(0);
  return r;
}

void rr_ring_destroy(RrRing* r) {
  if (!r) return;
  munmap(r->base, 2 * r->size);
  delete r;
}

size_t rr_ring_capacity(RrRing* r) { return r->size; }

size_t rr_ring_readable(RrRing* r) {
  return (size_t)(r->head.load(std::memory_order_acquire) -
                  r->tail.load(std::memory_order_relaxed));
}

size_t rr_ring_writable(RrRing* r) {
  return r->size - rr_ring_readable(r);
}

int rr_ring_eof(RrRing* r) {
  return r->eof.load(std::memory_order_acquire) && rr_ring_readable(r) == 0;
}

int rr_ring_error(RrRing* r) { return r->err.load(std::memory_order_acquire); }

void rr_ring_set_eof(RrRing* r) { r->eof.store(1, std::memory_order_release); }

// Producer: copy n bytes in (blocking until space or consumer gone).
// Returns bytes written (== n), or 0 if the ring is closed.
size_t rr_ring_write(RrRing* r, const void* data, size_t n) {
  const uint8_t* src = (const uint8_t*)data;
  size_t done = 0;
  while (done < n) {
    size_t avail = rr_ring_writable(r);
    if (avail == 0) {
      std::this_thread::sleep_for(std::chrono::microseconds(50));
      continue;
    }
    size_t take = std::min(avail, n - done);
    uint64_t h = r->head.load(std::memory_order_relaxed);
    memcpy(r->base + (h % r->size), src + done, take);  // linear: double map
    r->head.store(h + take, std::memory_order_release);
    done += take;
  }
  return done;
}

// Consumer: peek a linear pointer to up to n readable bytes.
// Returns the number of bytes addressable at *ptr.
size_t rr_ring_peek(RrRing* r, uint8_t** ptr, size_t n) {
  size_t avail = rr_ring_readable(r);
  size_t take = std::min(avail, n);
  uint64_t t = r->tail.load(std::memory_order_relaxed);
  *ptr = r->base + (t % r->size);
  return take;
}

void rr_ring_consume(RrRing* r, size_t n) {
  r->tail.fetch_add(n, std::memory_order_release);
}

// Consumer: blocking read of exactly n bytes (or fewer at EOF).
size_t rr_ring_read(RrRing* r, void* out, size_t n) {
  uint8_t* dst = (uint8_t*)out;
  size_t done = 0;
  while (done < n) {
    size_t avail = rr_ring_readable(r);
    if (avail == 0) {
      if (r->eof.load(std::memory_order_acquire)) break;
      std::this_thread::sleep_for(std::chrono::microseconds(50));
      continue;
    }
    size_t take = std::min(avail, n - done);
    uint64_t t = r->tail.load(std::memory_order_relaxed);
    memcpy(dst + done, r->base + (t % r->size), take);
    r->tail.store(t + take, std::memory_order_release);
    done += take;
  }
  return done;
}

// ---------------------------------------------------------------- reader

struct RrReader {
  RrRing* ring;
  std::thread thread;
  std::atomic<int> stop;
  int repeat;
  char path[4096];
};

static void reader_main(RrReader* rd) {
  for (int pass = 0; rd->repeat < 0 || pass < rd->repeat; pass++) {
    FILE* f = fopen(rd->path, "rb");
    if (!f) {
      rd->ring->err.store(errno ? errno : 1, std::memory_order_release);
      break;
    }
    uint8_t buf[1 << 16];
    size_t got;
    while ((got = fread(buf, 1, sizeof(buf), f)) > 0) {
      if (rd->stop.load(std::memory_order_acquire)) {
        fclose(f);
        rr_ring_set_eof(rd->ring);
        return;
      }
      rr_ring_write(rd->ring, buf, got);
    }
    fclose(f);
  }
  rr_ring_set_eof(rd->ring);
}

// Start a background file reader filling the ring. repeat<0 = loop forever.
RrReader* rr_reader_start(RrRing* ring, const char* path, int repeat) {
  auto* rd = new RrReader();
  rd->ring = ring;
  rd->stop.store(0);
  rd->repeat = repeat == 0 ? 1 : repeat;
  snprintf(rd->path, sizeof(rd->path), "%s", path);
  rd->thread = std::thread(reader_main, rd);
  return rd;
}

void rr_reader_stop(RrReader* rd) {
  if (!rd) return;
  rd->stop.store(1, std::memory_order_release);
  if (rd->thread.joinable()) rd->thread.join();
  delete rd;
}

// ---------------------------------------------------------------- convert

// i16 big-endian PCM -> f32 (the .au decode hot loop; reference
// src/au.rs:265-277 divides by 32767).
void rr_convert_i16be_f32(const uint8_t* src, float* dst, size_t n) {
  const float k = 1.0f / 32767.0f;
  for (size_t i = 0; i < n; i++) {
    int16_t v = (int16_t)((src[2 * i] << 8) | src[2 * i + 1]);
    dst[i] = (float)v * k;
  }
}

// i16 little-endian -> f32.
void rr_convert_i16le_f32(const uint8_t* src, float* dst, size_t n) {
  const float k = 1.0f / 32767.0f;
  for (size_t i = 0; i < n; i++) {
    int16_t v;
    memcpy(&v, src + 2 * i, 2);
    dst[i] = (float)v * k;
  }
}

// RTL-SDR u8 offset-127 interleaved IQ -> planar f32 I and Q
// (reference src/rtlsdr_decode.rs: (x-127)*0.008), planar because the
// device chains take separate f32 I/Q streams.
void rr_convert_u8iq_f32_planar(const uint8_t* src, float* dst_i, float* dst_q,
                                size_t n_samples, float scale) {
  for (size_t i = 0; i < n_samples; i++) {
    dst_i[i] = ((float)src[2 * i] - 127.0f) * scale;
    dst_q[i] = ((float)src[2 * i + 1] - 127.0f) * scale;
  }
}

// Interleaved complex64 -> planar f32 I/Q (for host arrays bound for the device).
void rr_deinterleave_c64(const float* src, float* dst_i, float* dst_q,
                         size_t n_samples) {
  for (size_t i = 0; i < n_samples; i++) {
    dst_i[i] = src[2 * i];
    dst_q[i] = src[2 * i + 1];
  }
}

// Planar f32 I/Q -> interleaved complex64.
void rr_interleave_c64(const float* src_i, const float* src_q, float* dst,
                       size_t n_samples) {
  for (size_t i = 0; i < n_samples; i++) {
    dst[2 * i] = src_i[i];
    dst[2 * i + 1] = src_q[i];
  }
}

// f32 -> i16 big-endian PCM with truncation toward zero (reference
// src/au.rs:147-149 casts (f*32767) as i16).
void rr_convert_f32_i16be(const float* src, uint8_t* dst, size_t n) {
  for (size_t i = 0; i < n; i++) {
    float v = src[i] * 32767.0f;
    if (v > 32767.0f) v = 32767.0f;
    if (v < -32768.0f) v = -32768.0f;
    int16_t s = (int16_t)v;  // trunc toward zero
    dst[2 * i] = (uint8_t)((uint16_t)s >> 8);
    dst[2 * i + 1] = (uint8_t)((uint16_t)s & 0xff);
  }
}

}  // extern "C"

extern "C" {

// Symbol synchronization: zero-crossing TED + clamped IIR clock filter.
// An exact f32 replication of the lax.scan in ops/symbol_sync.py (itself a
// port of reference src/symbol_sync.rs:115-218) — the sequential low-rate
// tail of a receive chain runs here at native speed while the dense
// front-end stays on the accelerator.  Compile with -ffp-contract=off so
// mul+add do not fuse into FMA (the scan rounds each op separately).
// Returns the number of emitted symbols; out_vals/out_clocks must have
// room for n floats.
// state layout (in/out): [clock, last_sign, stream_pos, last_boundary,
// next_mid, fbuf[0..max(order,1))] — pass NULL for a fresh stream.
size_t rr_symbol_sync(const float* x, size_t n, float sps, float max_dev,
                      const float* taps, size_t ntaps,
                      float* state,
                      float* out_vals, float* out_clocks) {
  const float mi = sps - max_dev;
  const float mx = sps + max_dev;
  const int order = (int)ntaps - 1;
  const int nf = order > 0 ? order : 1;
  float clock = sps;
  float stream_pos = 0.0f;
  float last_b = 0.0f;
  float next_mid = sps / 2.0f;
  bool last_sign = false;
  std::vector<float> fbuf((size_t)nf, sps);
  if (state != nullptr) {
    clock = state[0];
    last_sign = state[1] != 0.0f;
    stream_pos = state[2];
    last_b = state[3];
    next_mid = state[4];
    for (int j = 0; j < nf; j++) fbuf[(size_t)j] = state[5 + j];
  }
  size_t k = 0;
  for (size_t i = 0; i < n; i++) {
    const float sample = x[i];
    if (stream_pos >= next_mid) {
      out_vals[k] = sample;
      out_clocks[k] = clock;
      k++;
      next_mid = next_mid + clock;
    }
    const bool sign = sample > 0.0f;
    const bool changed = sign != last_sign;
    if (changed && stream_pos > 0.0f && last_b > 0.0f) {
      float t = stream_pos - last_b;
      while (t > mx) {
        const float t2 = t - clock;
        if (std::fabs(t - clock) < std::fabs(t2 - clock)) break;
        t = t2;
      }
      if (t > mi * 0.8f && t < mx * 1.2f) {
        float ret = taps[0] * (t - sps);
        for (int j = 0; j < order; j++) ret = ret + taps[j + 1] * fbuf[j];
        const float lo = mi - sps, hi = mx - sps;
        if (ret < lo) ret = lo;
        if (ret > hi) ret = hi;
        if (order > 0) {
          for (int j = order - 1; j > 0; j--) fbuf[j] = fbuf[j - 1];
          fbuf[0] = ret;
        }
        clock = ret + sps;
        float nm = last_b + clock / 2.0f;
        while (nm < stream_pos) nm = nm + clock;
        next_mid = nm;
      }
    }
    if (changed) {
      last_b = stream_pos;
      last_sign = sign;
    }
    stream_pos = stream_pos + 1.0f;
    const float sb = 10.0f * clock;
    if (stream_pos > sb && last_b > sb && next_mid > sb) {
      stream_pos = stream_pos - sb;
      last_b = last_b - sb;
      next_mid = next_mid - sb;
    }
  }
  if (state != nullptr) {
    state[0] = clock;
    state[1] = last_sign ? 1.0f : 0.0f;
    state[2] = stream_pos;
    state[3] = last_b;
    state[4] = next_mid;
    for (int j = 0; j < nf; j++) state[5 + j] = fbuf[(size_t)j];
  }
  return k;
}

}  // extern "C"

extern "C" {

// HDLC deframer: flag hunt, bit-unstuffing, LSB-first byte pack,
// CRC-16/X.25 with optional single-bitflip repair.  Exact port of
// ops/hdlc.py HdlcStateMachine (itself a port of reference
// src/hdlc_deframer.rs:123-231) — the per-bit tail of a receive chain.
struct RrHdlc {
  int min_size, max_size, keep_checksum, fix_bits;
  int state;  // 0 unsynced, 1 synced, 2 final
  uint8_t shift;
  int ones;
  std::vector<uint8_t> cur;  // bits
  uint64_t stream_pos;
  uint64_t decoded, crc_error, bitfixed;
  // pending output packets
  std::vector<uint8_t> out_data;
  std::vector<uint32_t> out_lens;
  std::vector<uint64_t> out_pos;
  uint16_t crc_table[256];
};

static uint16_t rr_crc16(const RrHdlc* h, const uint8_t* d, size_t n) {
  uint16_t fcs = 0xFFFF;
  for (size_t i = 0; i < n; i++)
    fcs = (uint16_t)(fcs >> 8) ^ h->crc_table[(fcs ^ d[i]) & 0xFF];
  return (uint16_t)(fcs ^ 0xFFFF);
}

RrHdlc* rr_hdlc_create(int min_size, int max_size, int keep_checksum,
                       int fix_bits) {
  auto* h = new RrHdlc();
  h->min_size = min_size;
  h->max_size = max_size;
  h->keep_checksum = keep_checksum;
  h->fix_bits = fix_bits;
  h->state = 0;
  h->shift = 0xFF;
  h->ones = 0;
  h->stream_pos = 0;
  h->decoded = h->crc_error = h->bitfixed = 0;
  for (int b = 0; b < 256; b++) {
    uint16_t v = (uint16_t)b;
    for (int i = 0; i < 8; i++) v = (v & 1) ? (uint16_t)((v >> 1) ^ 0x8408) : (uint16_t)(v >> 1);
    h->crc_table[b] = v;
  }
  return h;
}

void rr_hdlc_destroy(RrHdlc* h) { delete h; }

static void rr_hdlc_finish(RrHdlc* h, uint64_t pos) {
  if (h->cur.size() < 7) return;
  size_t nbits = h->cur.size() - 7;  // strip partial closing flag
  if (nbits % 8 != 0 || nbits / 8 < (size_t)h->min_size) return;
  size_t nb = nbits / 8;
  std::vector<uint8_t> by(nb);
  for (size_t i = 0; i < nb; i++) {
    uint8_t v = 0;
    for (int j = 0; j < 8; j++) v |= (uint8_t)(h->cur[8 * i + j] << j);
    by[i] = v;
  }
  if (h->keep_checksum) {
    h->decoded++;
    h->out_data.insert(h->out_data.end(), by.begin(), by.end());
    h->out_lens.push_back((uint32_t)nb);
    h->out_pos.push_back(pos);
    return;
  }
  if (nb < 2) return;
  size_t nd = nb - 2;
  uint16_t got = (uint16_t)(by[nd] | (by[nd + 1] << 8));
  uint16_t crc = rr_crc16(h, by.data(), nd);
  bool fixed = false;
  if (crc != got && h->fix_bits) {
    bool repaired = false;
    for (size_t bit = 0; bit < nd * 8 && !repaired; bit++) {
      by[bit / 8] ^= (uint8_t)(1u << (bit % 8));
      if (rr_crc16(h, by.data(), nd) == got) {
        repaired = true;
        fixed = true;
        crc = got;
      } else {
        by[bit / 8] ^= (uint8_t)(1u << (bit % 8));
      }
    }
    if (!repaired) {
      for (int cb = 0; cb < 16; cb++) {
        if ((uint16_t)(got ^ (1u << cb)) == crc) { fixed = true; break; }
      }
    }
  }
  if (fixed) h->bitfixed++;
  if (crc != got) {
    h->crc_error++;
    return;
  }
  h->decoded++;
  h->out_data.insert(h->out_data.end(), by.begin(), by.begin() + nd);
  h->out_lens.push_back((uint32_t)nd);
  h->out_pos.push_back(pos);
}

size_t rr_hdlc_feed(RrHdlc* h, const uint8_t* bits, size_t n) {
  for (size_t i = 0; i < n; i++) {
    const int bit = bits[i] & 1;
    const uint64_t pos = h->stream_pos++;
    if (h->state == 0) {
      h->shift = (uint8_t)(((h->shift >> 1) | (bit << 7)) & 0xFF);
      if (h->shift == 0x7E) {
        h->state = 1;
        h->ones = 0;
        h->cur.clear();
      }
    } else if (h->state == 1) {
      if (h->cur.size() > (size_t)h->max_size * 8) {
        h->state = 0;
        h->shift = 0xFF;
        continue;
      }
      if (bit) {
        h->cur.push_back(1);
        if (h->ones == 5) h->state = 2;
        else h->ones++;
      } else if (h->ones == 5) {
        h->ones = 0;  // stuffed bit, drop
      } else {
        h->cur.push_back(0);
        h->ones = 0;
      }
    } else {  // final: 6 ones seen, this bit must be 0
      if (bit == 1 || h->cur.size() < 7) {
        h->state = 0;
        h->shift = 0xFF;
        continue;
      }
      rr_hdlc_finish(h, pos);
      h->state = 1;
      h->ones = 0;
      h->cur.clear();
    }
  }
  return h->out_lens.size();
}

size_t rr_hdlc_pending_bytes(RrHdlc* h) { return h->out_data.size(); }

size_t rr_hdlc_drain(RrHdlc* h, uint8_t* data, uint32_t* lens, uint64_t* poss,
                     size_t maxp) {
  size_t k = h->out_lens.size() < maxp ? h->out_lens.size() : maxp;
  if (k != h->out_lens.size()) return (size_t)-1;  // caller sized wrong
  if (k) {
    std::memcpy(data, h->out_data.data(), h->out_data.size());
    std::memcpy(lens, h->out_lens.data(), k * sizeof(uint32_t));
    std::memcpy(poss, h->out_pos.data(), k * sizeof(uint64_t));
  }
  h->out_data.clear();
  h->out_lens.clear();
  h->out_pos.clear();
  return k;
}

void rr_hdlc_stats(RrHdlc* h, uint64_t out[3]) {
  out[0] = h->decoded;
  out[1] = h->crc_error;
  out[2] = h->bitfixed;
}

}  // extern "C"

extern "C" {

// Fixed-clock zero-crossing recovery: exact u32/f32 replication of the
// lax.scan in ops/symbol_sync.py::zero_crossing_sync (reference
// src/zero_crossing.rs:26-150).  state: [last_sign, last_cross, counter]
// as floats (counter is an exact small integer); NULL for a fresh stream.
size_t rr_zero_crossing(const float* x, size_t n, float sps,
                        float* state, float* out_vals) {
  bool last_sign = false;
  float last_cross = 0.0f;
  uint32_t counter = 0;
  if (state != nullptr) {
    last_sign = state[0] != 0.0f;
    last_cross = state[1];
    counter = (uint32_t)state[2];
  }
  const uint32_t step_back = (uint32_t)(10.0f * sps);
  size_t k = 0;
  for (size_t i = 0; i < n; i++) {
    const float sample = x[i];
    if (counter == (uint32_t)(last_cross + sps / 2.0f)) {
      out_vals[k++] = sample;
      last_cross = last_cross + sps;
    }
    const bool sign = sample > 0.0f;
    if (sign != last_sign) last_cross = (float)counter;
    counter = counter + 1;
    if (counter > step_back && (uint32_t)last_cross > step_back) {
      counter -= step_back;
      last_cross = last_cross - (float)step_back;
    }
    last_sign = sign;
  }
  if (state != nullptr) {
    state[0] = last_sign ? 1.0f : 0.0f;
    state[1] = last_cross;
    state[2] = (float)counter;
  }
  return k;
}

}  // extern "C"
