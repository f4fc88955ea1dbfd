// Native frame source: a bounded drop-oldest ring fed by a producer thread.
//
// The port's own copy of the JAX package's native/csrc/framesource.cpp: its
// ring, synthetic scene and trace replay unchanged, and of its C API the
// functions native/ring.py binds.  A background producer thread pushes RGB-D
// frames into a bounded ring (camera semantics: the newest frame wins, the
// oldest is dropped at capacity) at a fixed FPS, from the deterministic
// synthetic scene or a recorded trace; the Python runtime pops frames
// (runtime/frame_source.py RingSource).
//
// Trace file format (little-endian): magic "TODTRACE" u64, u32 h, u32 w,
// u32 n_frames, then per frame: h*w*3 u8 rgb + h*w u16 depth.

#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Frame {
  std::vector<uint8_t> rgb;
  std::vector<uint16_t> depth;
};

struct Ring {
  int capacity, h, w;
  std::deque<Frame> q;
  std::mutex mu;
  std::condition_variable cv;
  std::atomic<bool> running{false};
  std::atomic<uint64_t> pushed{0}, dropped{0};
  std::thread producer;
  // producer config
  double fps = 30.0;
  uint64_t seed = 0;
  std::string trace_path;
};

// Deterministic synthetic FRC scene: gradient floor, moving balls (class-3
// analog: bright yellow circles), and two robot boxes (red / blue), with a
// consistent depth field; runtime/frame_source.py synth_frame_numpy is the
// same scene in numpy.
void synth_frame_impl(uint64_t seed, int64_t t, int h, int w, uint8_t* rgb,
                      uint16_t* depth) {
  auto clampi = [](int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); };
  // background: floor gradient, depth ramp far→near
  for (int y = 0; y < h; ++y) {
    const uint16_t d = static_cast<uint16_t>(3800 - (3000 * y) / (h > 1 ? h - 1 : 1));
    const uint8_t g = static_cast<uint8_t>(60 + (80 * y) / (h > 1 ? h - 1 : 1));
    for (int x = 0; x < w; ++x) {
      const int64_t i = static_cast<int64_t>(y) * w + x;
      rgb[3 * i] = g / 2;
      rgb[3 * i + 1] = g;
      rgb[3 * i + 2] = g / 3;
      depth[i] = d;
    }
  }
  auto draw_disc = [&](int cy, int cx, int r, uint8_t cr, uint8_t cg, uint8_t cb,
                       uint16_t dmm) {
    for (int y = clampi(cy - r, 0, h - 1); y <= clampi(cy + r, 0, h - 1); ++y)
      for (int x = clampi(cx - r, 0, w - 1); x <= clampi(cx + r, 0, w - 1); ++x)
        if ((y - cy) * (y - cy) + (x - cx) * (x - cx) <= r * r) {
          const int64_t i = static_cast<int64_t>(y) * w + x;
          rgb[3 * i] = cr;
          rgb[3 * i + 1] = cg;
          rgb[3 * i + 2] = cb;
          depth[i] = dmm;
        }
  };
  auto draw_box = [&](int cy, int cx, int hh, int hw2, uint8_t cr, uint8_t cg,
                      uint8_t cb, uint16_t dmm) {
    for (int y = clampi(cy - hh, 0, h - 1); y <= clampi(cy + hh, 0, h - 1); ++y)
      for (int x = clampi(cx - hw2, 0, w - 1); x <= clampi(cx + hw2, 0, w - 1); ++x) {
        const int64_t i = static_cast<int64_t>(y) * w + x;
        rgb[3 * i] = cr;
        rgb[3 * i + 1] = cg;
        rgb[3 * i + 2] = cb;
        depth[i] = dmm;
      }
  };
  // two balls orbiting + two robots strafing, phase from seed
  const double ph = static_cast<double>(seed % 997) * 0.37;
  const double a = 0.035 * static_cast<double>(t) + ph;
  draw_disc(static_cast<int>(h * 0.62 + 0.12 * h * std::sin(a)),
            static_cast<int>(w * 0.40 + 0.25 * w * std::cos(a * 0.7)),
            h / 16, 240, 220, 40, 1400);
  draw_disc(static_cast<int>(h * 0.70 + 0.10 * h * std::cos(a * 1.3)),
            static_cast<int>(w * 0.65 + 0.20 * w * std::sin(a)),
            h / 18, 240, 220, 40, 1900);
  draw_box(static_cast<int>(h * 0.45),
           static_cast<int>(w * 0.20 + 0.10 * w * std::sin(a * 0.5)), h / 10,
           w / 12, 220, 40, 40, 2600);
  draw_box(static_cast<int>(h * 0.40),
           static_cast<int>(w * 0.80 + 0.08 * w * std::cos(a * 0.4)), h / 10,
           w / 12, 40, 60, 220, 3100);
}

void producer_loop(Ring* r) {
  FILE* f = nullptr;
  uint32_t n_trace = 0;
  int64_t frame_bytes = 0;
  if (!r->trace_path.empty()) {
    f = std::fopen(r->trace_path.c_str(), "rb");
    if (f) {
      char magic[8];
      uint32_t th = 0, tw = 0;
      if (std::fread(magic, 1, 8, f) != 8 || std::memcmp(magic, "TODTRACE", 8) ||
          std::fread(&th, 4, 1, f) != 1 || std::fread(&tw, 4, 1, f) != 1 ||
          std::fread(&n_trace, 4, 1, f) != 1 ||
          th != static_cast<uint32_t>(r->h) || tw != static_cast<uint32_t>(r->w)) {
        std::fclose(f);
        f = nullptr;
      }
      frame_bytes = static_cast<int64_t>(r->h) * r->w * 5;  // 3 u8 + 1 u16
    }
  }
  const auto period =
      std::chrono::duration<double>(r->fps > 0 ? 1.0 / r->fps : 0.0);
  auto next = std::chrono::steady_clock::now();
  int64_t t = 0;
  while (r->running.load(std::memory_order_relaxed)) {
    Frame fr;
    fr.rgb.resize(static_cast<size_t>(r->h) * r->w * 3);
    fr.depth.resize(static_cast<size_t>(r->h) * r->w);
    if (f && n_trace > 0) {
      const uint32_t k = static_cast<uint32_t>(t % n_trace);
      std::fseek(f, 20 + static_cast<int64_t>(k) * frame_bytes, SEEK_SET);
      if (std::fread(fr.rgb.data(), 1, fr.rgb.size(), f) != fr.rgb.size() ||
          std::fread(fr.depth.data(), 2, fr.depth.size(), f) != fr.depth.size()) {
        synth_frame_impl(r->seed, t, r->h, r->w, fr.rgb.data(), fr.depth.data());
      }
    } else {
      synth_frame_impl(r->seed, t, r->h, r->w, fr.rgb.data(), fr.depth.data());
    }
    {
      std::lock_guard<std::mutex> lk(r->mu);
      if (static_cast<int>(r->q.size()) >= r->capacity) {
        r->q.pop_front();  // drop-oldest: a stale camera frame is worthless
        r->dropped.fetch_add(1, std::memory_order_relaxed);
      }
      r->q.push_back(std::move(fr));
      r->pushed.fetch_add(1, std::memory_order_relaxed);
    }
    r->cv.notify_one();
    ++t;
    if (r->fps > 0) {
      next += std::chrono::duration_cast<std::chrono::steady_clock::duration>(period);
      std::this_thread::sleep_until(next);
    }
  }
  if (f) std::fclose(f);
}

}  // namespace

extern "C" {

Ring* tod_ring_create(int capacity, int h, int w) {
  Ring* r = new Ring();
  r->capacity = capacity > 0 ? capacity : 1;
  r->h = h;
  r->w = w;
  return r;
}

void tod_ring_destroy(Ring* r) {
  if (!r) return;
  r->running.store(false);
  r->cv.notify_all();
  if (r->producer.joinable()) r->producer.join();
  delete r;
}

// mode: 0 = synthetic generator; 1 = trace replay from trace_path (loops).
int tod_ring_start_producer(Ring* r, double fps, uint64_t seed,
                            const char* trace_path) {
  if (r->running.load()) return -1;
  r->fps = fps;
  r->seed = seed;
  r->trace_path = trace_path ? trace_path : "";
  r->running.store(true);
  r->producer = std::thread(producer_loop, r);
  return 0;
}

int tod_ring_push(Ring* r, const uint8_t* rgb, const uint16_t* depth) {
  Frame fr;
  fr.rgb.assign(rgb, rgb + static_cast<size_t>(r->h) * r->w * 3);
  fr.depth.assign(depth, depth + static_cast<size_t>(r->h) * r->w);
  int dropped = 0;
  {
    std::lock_guard<std::mutex> lk(r->mu);
    if (static_cast<int>(r->q.size()) >= r->capacity) {
      r->q.pop_front();
      r->dropped.fetch_add(1);
      dropped = 1;
    }
    r->q.push_back(std::move(fr));
    r->pushed.fetch_add(1);
  }
  r->cv.notify_one();
  return dropped;
}

// Blocks up to timeout_ms for a frame. Returns 1 on success, 0 on timeout.
int tod_ring_pop(Ring* r, uint8_t* rgb, uint16_t* depth, int timeout_ms) {
  std::unique_lock<std::mutex> lk(r->mu);
  if (r->q.empty()) {
    r->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                   [r] { return !r->q.empty(); });
    if (r->q.empty()) return 0;
  }
  Frame fr = std::move(r->q.front());
  r->q.pop_front();
  lk.unlock();
  std::memcpy(rgb, fr.rgb.data(), fr.rgb.size());
  std::memcpy(depth, fr.depth.data(), fr.depth.size() * 2);
  return 1;
}

uint64_t tod_ring_stat_pushed(Ring* r) { return r->pushed.load(); }
uint64_t tod_ring_stat_dropped(Ring* r) { return r->dropped.load(); }

}  // extern "C"
