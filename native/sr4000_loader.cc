// SR4000 .dat frame decoder + threaded batch loader.
//
// Native replacement for the reference's MATLAB data layer
// (read_xyz_sr4000.m:1-60, read_image_sr4000.m:1-29, takeImage.m): each
// frame file is an ASCII matrix of 721 rows x 176 cols stacked as
// z / x / y / intensity / confidence blocks of 144 rows each plus a
// timestamp row (milliseconds). The decoder applies the same processing
// the MATLAB layer does on load: >65000 intensity clamp, max-normalize,
// 3x3 binomial smoothing, and the SR4000->camera axis flip [-x,-y,z]
// (inittialize_depth_my_version.m:85).
//
// The batch API decodes many frames with a std::thread pool so host IO
// overlaps device compute (the reference used per-frame .mat disk caches
// instead). Exposed as a plain C ABI for ctypes (no pybind11 in the
// toolchain).
//
// Build: make -C native   (produces native/build/libsr4000.so)

#include <atomic>
#include <cctype>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int H = 144;
constexpr int W = 176;
constexpr int ROWS = 721;  // 5 * 144 + timestamp row
constexpr int VALUES = ROWS * W;

// Fast whitespace-delimited float parsing of an entire buffer.
// Returns number of values parsed (<= max_vals).
int parse_floats(const char* buf, size_t len, float* out, int max_vals) {
  const char* p = buf;
  const char* end = buf + len;
  int n = 0;
  while (p < end && n < max_vals) {
    while (p < end && (std::isspace((unsigned char)*p))) ++p;
    if (p >= end) break;
    char* next = nullptr;
    float v = std::strtof(p, &next);
    if (next == p) {  // unparsable token; skip it
      while (p < end && !std::isspace((unsigned char)*p)) ++p;
      continue;
    }
    out[n++] = v;
    p = next;
  }
  return n;
}

void smooth3x3(const float* in, float* out) {
  // separable binomial [0.25 0.5 0.25], edge-clamped
  std::vector<float> tmp(H * W);
  for (int r = 0; r < H; ++r) {
    for (int c = 0; c < W; ++c) {
      int rm = r > 0 ? r - 1 : 0;
      int rp = r < H - 1 ? r + 1 : H - 1;
      tmp[r * W + c] =
          0.25f * in[rm * W + c] + 0.5f * in[r * W + c] + 0.25f * in[rp * W + c];
    }
  }
  for (int r = 0; r < H; ++r) {
    for (int c = 0; c < W; ++c) {
      int cm = c > 0 ? c - 1 : 0;
      int cp = c < W - 1 ? c + 1 : W - 1;
      out[r * W + c] = 0.25f * tmp[r * W + cm] + 0.5f * tmp[r * W + c] +
                       0.25f * tmp[r * W + cp];
    }
  }
}

int decode_values(const float* vals, float* intensity, float* xyz,
                  float* confidence, double* timestamp, int smooth) {
  const float* z = vals;
  const float* x = vals + H * W;
  const float* y = vals + 2 * H * W;
  const float* inten = vals + 3 * H * W;
  const float* conf = vals + 4 * H * W;

  // intensity: clamp >65000 artifacts, normalize to [0,1]
  std::vector<float> raw(H * W);
  float mx = 0.f;
  for (int i = 0; i < H * W; ++i) {
    float v = inten[i] > 65000.f ? 0.f : inten[i];
    raw[i] = v;
    if (v > mx) mx = v;
  }
  if (mx > 0) {
    for (int i = 0; i < H * W; ++i) raw[i] /= mx;
  }
  if (smooth) {
    smooth3x3(raw.data(), intensity);
  } else {
    std::memcpy(intensity, raw.data(), sizeof(float) * H * W);
  }

  // xyz with the SR4000->camera flip [-x, -y, z]
  for (int i = 0; i < H * W; ++i) {
    xyz[3 * i + 0] = -x[i];
    xyz[3 * i + 1] = -y[i];
    xyz[3 * i + 2] = z[i];
  }
  std::memcpy(confidence, conf, sizeof(float) * H * W);
  *timestamp = vals[720 * W] / 1000.0;  // ms -> s
  return 0;
}

int decode_file(const char* path, float* intensity, float* xyz,
                float* confidence, double* timestamp, int smooth) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long len = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> buf(len + 1);
  size_t rd = std::fread(buf.data(), 1, len, f);
  std::fclose(f);
  buf[rd] = '\0';
  std::vector<float> vals(VALUES, 0.f);
  int n = parse_floats(buf.data(), rd, vals.data(), VALUES);
  if (n < 5 * H * W) return -2;  // truncated frame
  return decode_values(vals.data(), intensity, xyz, confidence, timestamp,
                       smooth);
}

}  // namespace

extern "C" {

// Decode one frame. Buffers: intensity [144*176], xyz [144*176*3],
// confidence [144*176]. Returns 0 on success, negative error code else.
int sr4000_decode(const char* path, float* intensity, float* xyz,
                  float* confidence, double* timestamp, int smooth) {
  return decode_file(path, intensity, xyz, confidence, timestamp, smooth);
}

// Decode n frames in parallel with `threads` worker threads.
// paths: array of n C strings; outputs are contiguous per-frame blocks.
// status[i] receives the per-frame return code. Returns the number of
// successfully decoded frames.
int sr4000_decode_batch(const char** paths, int n, float* intensity,
                        float* xyz, float* confidence, double* timestamps,
                        int* status, int smooth, int threads) {
  if (threads <= 0) threads = (int)std::thread::hardware_concurrency();
  if (threads <= 0) threads = 4;
  std::atomic<int> next(0);
  std::atomic<int> ok_count(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      int rc = decode_file(paths[i], intensity + (size_t)i * H * W,
                           xyz + (size_t)i * H * W * 3,
                           confidence + (size_t)i * H * W, timestamps + i,
                           smooth);
      status[i] = rc;
      if (rc == 0) ok_count.fetch_add(1);
    }
  };
  std::vector<std::thread> pool;
  int nt = threads < n ? threads : (n > 0 ? n : 1);
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return ok_count.load();
}

int sr4000_frame_height() { return H; }
int sr4000_frame_width() { return W; }

}  // extern "C"
