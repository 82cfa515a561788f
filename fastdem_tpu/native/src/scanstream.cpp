// Threaded scan-stream prefetcher: the native data-loader side of offline
// replay (reference analog: nanoPCL io feeding the node's scan callback,
// /root/reference/fastdem/lib/nanoPCL/include/nanopcl/io/pcd_io.hpp +
// ros2/src/fastdem_ros_node.cpp:178).
//
// A pool of worker threads parses .pcd / .bin files (via the pcdio.cpp
// loaders compiled into the same shared object) ahead of the consumer and
// hands back scans IN FILE ORDER, already padded to a fixed capacity
// (mask=0, xyz=1e9 sentinel beyond n — the PointCloud padding convention).
// Bounded lookahead keeps memory flat; the Python binding drains the ring
// while the device integrates the previous batch, overlapping host parse
// time with device compute.
//
// Plain-C ABI, ctypes-bound (fastdem_tpu/native/__init__.py).

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

// MUST match pcdio.cpp's CloudBuffers layout exactly (shared C ABI).
struct CloudBuffers {
  float* xyz;
  float* intensity;
  uint8_t* rgb;
  float* time;
  int32_t* ring;
  float* normal;
  int64_t n;
  int32_t error;
  float viewpoint[7];
};

extern "C" {
void fastdem_load_pcd(const char* path, CloudBuffers* out);
void fastdem_load_kitti(const char* path, CloudBuffers* out);
void fastdem_free_cloud(CloudBuffers* c);
}

namespace {

struct Stream {
  std::vector<std::string> paths;
  int64_t capacity = 0;
  size_t ring = 8;

  std::mutex mu;
  std::condition_variable cv_worker;   // producers wait for ring space
  std::condition_variable cv_consumer; // consumer waits for next_seq
  std::map<int64_t, CloudBuffers> done;
  int64_t next_to_claim = 0;  // next file index a worker takes
  int64_t next_to_emit = 0;   // next file index the consumer needs
  bool closing = false;
  std::vector<std::thread> workers;

  ~Stream() { shutdown(); }

  void shutdown() {
    {
      std::lock_guard<std::mutex> lk(mu);
      if (closing) return;
      closing = true;
    }
    cv_worker.notify_all();
    cv_consumer.notify_all();
    for (auto& t : workers) {
      if (t.joinable()) t.join();
    }
    for (auto& kv : done) fastdem_free_cloud(&kv.second);
    done.clear();
  }

  void work() {
    for (;;) {
      int64_t seq;
      {
        std::unique_lock<std::mutex> lk(mu);
        // Claim in order, but throttle: do not run more than `ring`
        // files ahead of the consumer.
        cv_worker.wait(lk, [&] {
          return closing ||
                 (next_to_claim < (int64_t)paths.size() &&
                  next_to_claim < next_to_emit + (int64_t)ring);
        });
        if (closing || next_to_claim >= (int64_t)paths.size()) return;
        seq = next_to_claim++;
      }
      const std::string& p = paths[seq];
      CloudBuffers c;
      std::memset(&c, 0, sizeof(c));
      bool is_bin = p.size() >= 4 && p.compare(p.size() - 4, 4, ".bin") == 0;
      if (is_bin) {
        fastdem_load_kitti(p.c_str(), &c);
      } else {
        fastdem_load_pcd(p.c_str(), &c);
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        if (closing) {
          fastdem_free_cloud(&c);
          return;
        }
        done.emplace(seq, c);
      }
      cv_consumer.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* fastdem_stream_open(const char** paths, int64_t n_files,
                          int64_t capacity, int32_t threads,
                          int32_t ring_slots) {
  if (n_files <= 0 || capacity <= 0) return nullptr;
  auto* s = new Stream();
  s->paths.reserve(n_files);
  for (int64_t i = 0; i < n_files; ++i) s->paths.emplace_back(paths[i]);
  s->capacity = capacity;
  s->ring = ring_slots > 0 ? (size_t)ring_slots : 8;
  int32_t nt = threads > 0 ? threads : 2;
  if ((int64_t)nt > n_files) nt = (int32_t)n_files;
  for (int32_t i = 0; i < nt; ++i) {
    s->workers.emplace_back([s] { s->work(); });
  }
  return s;
}

// Copies the next scan (in file order) into caller-owned buffers of
// length `capacity`: xyz f32[cap*3] (padded 1e9), mask u8[cap],
// intensity f32[cap] (0 where absent). Returns the number of valid
// points (clamped to capacity), -1 at end of stream, or -2 if the file
// failed to parse (buffers are left fully padded: an empty scan —
// consumers drop it, matching the reference's warn-and-skip).
int64_t fastdem_stream_next(void* handle, float* xyz, uint8_t* mask,
                            float* intensity) {
  auto* s = static_cast<Stream*>(handle);
  if (!s) return -1;
  CloudBuffers c;
  {
    std::unique_lock<std::mutex> lk(s->mu);
    if (s->next_to_emit >= (int64_t)s->paths.size()) return -1;
    int64_t seq = s->next_to_emit;
    s->cv_consumer.wait(lk, [&] {
      return s->closing || s->done.count(seq) > 0;
    });
    if (s->closing) return -1;
    c = s->done[seq];
    s->done.erase(seq);
    s->next_to_emit = seq + 1;
  }
  s->cv_worker.notify_all();

  const int64_t cap = s->capacity;
  // Pad first (sentinel far away from any map), then overwrite the prefix.
  for (int64_t i = 0; i < cap * 3; ++i) xyz[i] = 1e9f;
  std::memset(mask, 0, (size_t)cap);
  if (intensity) std::memset(intensity, 0, (size_t)cap * sizeof(float));

  if (c.error != 0 || c.n <= 0 || c.xyz == nullptr) {
    int64_t rc = c.error != 0 ? -2 : 0;
    fastdem_free_cloud(&c);
    return rc;
  }
  int64_t n = c.n < cap ? c.n : cap;
  std::memcpy(xyz, c.xyz, (size_t)n * 3 * sizeof(float));
  std::memset(mask, 1, (size_t)n);
  // Non-finite points get mask=0 + sentinel, like pointcloud.from_numpy.
  for (int64_t i = 0; i < n; ++i) {
    float x = xyz[i * 3], y = xyz[i * 3 + 1], z = xyz[i * 3 + 2];
    if (!(x == x && y == y && z == z) ||
        !(x - x == 0.0f && y - y == 0.0f && z - z == 0.0f)) {
      mask[i] = 0;
      xyz[i * 3] = xyz[i * 3 + 1] = xyz[i * 3 + 2] = 1e9f;
    }
  }
  if (intensity && c.intensity) {
    std::memcpy(intensity, c.intensity, (size_t)n * sizeof(float));
  }
  fastdem_free_cloud(&c);
  return n;
}

void fastdem_stream_close(void* handle) {
  auto* s = static_cast<Stream*>(handle);
  if (!s) return;
  s->shutdown();
  delete s;
}

}  // extern "C"
