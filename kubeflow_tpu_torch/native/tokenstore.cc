// Token-store: memory-mapped token-corpus reader for the input pipeline.
//
// The hot half of the data loader, in C++ (the role the reference gives its
// native components; its data path is S3 sidecar downloads,
// components/openmpi-controller/controller/controller.py:105-116 — here the
// corpus is one mmapped binary file and batch assembly is memcpy-speed,
// zero Python per row). Exposed to Python over a C ABI via ctypes
// (kubeflow_tpu/train/tokenstore.py), with a pure-numpy fallback that
// implements the identical sampling arithmetic, so the two paths are
// interchangeable and cross-checked in tests.
//
// File format (little-endian):
//   magic  u32  = 0x4b545055 ("KTPU")
//   version u32 = 1
//   dtype  u32  = 4  (int32 tokens)
//   pad    u32
//   n_tokens u64
//   tokens  int32[n_tokens]
//
// Sampling: row r of (batch, seq+1) at step s starts at
//   splitmix64(seed ^ (s*batch + r)) % (n_tokens - seq - 1)
// — stateless, deterministic, seekable from any step (resume-friendly).
// Sequential mode reads contiguous windows strided across processes for
// epoch-style coverage.

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0x4b545055u;

struct Store {
  int fd = -1;
  const uint8_t* map = nullptr;
  size_t map_len = 0;
  const int32_t* tokens = nullptr;
  uint64_t n_tokens = 0;
};

uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ull;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
  return x ^ (x >> 31);
}

}  // namespace

extern "C" {

// Returns an opaque handle (heap pointer) or null on failure.
void* ts_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || static_cast<size_t>(st.st_size) < 24) {
    ::close(fd);
    return nullptr;
  }
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (map == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  const uint8_t* bytes = static_cast<const uint8_t*>(map);
  uint32_t magic, version, dtype;
  uint64_t n_tokens;
  std::memcpy(&magic, bytes, 4);
  std::memcpy(&version, bytes + 4, 4);
  std::memcpy(&dtype, bytes + 8, 4);
  std::memcpy(&n_tokens, bytes + 16, 8);
  // Divide, don't multiply: `24 + n_tokens * 4` wraps for crafted headers
  // (n_tokens >= 2^62) and would admit a file whose reads run off the map.
  if (magic != kMagic || version != 1 || dtype != 4 ||
      n_tokens > (static_cast<uint64_t>(st.st_size) - 24) / 4) {
    munmap(map, st.st_size);
    ::close(fd);
    return nullptr;
  }
  Store* s = new Store;
  s->fd = fd;
  s->map = bytes;
  s->map_len = st.st_size;
  s->tokens = reinterpret_cast<const int32_t*>(bytes + 24);
  s->n_tokens = n_tokens;
  return s;
}

uint64_t ts_n_tokens(void* handle) {
  return handle ? static_cast<Store*>(handle)->n_tokens : 0;
}

void ts_close(void* handle) {
  if (!handle) return;
  Store* s = static_cast<Store*>(handle);
  munmap(const_cast<uint8_t*>(s->map), s->map_len);
  ::close(s->fd);
  delete s;
}

// Fill out[batch][width] with shuffled windows for (seed, step).
// Returns 0 on success, -1 if the corpus is shorter than width.
int ts_fill_shuffled(void* handle, int32_t* out, uint64_t batch,
                     uint64_t width, uint64_t seed, uint64_t step) {
  Store* s = static_cast<Store*>(handle);
  if (!s || s->n_tokens < width) return -1;
  const uint64_t span = s->n_tokens - width + 1;
  for (uint64_t r = 0; r < batch; ++r) {
    const uint64_t off = splitmix64(seed ^ (step * batch + r)) % span;
    std::memcpy(out + r * width, s->tokens + off, width * 4);
  }
  return 0;
}

// Fill out[batch][width] with contiguous windows for epoch-style reads:
// window w = global_row (wrapping), rows strided by num_shards so shard
// p reads rows p, p+num_shards, ... Returns 0, or -1 on bad args.
int ts_fill_sequential(void* handle, int32_t* out, uint64_t batch,
                       uint64_t width, uint64_t start_row, uint64_t shard,
                       uint64_t num_shards) {
  Store* s = static_cast<Store*>(handle);
  if (!s || s->n_tokens < width || num_shards == 0) return -1;
  const uint64_t n_windows = s->n_tokens / width;
  if (n_windows == 0) return -1;
  for (uint64_t r = 0; r < batch; ++r) {
    const uint64_t row = (start_row + r) * num_shards + shard;
    const uint64_t off = (row % n_windows) * width;
    std::memcpy(out + r * width, s->tokens + off, width * 4);
  }
  return 0;
}

}  // extern "C"
