// Packed-record file reader: mmap-backed, zero-copy random access.
//
// The port's own copy of the JAX package's reader
// (flaxdiff_tpu/native/packed_reader.cpp), unchanged but for this comment:
// the data layer's hot read path stays out of the Python interpreter.
// Exposed to Python via ctypes (flaxdiff_tpu_torch/native/__init__.py),
// built with g++ at first use beside png.cpp into one library.
//
// File layout (little-endian):
//   [0:4)   magic "FDTR"
//   [4:8)   u32 version (1 or 2)
//   [8:16)  u64 num_records
//   index   n entries, offsets relative to payload start:
//             v1: (u64 offset, u64 length)                   16 B/entry
//             v2: (u64 offset, u64 length, u32 crc32, u32 0) 24 B/entry
//   [...]   payload bytes
//
// v2 adds per-record CRC32 (zlib polynomial, matching Python's
// binascii.crc32) so corpus shards can be integrity-checked the way
// ArrayRecord checksums its chunks. Batch read and madvise-prefetch
// entry points keep the per-record Python/ctypes crossing off the hot
// path.
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr char kMagic[4] = {'F', 'D', 'T', 'R'};

struct IndexV1 {
  uint64_t offset;
  uint64_t length;
};

struct IndexV2 {
  uint64_t offset;
  uint64_t length;
  uint32_t crc32;
  uint32_t reserved;
};

struct Reader {
  int fd = -1;
  const uint8_t* map = nullptr;
  size_t map_size = 0;
  uint64_t num_records = 0;
  uint32_t version = 1;
  const IndexV1* idx1 = nullptr;
  const IndexV2* idx2 = nullptr;
  const uint8_t* payload = nullptr;
  size_t payload_size = 0;

  uint64_t offset(uint64_t i) const {
    return version == 1 ? idx1[i].offset : idx2[i].offset;
  }
  uint64_t length(uint64_t i) const {
    return version == 1 ? idx1[i].length : idx2[i].length;
  }
};

// CRC32 (reflected, poly 0xEDB88320) — the zlib/binascii.crc32 CRC.
// Magic-static initialization: thread-safe under C++11 (ctypes releases
// the GIL, so concurrent first calls from Python threads are real).
struct CrcTable {
  uint32_t t[256];
  CrcTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[i] = c;
    }
  }
};

const uint32_t* crc_table() {
  static const CrcTable table;
  return table.t;
}

uint32_t crc32(const uint8_t* data, size_t len) {
  const uint32_t* table = crc_table();
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < len; ++i)
    c = table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

}  // namespace

extern "C" {

// Returns an opaque handle or nullptr on failure.
void* pr_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (::fstat(fd, &st) != 0 || st.st_size < 16) {
    ::close(fd);
    return nullptr;
  }
  void* map = ::mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (map == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  const uint8_t* base = static_cast<const uint8_t*>(map);
  uint32_t version = 0;
  uint64_t n = 0;
  bool ok = std::memcmp(base, kMagic, 4) == 0;
  if (ok) {
    std::memcpy(&version, base + 4, 4);
    std::memcpy(&n, base + 8, 8);
    ok = version == 1 || version == 2;
  }
  const size_t entry = version == 1 ? sizeof(IndexV1) : sizeof(IndexV2);
  // Reject impossible record counts BEFORE the multiply: a corrupt u64 n
  // could overflow entry*n to a small header that passes the size check
  // and then walks the validation loop off the mapping.
  if (ok && n > (static_cast<uint64_t>(st.st_size) - 16) / entry) ok = false;
  const size_t header = 16 + entry * static_cast<size_t>(n);
  if (!ok || static_cast<size_t>(st.st_size) < header) {
    ::munmap(map, st.st_size);
    ::close(fd);
    return nullptr;
  }
  Reader* r = new Reader;
  r->fd = fd;
  r->map = base;
  r->map_size = st.st_size;
  r->num_records = n;
  r->version = version;
  if (version == 1)
    r->idx1 = reinterpret_cast<const IndexV1*>(base + 16);
  else
    r->idx2 = reinterpret_cast<const IndexV2*>(base + 16);
  r->payload = base + header;
  r->payload_size = st.st_size - header;
  // Validate the index once at open so per-record reads skip bounds work.
  for (uint64_t i = 0; i < n; ++i) {
    const uint64_t off = r->offset(i), len = r->length(i);
    if (off > r->payload_size || len > r->payload_size - off) {
      delete r;
      ::munmap(map, st.st_size);
      ::close(fd);
      return nullptr;
    }
  }
  return r;
}

uint64_t pr_num_records(void* handle) {
  return handle ? static_cast<Reader*>(handle)->num_records : 0;
}

uint32_t pr_version(void* handle) {
  return handle ? static_cast<Reader*>(handle)->version : 0;
}

uint64_t pr_record_length(void* handle, uint64_t idx) {
  Reader* r = static_cast<Reader*>(handle);
  if (!r || idx >= r->num_records) return 0;
  return r->length(idx);
}

// Zero-copy pointer into the mapping (valid until pr_close).
const void* pr_record_ptr(void* handle, uint64_t idx) {
  Reader* r = static_cast<Reader*>(handle);
  if (!r || idx >= r->num_records) return nullptr;
  return r->payload + r->offset(idx);
}

// Copying read for callers that want an owned buffer. Returns bytes
// written, or 0 on error / insufficient buffer.
uint64_t pr_read_record(void* handle, uint64_t idx, void* buf,
                        uint64_t buf_len) {
  Reader* r = static_cast<Reader*>(handle);
  if (!r || idx >= r->num_records) return 0;
  const uint64_t len = r->length(idx);
  if (buf_len < len) return 0;
  std::memcpy(buf, r->payload + r->offset(idx), len);
  return len;
}

// Total payload size of a batch of records, for sizing the read buffer
// in one native call. Returns UINT64_MAX on any out-of-range index.
uint64_t pr_batch_length(void* handle, const uint64_t* idxs, uint64_t n) {
  Reader* r = static_cast<Reader*>(handle);
  if (!r || !idxs) return UINT64_MAX;
  uint64_t total = 0;
  for (uint64_t i = 0; i < n; ++i) {
    if (idxs[i] >= r->num_records) return UINT64_MAX;
    total += r->length(idxs[i]);
  }
  return total;
}

// Batched copying read: records land back-to-back in buf, per-record
// lengths in out_lengths. ONE ctypes crossing per batch instead of per
// record. Returns total bytes written, or 0 on any error (bad index /
// insufficient buffer).
uint64_t pr_read_batch(void* handle, const uint64_t* idxs, uint64_t n,
                       void* buf, uint64_t buf_len, uint64_t* out_lengths) {
  Reader* r = static_cast<Reader*>(handle);
  if (!r || !idxs || !buf || !out_lengths) return 0;
  uint8_t* out = static_cast<uint8_t*>(buf);
  uint64_t total = 0;
  for (uint64_t i = 0; i < n; ++i) {
    if (idxs[i] >= r->num_records) return 0;
    const uint64_t len = r->length(idxs[i]);
    if (buf_len - total < len) return 0;
    std::memcpy(out + total, r->payload + r->offset(idxs[i]), len);
    out_lengths[i] = len;
    total += len;
  }
  return total;
}

// Readahead hint: madvise(WILLNEED) the page ranges of upcoming records
// so a cold page cache starts faulting them in before the reads land.
void pr_prefetch(void* handle, const uint64_t* idxs, uint64_t n) {
  Reader* r = static_cast<Reader*>(handle);
  if (!r || !idxs) return;
  const long page = ::sysconf(_SC_PAGESIZE);
  for (uint64_t i = 0; i < n; ++i) {
    if (idxs[i] >= r->num_records) continue;
    const uint8_t* p = r->payload + r->offset(idxs[i]);
    const uint64_t len = r->length(idxs[i]);
    uintptr_t start = reinterpret_cast<uintptr_t>(p) & ~(page - 1);
    size_t span = (reinterpret_cast<uintptr_t>(p) + len) - start;
    ::madvise(reinterpret_cast<void*>(start), span, MADV_WILLNEED);
  }
}

// Integrity check: 1 = ok, 0 = corrupt or bad index. v1 files carry no
// checksum, so every in-bounds record reports ok.
int32_t pr_verify_record(void* handle, uint64_t idx) {
  Reader* r = static_cast<Reader*>(handle);
  if (!r || idx >= r->num_records) return 0;
  if (r->version == 1) return 1;
  const IndexV2& e = r->idx2[idx];
  return crc32(r->payload + e.offset, e.length) == e.crc32 ? 1 : 0;
}

// Full-file scan; returns the number of corrupt records.
uint64_t pr_verify_all(void* handle) {
  Reader* r = static_cast<Reader*>(handle);
  if (!r) return 0;
  uint64_t bad = 0;
  for (uint64_t i = 0; i < r->num_records; ++i)
    bad += pr_verify_record(handle, i) ? 0 : 1;
  return bad;
}

void pr_close(void* handle) {
  Reader* r = static_cast<Reader*>(handle);
  if (!r) return;
  if (r->map) ::munmap(const_cast<uint8_t*>(r->map), r->map_size);
  if (r->fd >= 0) ::close(r->fd);
  delete r;
}

}  // extern "C"
