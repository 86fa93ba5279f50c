// RecordIO-style chunked record storage (native data plane).
//
// The reference's distributed data plane stores datasets as RecordIO chunks
// dispensed by the Go master (go/master/service.go partition :106 operates on
// recordio chunk index ranges). The port's copy of the JAX package's codec,
// in C++ as the reference's data plumbing is native: a chunked, CRC-checked,
// length-prefixed record file
//
//   file   := chunk*
//   chunk  := magic u32 | nrec u32 | dlen u32 | crc32 u32 | payload[dlen]
//   payload:= (varint len | bytes)*
//
// Python binds via ctypes (recordio.py); its pure-Python codec, the plain
// version, reads and writes the identical bytes, so files interop either way
// and with the JAX package's. The CRC is zlib's crc32 (linked with -lz).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

constexpr uint32_t kMagic = 0x52433130u;  // "RC10"
constexpr size_t kDefaultChunkBytes = 1 << 20;

struct Writer {
  FILE* f = nullptr;
  std::vector<uint8_t> buf;
  uint32_t nrec = 0;
  size_t chunk_bytes = kDefaultChunkBytes;
};

struct Reader {
  FILE* f = nullptr;
  std::vector<uint8_t> chunk;
  size_t pos = 0;
  uint32_t remaining = 0;
};

void put_varint(std::vector<uint8_t>& out, uint64_t v) {
  while (v >= 0x80) {
    out.push_back(static_cast<uint8_t>(v) | 0x80);
    v >>= 7;
  }
  out.push_back(static_cast<uint8_t>(v));
}

bool flush_chunk(Writer* w) {
  if (w->nrec == 0) return true;
  uint32_t dlen = static_cast<uint32_t>(w->buf.size());
  uint32_t crc =
      static_cast<uint32_t>(crc32(0L, w->buf.data(), w->buf.size()));
  uint32_t head[4] = {kMagic, w->nrec, dlen, crc};
  if (fwrite(head, sizeof(head), 1, w->f) != 1) return false;
  if (dlen && fwrite(w->buf.data(), 1, dlen, w->f) != dlen) return false;
  w->buf.clear();
  w->nrec = 0;
  return true;
}

// 1: a chunk is loaded; 0: end of file (fewer than 16 bytes left, as the
// Python codec reads it); -1: bad magic, short payload or CRC mismatch.
int load_chunk(Reader* r) {
  uint32_t head[4];
  if (fread(head, sizeof(head), 1, r->f) != 1) return 0;  // EOF
  if (head[0] != kMagic) return -1;
  r->chunk.resize(head[2]);
  if (head[2] && fread(r->chunk.data(), 1, head[2], r->f) != head[2])
    return -1;
  uint32_t crc =
      static_cast<uint32_t>(crc32(0L, r->chunk.data(), r->chunk.size()));
  if (crc != head[3]) return -1;  // corruption detected
  r->pos = 0;
  r->remaining = head[1];
  return 1;
}

}  // namespace

extern "C" {

void* rio_writer_open(const char* path, uint64_t chunk_bytes) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  auto* w = new Writer;
  w->f = f;
  if (chunk_bytes) w->chunk_bytes = chunk_bytes;
  return w;
}

int rio_write(void* h, const uint8_t* data, uint64_t len) {
  auto* w = static_cast<Writer*>(h);
  put_varint(w->buf, len);
  w->buf.insert(w->buf.end(), data, data + len);
  w->nrec++;
  if (w->buf.size() >= w->chunk_bytes) {
    if (!flush_chunk(w)) return -1;
  }
  return 0;
}

int rio_writer_close(void* h) {
  auto* w = static_cast<Writer*>(h);
  int rc = flush_chunk(w) ? 0 : -1;
  fclose(w->f);
  delete w;
  return rc;
}

void* rio_reader_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* r = new Reader;
  r->f = f;
  return r;
}

// Returns record length (an empty record is 0), -2 on EOF, -1 on
// error/too-small buffer (needed length written to *need). A too-small
// buffer consumes nothing: the call again with `cap` >= *need returns the
// same record.
int64_t rio_read_next(void* h, uint8_t* out, uint64_t cap, uint64_t* need) {
  auto* r = static_cast<Reader*>(h);
  while (r->remaining == 0) {  // a chunk may hold no record
    const int rc = load_chunk(r);
    if (rc <= 0) return rc == 0 ? -2 : -1;
  }
  const size_t start = r->pos;
  uint64_t len = 0;
  int shift = 0;
  while (true) {
    if (r->pos >= r->chunk.size()) return -1;
    uint8_t b = r->chunk[r->pos++];
    len |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) break;
    shift += 7;
  }
  if (need) *need = len;
  if (len > cap) {
    r->pos = start;
    return -1;
  }
  if (r->pos + len > r->chunk.size()) return -1;
  memcpy(out, r->chunk.data() + r->pos, len);
  r->pos += len;
  r->remaining--;
  return static_cast<int64_t>(len);
}

int rio_reader_close(void* h) {
  auto* r = static_cast<Reader*>(h);
  fclose(r->f);
  delete r;
  return 0;
}
}
