// Core of the host-IO runtime of dpm_solver_tpu_torch: TFRecord framing and
// the tf.train.Example wire format, with no header outside the C++ standard
// library and POSIX, so that it builds wherever g++ does.
//
// The reference reads its training data through tf.data's C++ runtime
// (examples/score_sde_jax/datasets.py:103-199); this is the port's native
// twin of that part, driven from Python through ctypes
// (dpm_solver_tpu_torch/native/__init__.py). The image codecs are separate
// libraries: png.cpp (on zlib) and jpeg.cpp (on libjpeg).
//
// Components (all extern "C", no global state):
//   * TFRecord index/scan: mmap + the framed record layout
//     (u64 len | u32 maskedcrc(len) | payload | u32 maskedcrc(payload))
//     with CRC32C (Castagnoli) verification.
//   * Minimal tf.train.Example walker: find the first bytes/int64 value for
//     a feature key without a protobuf runtime (wire format only).
//
// Build: dpm_solver_tpu_torch/native/build.py (g++ -O2 -shared).

#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// ------------------------------------------------------------------- CRC32C
// Castagnoli polynomial (reflected 0x82F63B78), table-driven; the TFRecord
// framing masks it as ((crc >> 15 | crc << 17) + 0xa282ead8).
struct Crc32cTable {
  uint32_t t[256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? (0x82F63B78u ^ (c >> 1)) : (c >> 1);
      t[i] = c;
    }
  }
};
const Crc32cTable kCrc;

uint32_t crc32c(const uint8_t* p, size_t n) {
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i) c = kCrc.t[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

uint32_t masked_crc(const uint8_t* p, size_t n) {
  uint32_t c = crc32c(p, n);
  return ((c >> 15) | (c << 17)) + 0xa282ead8u;
}

uint32_t load_u32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;  // TFRecord framing is little-endian; so are our targets
}

uint64_t load_u64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

// --------------------------------------------------------- protobuf walking
// Enough of the wire format to navigate tf.train.Example:
//   Example{ Features features=1 } ; Features{ map<string,Feature> feature=1 }
//   map entry { string key=1; Feature value=2 }
//   Feature{ BytesList=1 | FloatList=2 | Int64List=3 }, each { repeated v=1 }
struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  uint64_t varint() {
    uint64_t v = 0;
    int shift = 0;
    while (p < end && shift < 64) {
      uint8_t b = *p++;
      v |= static_cast<uint64_t>(b & 0x7F) << shift;
      if (!(b & 0x80)) return v;
      shift += 7;
    }
    ok = false;
    return 0;
  }

  // Returns field number, sets wire type; 0 on end/error.
  uint32_t tag(uint32_t* wire) {
    if (p >= end) return 0;
    uint64_t t = varint();
    if (!ok) return 0;
    *wire = static_cast<uint32_t>(t & 7);
    return static_cast<uint32_t>(t >> 3);
  }

  // Length-delimited payload: returns start, advances past it.
  const uint8_t* len_delimited(uint64_t* n) {
    *n = varint();
    if (!ok || p + *n > end) {
      ok = false;
      return nullptr;
    }
    const uint8_t* s = p;
    p += *n;
    return s;
  }

  void skip(uint32_t wire) {
    switch (wire) {
      case 0: varint(); break;
      case 1: p += 8; break;
      case 2: {
        uint64_t n;
        len_delimited(&n);
        break;
      }
      case 5: p += 4; break;
      default: ok = false;
    }
    if (p > end) ok = false;
  }
};

// Find the Feature submessage for `key` inside a serialized Example.
// Returns true and sets [fs, fe) to the Feature bytes.
bool find_feature(const uint8_t* rec, int64_t len, const char* key,
                  const uint8_t** fs, const uint8_t** fe) {
  size_t klen = std::strlen(key);
  Cursor ex{rec, rec + len};
  uint32_t wire;
  while (uint32_t f = ex.tag(&wire)) {
    if (f == 1 && wire == 2) {  // Features
      uint64_t n;
      const uint8_t* s = ex.len_delimited(&n);
      if (!s) return false;
      Cursor feats{s, s + n};
      while (uint32_t ff = feats.tag(&wire)) {
        if (ff == 1 && wire == 2) {  // map entry
          uint64_t en;
          const uint8_t* es = feats.len_delimited(&en);
          if (!es) return false;
          Cursor entry{es, es + en};
          const uint8_t *ks = nullptr, *vs = nullptr;
          uint64_t kn = 0, vn = 0;
          while (uint32_t ef = entry.tag(&wire)) {
            if (ef == 1 && wire == 2) {
              ks = entry.len_delimited(&kn);
            } else if (ef == 2 && wire == 2) {
              vs = entry.len_delimited(&vn);
            } else {
              entry.skip(wire);
            }
            if (!entry.ok) return false;
          }
          if (ks && vs && kn == klen && std::memcmp(ks, key, klen) == 0) {
            *fs = vs;
            *fe = vs + vn;
            return true;
          }
        } else {
          feats.skip(wire);
        }
        if (!feats.ok) return false;
      }
    } else {
      ex.skip(wire);
    }
    if (!ex.ok) return false;
  }
  return false;
}

}  // namespace

extern "C" {

// Index a TFRecord file: fill offsets[]/lengths[] (payload byte ranges) up
// to cap records. check_crc=1 verifies both masked CRC32C fields; =0 only
// the header CRC (cheap corruption guard). Returns the record count, or
// -(byte_position+1) of the first framing/CRC error.
int64_t dpm_tfrecord_index(const char* path, int64_t* offsets,
                           int64_t* lengths, int64_t cap, int check_crc) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return -1;
  }
  if (st.st_size == 0) {
    close(fd);
    return 0;
  }
  const uint8_t* base = static_cast<const uint8_t*>(
      mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0));
  close(fd);
  if (base == MAP_FAILED) return -1;
  int64_t size = st.st_size, pos = 0, count = 0;
  while (pos < size) {
    if (pos + 12 > size) {
      count = -(pos + 1);
      break;
    }
    uint64_t len = load_u64(base + pos);
    if (load_u32(base + pos + 8) != masked_crc(base + pos, 8) ||
        pos + 12 + static_cast<int64_t>(len) + 4 > size) {
      count = -(pos + 1);
      break;
    }
    const uint8_t* payload = base + pos + 12;
    if (check_crc &&
        load_u32(payload + len) != masked_crc(payload, len)) {
      count = -(pos + 1);
      break;
    }
    if (count < cap) {
      offsets[count] = pos + 12;
      lengths[count] = static_cast<int64_t>(len);
    }
    ++count;
    pos += 12 + static_cast<int64_t>(len) + 4;
  }
  munmap(const_cast<uint8_t*>(base), st.st_size);
  return count;
}

// Locate the idx-th bytes value of feature `key` inside a serialized
// tf.train.Example. Sets *off/*blen relative to rec. Returns 0 on success,
// 1 if the key/value is absent or malformed.
int dpm_example_find_bytes(const uint8_t* rec, int64_t len, const char* key,
                           int64_t idx, int64_t* off, int64_t* blen) {
  const uint8_t *fs, *fe;
  if (!find_feature(rec, len, key, &fs, &fe)) return 1;
  Cursor feat{fs, fe};
  uint32_t wire;
  while (uint32_t f = feat.tag(&wire)) {
    if (f == 1 && wire == 2) {  // BytesList
      uint64_t n;
      const uint8_t* s = feat.len_delimited(&n);
      if (!s) return 1;
      Cursor list{s, s + n};
      int64_t seen = 0;
      while (uint32_t lf = list.tag(&wire)) {
        if (lf == 1 && wire == 2) {
          uint64_t bn;
          const uint8_t* bs = list.len_delimited(&bn);
          if (!bs) return 1;
          if (seen++ == idx) {
            *off = bs - rec;
            *blen = static_cast<int64_t>(bn);
            return 0;
          }
        } else {
          list.skip(wire);
        }
        if (!list.ok) return 1;
      }
    } else {
      feat.skip(wire);
    }
    if (!feat.ok) return 1;
  }
  return 1;
}

// First int64 value of feature `key` (Int64List, packed or not). Returns 0
// on success.
int dpm_example_find_int64(const uint8_t* rec, int64_t len, const char* key,
                           int64_t* value) {
  const uint8_t *fs, *fe;
  if (!find_feature(rec, len, key, &fs, &fe)) return 1;
  Cursor feat{fs, fe};
  uint32_t wire;
  while (uint32_t f = feat.tag(&wire)) {
    if (f == 3 && wire == 2) {  // Int64List
      uint64_t n;
      const uint8_t* s = feat.len_delimited(&n);
      if (!s) return 1;
      Cursor list{s, s + n};
      while (uint32_t lf = list.tag(&wire)) {
        if (lf == 1 && wire == 0) {  // unpacked varint
          *value = static_cast<int64_t>(list.varint());
          return list.ok ? 0 : 1;
        }
        if (lf == 1 && wire == 2) {  // packed
          uint64_t pn;
          const uint8_t* ps = list.len_delimited(&pn);
          if (!ps) return 1;
          Cursor packed{ps, ps + pn};
          *value = static_cast<int64_t>(packed.varint());
          return packed.ok ? 0 : 1;
        }
        list.skip(wire);
        if (!list.ok) return 1;
      }
    } else {
      feat.skip(wire);
    }
    if (!feat.ok) return 1;
  }
  return 1;
}

// CRC32C of a buffer (unmasked); exposed for tests.
uint32_t dpm_crc32c(const uint8_t* p, int64_t n) {
  return crc32c(p, static_cast<size_t>(n));
}

}  // extern "C"
