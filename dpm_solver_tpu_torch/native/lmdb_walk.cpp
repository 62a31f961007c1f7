// Native B+tree walker for the LMDB on-disk format.
//
// The pure-Python reader (utils/lmdb.py) parses one struct per node per
// item; for LSUN-scale databases (millions of JPEG values,
// ref datasets/lsun.py:12-58) that Python overhead dominates iteration.
// This walker emits the full entry table — (key_off, key_len, val_off,
// val_len) per record, overflow pages resolved — in one C pass over the
// mmap; Python then serves zero-copy slices.
//
// Layout constants mirror upstream mdb.c exactly as utils/lmdb.py does:
// page header {..., flags@10:u16, lower@12:u16}, node {lo:u16, hi:u16,
// flags:u16, ksize:u16, key..., data...}, branch NODEPGNO 48-bit.

#include <cstdint>
#include <cstring>

namespace {

constexpr uint64_t kPageHdr = 16;
constexpr uint16_t kBranch = 0x01;
constexpr uint16_t kLeaf = 0x02;
constexpr uint16_t kOverflow = 0x04;
constexpr uint16_t kBigData = 0x01;

// error codes surfaced to Python (utils/lmdb_native.py _ERRORS)
constexpr long long kTooDeep = -2;
constexpr long long kCorrupt = -3;
constexpr long long kBadPage = -4;
constexpr long long kCapacity = -5;

struct Ctx {
  const uint8_t* buf;
  uint64_t fsize;
  uint64_t psize;
  uint64_t* out;   // rows of 4 x u64
  long long cap;   // max rows
  long long n;     // rows written
};

inline uint16_t rd16(const uint8_t* p) {
  uint16_t v;
  std::memcpy(&v, p, 2);
  return v;
}

inline uint64_t rd64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

long long walk(Ctx& c, uint64_t pgno, int depth) {
  if (depth > 64) return kTooDeep;
  const uint64_t base = pgno * c.psize;
  if (base + kPageHdr > c.fsize) return kCorrupt;
  const uint16_t flags = rd16(c.buf + base + 10);
  const uint16_t lower = rd16(c.buf + base + 12);
  const long long nkeys = ((long long)lower - (long long)kPageHdr) >> 1;
  if (nkeys < 0 || kPageHdr + 2 * (uint64_t)nkeys > c.psize) return kCorrupt;

  if (flags & kLeaf) {
    for (long long i = 0; i < nkeys; ++i) {
      const uint64_t off = base + rd16(c.buf + base + kPageHdr + 2 * i);
      if (off + 8 > c.fsize) return kCorrupt;
      const uint16_t lo = rd16(c.buf + off);
      const uint16_t hi = rd16(c.buf + off + 2);
      const uint16_t nflags = rd16(c.buf + off + 4);
      const uint16_t ksize = rd16(c.buf + off + 6);
      const uint64_t dsize = (uint64_t)lo | ((uint64_t)hi << 16);
      const uint64_t koff = off + 8;
      const uint64_t doff = koff + ksize;
      uint64_t voff;
      if (nflags & kBigData) {
        if (doff + 8 > c.fsize) return kCorrupt;
        const uint64_t ovbase = rd64(c.buf + doff) * c.psize;
        if (ovbase + kPageHdr > c.fsize) return kCorrupt;
        if (!(rd16(c.buf + ovbase + 10) & kOverflow)) return kBadPage;
        voff = ovbase + kPageHdr;
      } else {
        voff = doff;
      }
      if (koff + ksize > c.fsize || voff + dsize > c.fsize) return kCorrupt;
      if (c.n >= c.cap) return kCapacity;
      uint64_t* row = c.out + 4 * c.n++;
      row[0] = koff;
      row[1] = ksize;
      row[2] = voff;
      row[3] = dsize;
    }
  } else if (flags & kBranch) {
    for (long long i = 0; i < nkeys; ++i) {
      const uint64_t off = base + rd16(c.buf + base + kPageHdr + 2 * i);
      if (off + 8 > c.fsize) return kCorrupt;
      const uint64_t child = (uint64_t)rd16(c.buf + off) |
                             ((uint64_t)rd16(c.buf + off + 2) << 16) |
                             ((uint64_t)rd16(c.buf + off + 4) << 32);
      const long long r = walk(c, child, depth + 1);
      if (r < 0) return r;
    }
  } else {
    return kBadPage;
  }
  return 0;
}

}  // namespace

extern "C" long long lmdb_walk(const uint8_t* buf, uint64_t fsize,
                               uint64_t psize, uint64_t root, uint64_t* out,
                               long long cap) {
  Ctx c{buf, fsize, psize, out, cap, 0};
  const long long r = walk(c, root, 0);
  return r < 0 ? r : c.n;
}
