// PNG codec of the host-IO runtime of dpm_solver_tpu_torch, on zlib alone.
//
// The FID protocol writes and re-reads tens of thousands of PNGs per
// evaluation (examples/ddpm_and_guided-diffusion/runners/diffusion.py:450-457,
// evaluate/fid_score.py:146-170), and encoded-image datasets carry PNG
// payloads. The JAX package's io.cpp encodes and decodes them with libpng;
// this file does the same work with zlib's deflate and inflate and the PNG
// format itself (ISO/IEC 15948: chunks, the five row filters, Adam7), so it
// builds on machines that have zlib but no libpng. Its output is what
// libpng's read gives under the JAX package's transforms:
//   palette -> RGB; gray of 1, 2 or 4 bits -> 8 bits (scaled); 16 bits ->
//   the high byte; tRNS -> alpha; gray -> RGB where 3 or 4 channels are
//   asked; RGB -> gray where 1 or 2 are (libpng's fixed-point weights 6968,
//   23434 and 2366 / 32768 in its no-gamma path, truncated at 8 bits and
//   rounded at 16); alpha stripped, or added as 0xFF, to the channels asked.
// libpng linearises RGB -> gray through gamma tables when the file carries
// gAMA, sRGB, cHRM or iCCP; this decoder refuses that one case (it fails)
// rather than give other values.
//
// Entries (extern "C", no global state, a thread pool per batch call):
// dpm_png_write_batch, dpm_png_probe, dpm_png_read_batch, dpm_png_probe_mem,
// dpm_png_decode_mem_batch. Build: native/build.py (g++ -O2 -shared -lz).

#include <zlib.h>

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include "parallel.h"

namespace {

const uint8_t kSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};

enum Color { kGray = 0, kRGB = 2, kPalette = 3, kGrayAlpha = 4, kRGBA = 6 };

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

void put_be32(std::vector<uint8_t>* out, uint32_t v) {
  out->push_back(uint8_t(v >> 24));
  out->push_back(uint8_t(v >> 16));
  out->push_back(uint8_t(v >> 8));
  out->push_back(uint8_t(v));
}

// Samples a pixel of the file's colour type.
int source_channels(int color) {
  switch (color) {
    case kGray: case kPalette: return 1;
    case kGrayAlpha: return 2;
    case kRGB: return 3;
    case kRGBA: return 4;
    default: return 0;
  }
}

// The channel count the JAX package's probe reports (palette counts as RGB).
int probe_channels(int color) {
  return color == kGray ? 1 : color == kGrayAlpha ? 2 : color == kRGBA ? 4 : 3;
}

bool valid_depth(int color, int depth) {
  switch (color) {
    case kGray: return depth == 1 || depth == 2 || depth == 4 || depth == 8 || depth == 16;
    case kPalette: return depth == 1 || depth == 2 || depth == 4 || depth == 8;
    case kRGB: case kGrayAlpha: case kRGBA: return depth == 8 || depth == 16;
    default: return false;
  }
}

struct Png {
  uint32_t w = 0, h = 0;
  int depth = 0, color = 0, interlace = 0;
  uint8_t plte[256][3] = {};      // entries past the file's read as black
  int nplte = 0;
  uint8_t trns_alpha[256];        // palette transparency; 255 past the file's
  int ntrns = 0;
  uint16_t key[3] = {0, 0, 0};    // gray / RGB transparency key
  bool has_key = false;
  bool colorimetry = false;       // gAMA, sRGB, cHRM or iCCP seen
  std::vector<uint8_t> idat;
};

// Parses the chunks of an in-memory PNG (up to IEND, or up to and including
// IHDR with header_only). Verifies the CRC of every chunk it uses.
bool parse(const uint8_t* p, size_t n, Png* png, bool header_only) {
  std::memset(png->trns_alpha, 255, sizeof(png->trns_alpha));
  if (n < 8 || std::memcmp(p, kSig, 8) != 0) return false;
  size_t pos = 8;
  bool seen_ihdr = false;
  while (pos + 12 <= n) {
    const uint32_t len = be32(p + pos);
    if (len > n - pos - 12) return false;
    const uint8_t* type = p + pos + 4;
    const uint8_t* data = p + pos + 8;
    const bool used = !std::memcmp(type, "IHDR", 4) || !std::memcmp(type, "PLTE", 4) ||
                      !std::memcmp(type, "tRNS", 4) || !std::memcmp(type, "IDAT", 4) ||
                      !std::memcmp(type, "IEND", 4);
    if (used && uint32_t(crc32(0L, type, len + 4)) != be32(data + len)) return false;
    if (!seen_ihdr && std::memcmp(type, "IHDR", 4) != 0) return false;
    if (!std::memcmp(type, "IHDR", 4)) {
      if (len != 13 || seen_ihdr) return false;
      png->w = be32(data);
      png->h = be32(data + 4);
      png->depth = data[8];
      png->color = data[9];
      png->interlace = data[12];
      if (png->w == 0 || png->h == 0 || png->w > (1u << 30) || png->h > (1u << 30) ||
          !valid_depth(png->color, png->depth) || data[10] != 0 || data[11] != 0 ||
          png->interlace > 1)
        return false;
      seen_ihdr = true;
      if (header_only) return true;
    } else if (!std::memcmp(type, "PLTE", 4)) {
      if (len % 3 || len > 768) return false;
      png->nplte = int(len / 3);
      std::memcpy(png->plte, data, len);
    } else if (!std::memcmp(type, "tRNS", 4)) {
      if (png->color == kPalette) {
        if (len > 256) return false;
        png->ntrns = int(len);
        std::memcpy(png->trns_alpha, data, len);
      } else if (png->color == kGray && len == 2) {
        png->key[0] = uint16_t((data[0] << 8) | data[1]);
        png->has_key = true;
      } else if (png->color == kRGB && len == 6) {
        for (int k = 0; k < 3; ++k) png->key[k] = uint16_t((data[2 * k] << 8) | data[2 * k + 1]);
        png->has_key = true;
      }
    } else if (!std::memcmp(type, "IDAT", 4)) {
      png->idat.insert(png->idat.end(), data, data + len);
    } else if (!std::memcmp(type, "IEND", 4)) {
      return !png->idat.empty() && (png->color != kPalette || png->nplte > 0);
    } else if (!std::memcmp(type, "gAMA", 4) || !std::memcmp(type, "sRGB", 4) ||
               !std::memcmp(type, "cHRM", 4) || !std::memcmp(type, "iCCP", 4)) {
      png->colorimetry = true;
    }
    pos += 12 + size_t(len);
  }
  return false;
}

// The seven Adam7 passes: x offset, y offset, x step, y step.
const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                          {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};

struct Pass {
  uint32_t x0, y0, dx, dy, w, h;
};

std::vector<Pass> passes(const Png& png) {
  std::vector<Pass> out;
  if (!png.interlace) {
    out.push_back({0, 0, 1, 1, png.w, png.h});
    return out;
  }
  for (const auto& a : kAdam7) {
    const uint32_t x0 = a[0], y0 = a[1], dx = a[2], dy = a[3];
    const uint32_t w = png.w > x0 ? (png.w - x0 + dx - 1) / dx : 0;
    const uint32_t h = png.h > y0 ? (png.h - y0 + dy - 1) / dy : 0;
    if (w && h) out.push_back({x0, y0, dx, dy, w, h});
  }
  return out;
}

size_t row_bytes(const Png& png, uint32_t w) {
  return (size_t(w) * source_channels(png.color) * png.depth + 7) / 8;
}

uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = p > a ? p - a : a - p, pb = p > b ? p - b : b - p, pc = p > c ? p - c : c - p;
  return uint8_t(pa <= pb && pa <= pc ? a : pb <= pc ? b : c);
}

// Reverses the row filters in place over `rows` rows of 1 + rb bytes.
bool unfilter(uint8_t* data, uint32_t rows, size_t rb, size_t bpp) {
  const uint8_t* prior = nullptr;
  for (uint32_t y = 0; y < rows; ++y) {
    uint8_t* row = data + size_t(y) * (rb + 1);
    const int filter = row[0];
    uint8_t* x = row + 1;
    for (size_t i = 0; i < rb; ++i) {
      const int a = i >= bpp ? x[i - bpp] : 0;
      const int b = prior ? prior[i] : 0;
      const int c = prior && i >= bpp ? prior[i - bpp] : 0;
      switch (filter) {
        case 0: break;
        case 1: x[i] = uint8_t(x[i] + a); break;
        case 2: x[i] = uint8_t(x[i] + b); break;
        case 3: x[i] = uint8_t(x[i] + ((a + b) >> 1)); break;
        case 4: x[i] = uint8_t(x[i] + paeth(a, b, c)); break;
        default: return false;
      }
    }
    prior = x;
  }
  return true;
}

uint32_t sample(const uint8_t* row, int depth, size_t i) {
  switch (depth) {
    case 8: return row[i];
    case 16: return (uint32_t(row[2 * i]) << 8) | row[2 * i + 1];
    default: {
      const size_t bit = i * depth;
      return (row[bit >> 3] >> (8 - depth - (bit & 7))) & ((1u << depth) - 1);
    }
  }
}

// One source pixel -> c output channels, libpng's transforms (file comment).
// Fails only for RGB -> gray on a file with colorimetry.
bool convert(const Png& png, const uint8_t* row, size_t px, uint8_t* dst, int c) {
  const int sc = source_channels(png.color);
  uint32_t s[4] = {0, 0, 0, 0};
  for (int k = 0; k < sc; ++k) s[k] = sample(row, png.depth, px * sc + k);
  // working values at 8 bits, or 16 for 16-bit files
  const bool wide = png.depth == 16;
  const uint32_t full = wide ? 0xFFFF : 0xFF;
  uint32_t r, g, b, a = full;
  bool color = true, has_alpha = false;
  switch (png.color) {
    case kPalette:
      r = png.plte[s[0]][0], g = png.plte[s[0]][1], b = png.plte[s[0]][2];
      a = png.trns_alpha[s[0]];
      has_alpha = png.ntrns > 0;
      break;
    case kGray:
    case kGrayAlpha: {
      color = false;
      const uint32_t scale = png.depth == 1 ? 255 : png.depth == 2 ? 85 : png.depth == 4 ? 17 : 1;
      r = g = b = s[0] * scale;
      if (png.color == kGrayAlpha) {
        a = s[1];
        has_alpha = true;
      } else if (png.has_key) {
        a = s[0] == png.key[0] ? 0 : full;
        has_alpha = true;
      }
      break;
    }
    default:  // RGB, RGBA
      r = s[0], g = s[1], b = s[2];
      if (png.color == kRGBA) {
        a = s[3];
        has_alpha = true;
      } else if (png.has_key) {
        a = s[0] == png.key[0] && s[1] == png.key[1] && s[2] == png.key[2] ? 0 : full;
        has_alpha = true;
      }
  }
  uint32_t gray = r;
  if (c <= 2 && color) {
    if (png.colorimetry) return false;
    if (wide)
      gray = (6968 * r + 23434 * g + 2366 * b + 16384) >> 15;
    else if (r != g || r != b)
      gray = (6968 * r + 23434 * g + 2366 * b) >> 15;
  }
  const int shift = wide ? 8 : 0;
  if (!has_alpha) a = full;
  switch (c) {
    case 1: dst[0] = uint8_t(gray >> shift); break;
    case 2: dst[0] = uint8_t(gray >> shift), dst[1] = uint8_t(a >> shift); break;
    case 3: dst[0] = uint8_t(r >> shift), dst[1] = uint8_t(g >> shift), dst[2] = uint8_t(b >> shift);
            break;
    default: dst[0] = uint8_t(r >> shift), dst[1] = uint8_t(g >> shift),
             dst[2] = uint8_t(b >> shift), dst[3] = uint8_t(a >> shift);
  }
  return true;
}

// Decodes one in-memory PNG into out (h*w*c uint8). Returns 0 on success,
// 1 on a malformed file or one that is not h x w.
int decode_png_mem(const uint8_t* buf, size_t n, uint8_t* out, int64_t h, int64_t w, int64_t c) {
  if (c < 1 || c > 4) return 1;
  Png png;
  if (!parse(buf, n, &png, false) || png.w != uint64_t(w) || png.h != uint64_t(h)) return 1;
  const size_t bpp = (size_t(source_channels(png.color)) * png.depth + 7) / 8;
  const std::vector<Pass> ps = passes(png);
  size_t total = 0;
  for (const Pass& p : ps) total += size_t(p.h) * (1 + row_bytes(png, p.w));
  std::vector<uint8_t> raw(total);
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return 1;
  zs.next_in = png.idat.data();
  zs.avail_in = uInt(png.idat.size());
  zs.next_out = raw.data();
  zs.avail_out = uInt(total);
  const int zr = inflate(&zs, Z_FINISH);
  const size_t got = zs.total_out;
  inflateEnd(&zs);
  if ((zr != Z_STREAM_END && zr != Z_BUF_ERROR && zr != Z_OK) || got != total) return 1;
  uint8_t* data = raw.data();
  for (const Pass& p : ps) {
    const size_t rb = row_bytes(png, p.w);
    if (!unfilter(data, p.h, rb, bpp)) return 1;
    for (uint32_t y = 0; y < p.h; ++y) {
      const uint8_t* row = data + size_t(y) * (rb + 1) + 1;
      uint8_t* dst_row = out + (size_t(p.y0) + size_t(y) * p.dy) * size_t(w) * c;
      for (uint32_t x = 0; x < p.w; ++x)
        if (!convert(png, row, x, dst_row + (size_t(p.x0) + size_t(x) * p.dx) * c, int(c)))
          return 1;
    }
    data += size_t(p.h) * (rb + 1);
  }
  return 0;
}

bool read_file(const char* path, std::vector<uint8_t>* out, size_t limit = 0) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  uint8_t chunk[1 << 16];
  size_t got;
  while ((got = std::fread(chunk, 1, limit ? std::min(limit - out->size(), sizeof(chunk))
                                           : sizeof(chunk), fp)) > 0) {
    out->insert(out->end(), chunk, chunk + got);
    if (limit && out->size() >= limit) break;
  }
  const bool ok = !std::ferror(fp);
  std::fclose(fp);
  return ok;
}

void put_chunk(std::vector<uint8_t>* out, const char* type, const uint8_t* data, size_t len) {
  put_be32(out, uint32_t(len));
  const size_t start = out->size();
  out->insert(out->end(), type, type + 4);
  out->insert(out->end(), data, data + len);
  put_be32(out, uint32_t(crc32(0L, out->data() + start, uInt(len + 4))));
}

// --------------------------------------------------------------- PNG encode
struct PngWriteCtx {
  const uint8_t* data;
  int64_t h, w, c;
  const char** paths;
};

int write_one_png(int64_t i, void* vctx) {
  auto* ctx = static_cast<PngWriteCtx*>(vctx);
  static const uint8_t kColor[5] = {0, kGray, kGrayAlpha, kRGB, kRGBA};
  if (ctx->c < 1 || ctx->c > 4 || ctx->h < 1 || ctx->w < 1) return 1;
  const size_t rb = size_t(ctx->w) * ctx->c;
  const uint8_t* img = ctx->data + i * ctx->h * ctx->w * ctx->c;
  // every row SUB-filtered at deflate level 1: FID folders are written once
  // and scanned once, so encode speed matters more than size (the JAX
  // package's libpng writer makes the same choice)
  std::vector<uint8_t> filtered(size_t(ctx->h) * (rb + 1));
  for (int64_t y = 0; y < ctx->h; ++y) {
    const uint8_t* src = img + y * rb;
    uint8_t* dst = filtered.data() + y * (rb + 1);
    dst[0] = 1;
    for (size_t k = 0; k < rb; ++k)
      dst[1 + k] = uint8_t(src[k] - (k >= size_t(ctx->c) ? src[k - ctx->c] : 0));
  }
  uLongf zlen = compressBound(uLong(filtered.size()));
  std::vector<uint8_t> z(zlen);
  if (compress2(z.data(), &zlen, filtered.data(), uLong(filtered.size()), 1) != Z_OK) return 1;
  std::vector<uint8_t> file(kSig, kSig + 8);
  uint8_t ihdr[13];
  for (int k = 0; k < 4; ++k) {
    ihdr[k] = uint8_t(ctx->w >> (24 - 8 * k));
    ihdr[4 + k] = uint8_t(ctx->h >> (24 - 8 * k));
  }
  ihdr[8] = 8, ihdr[9] = kColor[ctx->c], ihdr[10] = ihdr[11] = ihdr[12] = 0;
  put_chunk(&file, "IHDR", ihdr, 13);
  put_chunk(&file, "IDAT", z.data(), zlen);
  put_chunk(&file, "IEND", nullptr, 0);
  FILE* fp = std::fopen(ctx->paths[i], "wb");
  if (!fp) return 1;
  const bool ok = std::fwrite(file.data(), 1, file.size(), fp) == file.size();
  return (std::fclose(fp) == 0 && ok) ? 0 : 1;
}

// --------------------------------------------------------------- PNG decode
struct PngReadCtx {
  const char** paths;
  uint8_t* out;
  int64_t h, w, c;
};

int read_one_png(int64_t i, void* vctx) {
  auto* ctx = static_cast<PngReadCtx*>(vctx);
  std::vector<uint8_t> buf;
  if (!read_file(ctx->paths[i], &buf)) return 1;
  return decode_png_mem(buf.data(), buf.size(), ctx->out + i * ctx->h * ctx->w * ctx->c, ctx->h,
                        ctx->w, ctx->c);
}

struct MemDecodeCtx {
  const uint8_t* blob;
  const int64_t* offs;
  const int64_t* lens;
  uint8_t* out;
  int64_t h, w, c;
};

int decode_one_mem(int64_t i, void* vctx) {
  auto* ctx = static_cast<MemDecodeCtx*>(vctx);
  return decode_png_mem(ctx->blob + ctx->offs[i], size_t(ctx->lens[i]),
                        ctx->out + i * ctx->h * ctx->w * ctx->c, ctx->h, ctx->w, ctx->c);
}

int probe(const uint8_t* buf, size_t n, int64_t* h, int64_t* w, int64_t* c) {
  Png png;
  if (!parse(buf, n, &png, true)) return 1;
  *h = png.h;
  *w = png.w;
  *c = probe_channels(png.color);
  return 0;
}

}  // namespace

extern "C" {

// Write n HxWxC uint8 images (contiguous; C in 1..4) to paths[]. Returns the
// number of failed images (0 = all written).
int dpm_png_write_batch(const uint8_t* data, int64_t n, int64_t h, int64_t w, int64_t c,
                        const char** paths, int threads) {
  PngWriteCtx ctx{data, h, w, c, paths};
  return dpmio::parallel_for(n, threads, write_one_png, &ctx);
}

// A PNG file's dimensions from its header. Returns 0 on success.
int dpm_png_probe(const char* path, int64_t* h, int64_t* w, int64_t* c) {
  std::vector<uint8_t> head;
  if (!read_file(path, &head, 33)) return 1;  // signature + IHDR
  return probe(head.data(), head.size(), h, w, c);
}

// Decode n PNGs (all HxW; C channels after normalization) into out. Returns
// the number of failures.
int dpm_png_read_batch(const char** paths, int64_t n, uint8_t* out, int64_t h, int64_t w,
                       int64_t c, int threads) {
  PngReadCtx ctx{paths, out, h, w, c};
  return dpmio::parallel_for(n, threads, read_one_png, &ctx);
}

// An in-memory PNG's dimensions. Returns 0 on success.
int dpm_png_probe_mem(const uint8_t* buf, int64_t n, int64_t* h, int64_t* w, int64_t* c) {
  return probe(buf, size_t(n), h, w, c);
}

// Decode n in-memory PNGs (at blob+offs[i], lens[i] bytes each; all HxW, C
// channels after normalization) into out. Returns the number of failures.
int dpm_png_decode_mem_batch(const uint8_t* blob, const int64_t* offs, const int64_t* lens,
                             int64_t n, uint8_t* out, int64_t h, int64_t w, int64_t c,
                             int threads) {
  MemDecodeCtx ctx{blob, offs, lens, out, h, w, c};
  return dpmio::parallel_for(n, threads, decode_one_mem, &ctx);
}

}  // extern "C"
