// JPEG decoder of the host-IO runtime of dpm_solver_tpu_torch, on libjpeg.
//
// Encoded-image datasets (prepared TFDS records, image folders, LSUN's
// LMDB values) carry JPEG payloads; the reference decodes them with
// tf.image.decode_image (score_sde_jax/datasets.py:139). This is the JAX
// package's libjpeg decoder (its io.cpp), in a library of its own so that a
// machine without jpeglib.h still builds the core and the PNG codec: there
// only the JPEG calls raise, with g++'s message naming the missing header.
//
// Entries (extern "C", no global state, a thread pool per batch call):
// dpm_jpeg_probe_mem, dpm_jpeg_decode_mem_batch. Build: native/build.py
// (g++ -O2 -shared -ljpeg).

#include <csetjmp>
#include <cstdint>
#include <cstdio>

#include <jpeglib.h>

#include "parallel.h"

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  std::jmp_buf jmp;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  std::longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jmp, 1);
}

bool is_jpeg(const uint8_t* p, size_t n) { return n >= 2 && p[0] == 0xFF && p[1] == 0xD8; }

int decode_jpeg_mem(const uint8_t* buf, size_t n, uint8_t* out, int64_t h, int64_t w,
                    int64_t c) {
  if ((c != 1 && c != 3) || !is_jpeg(buf, n)) return 1;  // libjpeg emits GRAY or RGB
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  if (setjmp(err.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf), n);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = (c == 1) ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (cinfo.output_width != static_cast<JDIMENSION>(w) ||
      cinfo.output_height != static_cast<JDIMENSION>(h) || cinfo.output_components != c) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + int64_t(cinfo.output_scanline) * w * c;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
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
  return decode_jpeg_mem(ctx->blob + ctx->offs[i], static_cast<size_t>(ctx->lens[i]),
                         ctx->out + i * ctx->h * ctx->w * ctx->c, ctx->h, ctx->w, ctx->c);
}

}  // namespace

extern "C" {

// An in-memory JPEG's dimensions and components. Returns 0 on success.
int dpm_jpeg_probe_mem(const uint8_t* buf, int64_t n, int64_t* h, int64_t* w, int64_t* c) {
  size_t sn = static_cast<size_t>(n);
  if (!is_jpeg(buf, sn)) return 1;
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  if (setjmp(err.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf), static_cast<unsigned long>(sn));
  jpeg_read_header(&cinfo, TRUE);
  *h = cinfo.image_height;
  *w = cinfo.image_width;
  *c = cinfo.num_components;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode n in-memory JPEGs (at blob+offs[i], lens[i] bytes each; all HxW, C
// in {1, 3}) into out. Returns the number of failures.
int dpm_jpeg_decode_mem_batch(const uint8_t* blob, const int64_t* offs, const int64_t* lens,
                              int64_t n, uint8_t* out, int64_t h, int64_t w, int64_t c,
                              int threads) {
  MemDecodeCtx ctx{blob, offs, lens, out, h, w, c};
  return dpmio::parallel_for(n, threads, decode_one_mem, &ctx);
}

}  // extern "C"
