/* Native image IO for the KITTI input pipeline.
 *
 * The reference feeds training from PIL decodes in DataLoader worker
 * processes (mono_dataset.py:33-46, dataLoader.py:12-19). Here decode +
 * resize run as a small C library (libpng/libjpeg + a bilinear
 * resampler with the torch half-pixel convention), bound via ctypes
 * from the prefetch loader's threads (ctypes releases the GIL), with the
 * other routes of native/__init__.py beside it. A copy of the JAX
 * package's native/fastio.c: both give the same bytes.
 *
 * API (all return 0 on success, negative on error):
 *   image_dims(path, &h, &w)                 - peek dimensions
 *   decode_rgb(path, out_u8)                 - decode into H*W*3 uint8
 *   resize_bilinear(in_u8, h, w, out_f32, oh, ow)
 *                                            - uint8 HWC3 -> float32
 *                                              [0,1], half-pixel bilinear
 *   decode_resize(path, out_f32, oh, ow)     - fused decode+resize
 */

#include <setjmp.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>
#include <png.h>

/* ---------- PNG ---------- */

static int png_dims(FILE* f, int* h, int* w) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, NULL,
                                           NULL, NULL);
  if (!png) return -2;
  png_infop info = png_create_info_struct(png);
  if (!info) { png_destroy_read_struct(&png, NULL, NULL); return -2; }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, NULL);
    return -3;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  *w = (int)png_get_image_width(png, info);
  *h = (int)png_get_image_height(png, info);
  png_destroy_read_struct(&png, &info, NULL);
  return 0;
}

static int png_decode(FILE* f, uint8_t* out, int h, int w) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, NULL,
                                           NULL, NULL);
  if (!png) return -2;
  png_infop info = png_create_info_struct(png);
  if (!info) { png_destroy_read_struct(&png, NULL, NULL); return -2; }
  /* volatile so the longjmp cleanup can free a partially set pointer */
  png_bytep* volatile rows = NULL;
  if (setjmp(png_jmpbuf(png))) {
    free(rows);
    png_destroy_read_struct(&png, &info, NULL);
    return -3;
  }
  png_init_io(png, f);
  png_read_info(png, info);

  png_byte color = png_get_color_type(png, info);
  png_byte depth = png_get_bit_depth(png, info);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS))
    png_set_tRNS_to_alpha(png);
  if (color == PNG_COLOR_TYPE_GRAY ||
      color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  if (color & PNG_COLOR_MASK_ALPHA ||
      png_get_valid(png, info, PNG_INFO_tRNS))
    png_set_strip_alpha(png);
  png_read_update_info(png, info);

  size_t rowbytes = png_get_rowbytes(png, info);
  if (rowbytes != (size_t)(w * 3)) {
    /* still alpha or unexpected layout */
    png_destroy_read_struct(&png, &info, NULL);
    return -4;
  }
  rows = (png_bytep*)malloc(sizeof(png_bytep) * h);
  if (!rows) {
    png_destroy_read_struct(&png, &info, NULL);
    return -6;
  }
  for (int y = 0; y < h; y++) rows[y] = out + (size_t)y * w * 3;
  png_read_image(png, (png_bytep*)rows);
  free(rows);
  rows = NULL;
  png_destroy_read_struct(&png, &info, NULL);
  return 0;
}

/* ---------- JPEG ---------- */

struct jpg_err {
  struct jpeg_error_mgr mgr;
  jmp_buf jb;
};

static void jpg_err_exit(j_common_ptr cinfo) {
  struct jpg_err* e = (struct jpg_err*)cinfo->err;
  longjmp(e->jb, 1);
}

static int jpg_dims(FILE* f, int* h, int* w) {
  struct jpeg_decompress_struct cinfo;
  struct jpg_err jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpg_err_exit;
  if (setjmp(jerr.jb)) { jpeg_destroy_decompress(&cinfo); return -3; }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  *w = (int)cinfo.image_width;
  *h = (int)cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

static int jpg_decode(FILE* f, uint8_t* out, int h, int w) {
  struct jpeg_decompress_struct cinfo;
  struct jpg_err jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpg_err_exit;
  if (setjmp(jerr.jb)) { jpeg_destroy_decompress(&cinfo); return -3; }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if ((int)cinfo.output_width != w || (int)cinfo.output_height != h ||
      cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    return -4;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + (size_t)cinfo.output_scanline * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

/* ---------- dispatch ---------- */

static int sniff(FILE* f) { /* 0=png, 1=jpeg, -1=unknown */
  unsigned char magic[4];
  if (fread(magic, 1, 4, f) != 4) return -1;
  rewind(f);
  if (magic[0] == 0x89 && magic[1] == 'P') return 0;
  if (magic[0] == 0xFF && magic[1] == 0xD8) return 1;
  return -1;
}

int image_dims(const char* path, int* h, int* w) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int kind = sniff(f);
  int rc = kind == 0 ? png_dims(f, h, w)
           : kind == 1 ? jpg_dims(f, h, w) : -5;
  fclose(f);
  return rc;
}

/* exp_h/exp_w: the dimensions the caller allocated `out` for; decode
 * fails with -7 if the file changed since image_dims (never writes
 * beyond the caller's buffer). */
int decode_rgb(const char* path, uint8_t* out, int exp_h, int exp_w) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int h, w;
  int kind = sniff(f);
  int rc;
  if (kind == 0) {
    rc = png_dims(f, &h, &w);
    rewind(f);
    if (rc == 0 && (h != exp_h || w != exp_w)) rc = -7;
    if (rc == 0) rc = png_decode(f, out, h, w);
  } else if (kind == 1) {
    rc = jpg_dims(f, &h, &w);
    rewind(f);
    if (rc == 0 && (h != exp_h || w != exp_w)) rc = -7;
    if (rc == 0) rc = jpg_decode(f, out, h, w);
  } else {
    rc = -5;
  }
  fclose(f);
  return rc;
}

/* torch half-pixel bilinear, uint8 HWC3 -> float32 [0,1] */
int resize_bilinear(const uint8_t* in, int h, int w, float* out,
                    int oh, int ow) {
  float sy = (float)h / oh, sx = (float)w / ow;
  int* x0 = (int*)malloc(sizeof(int) * ow);
  int* x1 = (int*)malloc(sizeof(int) * ow);
  float* fx = (float*)malloc(sizeof(float) * ow);
  if (!x0 || !x1 || !fx) {
    free(x0);
    free(x1);
    free(fx);
    return -6;
  }
  for (int x = 0; x < ow; x++) {
    float s = (x + 0.5f) * sx - 0.5f;
    if (s < 0) s = 0;
    if (s > w - 1) s = (float)(w - 1);
    x0[x] = (int)s;
    x1[x] = x0[x] + 1 < w ? x0[x] + 1 : w - 1;
    fx[x] = s - x0[x];
  }
  for (int y = 0; y < oh; y++) {
    float s = (y + 0.5f) * sy - 0.5f;
    if (s < 0) s = 0;
    if (s > h - 1) s = (float)(h - 1);
    int y0 = (int)s;
    int y1 = y0 + 1 < h ? y0 + 1 : h - 1;
    float fy = s - y0;
    const uint8_t* r0 = in + (size_t)y0 * w * 3;
    const uint8_t* r1 = in + (size_t)y1 * w * 3;
    float* orow = out + (size_t)y * ow * 3;
    for (int x = 0; x < ow; x++) {
      const uint8_t* p00 = r0 + x0[x] * 3;
      const uint8_t* p01 = r0 + x1[x] * 3;
      const uint8_t* p10 = r1 + x0[x] * 3;
      const uint8_t* p11 = r1 + x1[x] * 3;
      float wx = fx[x];
      for (int c = 0; c < 3; c++) {
        float top = p00[c] + (p01[c] - p00[c]) * wx;
        float bot = p10[c] + (p11[c] - p10[c]) * wx;
        orow[x * 3 + c] = (top + (bot - top) * fy) * (1.0f / 255.0f);
      }
    }
  }
  free(x0);
  free(x1);
  free(fx);
  return 0;
}

int decode_resize(const char* path, float* out, int oh, int ow) {
  int h, w;
  int rc = image_dims(path, &h, &w);
  if (rc != 0) return rc;
  uint8_t* buf = (uint8_t*)malloc((size_t)h * w * 3);
  if (!buf) return -6;
  rc = decode_rgb(path, buf, h, w);
  if (rc == 0) rc = resize_bilinear(buf, h, w, out, oh, ow);
  free(buf);
  return rc;
}
