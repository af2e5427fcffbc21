/* The byte loops of the port's BMP, TIFF and GIF readers
 * (hi3d_tpu_torch/utils/{bmp,tiff,gif}.py), which parse the headers
 * and check every size that comes from the file before calling in here.
 * Built with the host C compiler at first use (`cc -O3 -shared -fPIC`, by
 * utils/cbuild.py) and bound with ctypes (utils/raster.py). Every entry
 * point checks its arguments again and never reads or writes past the
 * buffers it is given.
 *
 * long hi3d_gif_lzw(src, n, min_code_size, out, npix)
 *   GIF's LZW (LSB-first codes of min_code_size + 1 to 12 bits, clear and
 *   end codes) of the image's joined data sub-blocks into npix indices.
 *   A full table (4096 entries) is kept until a clear code (a "deferred
 *   clear"). Stops at the end code or at the end of the data; returns the
 *   indices written. -2: a code the table does not hold; -4:
 *   more indices than npix.
 * long hi3d_tiff_lzw(src, n, out, occ)
 *   TIFF's LZW as libtiff's LZWDecode reads a strip or tile: MSB-first
 *   9-12 bit codes with the early change, or, when the data start 0x00 and
 *   then a byte with its low bit set, the old LSB-first form
 *   (LZWDecodeCompat, no early change). Stops at the end code or at the
 *   end of the data; output past occ bytes is dropped as libtiff drops it.
 *   Returns the bytes written (at most occ); -2 for a corrupt code.
 * long hi3d_packbits(src, n, out, occ)
 *   libtiff's PackBitsDecode of a strip or tile: runs past occ are cut,
 *   a run whose data are missing ends the decode. Returns the bytes
 *   written.
 * void hi3d_tiff_predict8(buf, rows, row_bytes, stride)
 *   Undoes TIFF's horizontal predictor (predictor 2) at 8 bits a sample:
 *   each byte adds the one `stride` bytes to its left, row by row.
 * int hi3d_bmp_rle(src, n, w, h, bits, out)
 *   BI_RLE8 (bits 8) or BI_RLE4 (bits 4) as OpenCV's BmpDecoder reads it
 *   (grfmt_bmp.cpp): encoded runs, absolute runs, end-of-line,
 *   end-of-bitmap and delta escapes; pixels an escape skips take index 0.
 *   out: h rows of w palette indices in the file's row order. Returns 0,
 *   -1 when the data end first, -3 for a run past the end of its row, -7
 *   for an RLE4 end of bitmap before the last row or delta that moves down
 *   (escapes OpenCV's RLE4 fails on).
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define LZW_MAX 4096

/* ------------------------------------------------------------------ GIF */

long hi3d_gif_lzw(const uint8_t *src, long n, int min_code_size, uint8_t *out, long npix) {
  if (!src || n < 0 || !out || npix < 0 || min_code_size < 2 || min_code_size > 11) return -5;
  uint16_t prefix[LZW_MAX];
  uint8_t suffix[LZW_MAX], first[LZW_MAX];
  uint16_t length[LZW_MAX];
  const int clear = 1 << min_code_size, end = clear + 1;
  for (int i = 0; i < clear; ++i) {
    prefix[i] = 0;
    suffix[i] = first[i] = (uint8_t)i;
    length[i] = 1;
  }
  int width = min_code_size + 1, next = end + 1, prev = -1;
  long pos = 0, written = 0;
  uint32_t acc = 0;
  int bits = 0;
  for (;;) {
    while (bits < width && pos < n) {
      acc |= (uint32_t)src[pos++] << bits;
      bits += 8;
    }
    if (bits < width) break; /* the data end */
    const int code = (int)(acc & ((1u << width) - 1));
    acc >>= width;
    bits -= width;
    if (code == clear) {
      width = min_code_size + 1;
      next = end + 1;
      prev = -1;
      continue;
    }
    if (code == end) break;
    if (prev < 0) {
      if (code >= clear) return -2;
      if (written >= npix) return -4;
      out[written++] = (uint8_t)code;
      prev = code;
      continue;
    }
    if (code > next || (code == next && next >= LZW_MAX)) return -2;
    if (next < LZW_MAX) { /* a full table takes no more entries until a clear code */
      /* prev's string + the first index of code's (prev's own when code is new) */
      prefix[next] = (uint16_t)prev;
      first[next] = first[prev];
      suffix[next] = code < next ? first[code] : first[prev];
      length[next] = (uint16_t)(length[prev] + 1);
      ++next;
    }
    const int len = length[code];
    if (written + len > npix) return -4;
    int c = code;
    for (int i = len - 1; i >= 0; --i) {
      out[written + i] = suffix[c];
      c = prefix[c];
    }
    written += len;
    if (next == (1 << width) && width < 12) ++width;
    prev = code;
  }
  return written;
}

/* ----------------------------------------------------------------- TIFF */

long hi3d_tiff_lzw(const uint8_t *src, long n, uint8_t *out, long occ) {
  if (!src || n < 0 || !out || occ < 0) return -5;
  enum { CLEAR = 256, EOI = 257, FIRST = 258 };
  uint16_t prefix[LZW_MAX];
  uint8_t suffix[LZW_MAX], first[LZW_MAX];
  uint16_t length[LZW_MAX];
  uint8_t stack[LZW_MAX];
  for (int i = 0; i < 256; ++i) {
    prefix[i] = 0;
    suffix[i] = first[i] = (uint8_t)i;
    length[i] = 1;
  }
  const int compat = n >= 2 && src[0] == 0 && (src[1] & 1);
  int width = 9, next = FIRST, prev = -1, cleared = 0;
  long pos = 0, written = 0;
  uint32_t acc = 0;
  int bits = 0;
  for (;;) {
    int code;
    if (compat) {
      while (bits < width && pos < n) {
        acc |= (uint32_t)src[pos++] << bits;
        bits += 8;
      }
      if (bits < width) break;
      code = (int)(acc & ((1u << width) - 1));
      acc >>= width;
    } else {
      while (bits < width && pos < n) {
        acc = (acc << 8) | src[pos++];
        bits += 8;
      }
      if (bits < width) break;
      code = (int)((acc >> (bits - width)) & ((1u << width) - 1));
    }
    bits -= width;
    if (code == CLEAR) {
      if (cleared) return -2; /* libtiff reads a second clear as the byte 0 */
      width = 9;
      next = FIRST;
      prev = -1;
      cleared = 1;
      continue;
    }
    cleared = 0;
    if (code == EOI) break;
    if (prev < 0) {
      if (code > CLEAR) return -2;
      if (written < occ) out[written++] = (uint8_t)code;
      prev = code;
      continue;
    }
    if (code > next) return -2;
    if (next < LZW_MAX) { /* libtiff adds entries past 4095 too, but no code reaches them */
      prefix[next] = (uint16_t)prev;
      first[next] = first[prev];
      suffix[next] = code < next ? first[code] : first[prev];
      length[next] = (uint16_t)(length[prev] + 1);
    }
    const int len = length[code];
    int c = code;
    for (int i = len - 1; i >= 0; --i) {
      stack[i] = suffix[c];
      c = prefix[c];
    }
    for (int i = 0; i < len && written < occ; ++i) out[written++] = stack[i];
    ++next;
    if (compat) {
      if (next > (1 << width) - 1 && width < 12) ++width;
    } else if (next > (1 << width) - 2 && width < 12) {
      ++width;
    }
    prev = code;
  }
  return written;
}

long hi3d_packbits(const uint8_t *src, long n, uint8_t *out, long occ) {
  if (!src || n < 0 || !out || occ < 0) return -5;
  long pos = 0, written = 0;
  while (pos < n && written < occ) {
    long run = (int8_t)src[pos++];
    if (run == -128) continue;
    if (run < 0) {
      run = -run + 1;
      if (run > occ - written) run = occ - written;
      if (pos >= n) break;
      memset(out + written, src[pos++], (size_t)run);
      written += run;
    } else {
      run += 1;
      if (run > occ - written) run = occ - written;
      if (run > n - pos) break;
      memcpy(out + written, src + pos, (size_t)run);
      written += run;
      pos += run;
    }
  }
  return written;
}

void hi3d_tiff_predict8(uint8_t *buf, long rows, long row_bytes, int stride) {
  if (!buf || rows < 0 || row_bytes < 0 || stride < 1) return;
  for (long y = 0; y < rows; ++y) {
    uint8_t *row = buf + y * row_bytes;
    for (long x = stride; x < row_bytes; ++x) row[x] = (uint8_t)(row[x] + row[x - stride]);
  }
}

/* ------------------------------------------------------------------ BMP */

typedef struct {
  uint8_t *out;
  long w, h, x, y; /* the next pixel: column x of stored row y */
} canvas_t;

/* OpenCV's FillUniColor: `count` pixels of `value` from the current one,
 * carrying on into the next rows; a row filled to its end moves to the next
 * row (the last one ends the image). */
static void fill(canvas_t *c, long count, uint8_t value) {
  do {
    long run = c->w - c->x;
    if (run > count) run = count;
    memset(c->out + c->y * c->w + c->x, value, (size_t)run);
    c->x += run;
    count -= run;
    if (c->x >= c->w) {
      c->x = 0;
      if (++c->y >= c->h) break;
    }
  } while (count > 0);
}

int hi3d_bmp_rle(const uint8_t *src, long n, int w, int h, int bits, uint8_t *out) {
  if (!src || n < 0 || !out || w < 1 || h < 1 || (bits != 4 && bits != 8)) return -5;
  canvas_t c = {out, w, h, 0, 0};
  long pos = 0;
  int wrapped = 0; /* RLE8: the last run ended its row (an end-of-line right after is skipped) */
  for (;;) {
    if (pos + 2 > n) return -1;
    const int count = src[pos], code = src[pos + 1];
    pos += 2;
    uint8_t *row = out + c.y * c.w;
    if (count) { /* a run of count pixels */
      if (c.x + count > c.w) return -3;
      if (bits == 8) {
        const long y = c.y;
        fill(&c, count, (uint8_t)code);
        wrapped = c.y != y;
        if (c.y >= c.h) break;
      } else {
        for (int i = 0; i < count; ++i) row[c.x + i] = (uint8_t)(i & 1 ? code & 15 : code >> 4);
        c.x += count; /* a run that ends its row stays there, unlike RLE8's */
      }
    } else if (code > 2) { /* absolute: code indices, padded to a 16-bit boundary */
      if (c.x + code > c.w) return -3;
      const long size = bits == 8 ? (code + 1) & ~1 : (((code + 1) >> 1) + 1) & ~1;
      if (pos + size > n) return -1;
      for (int i = 0; i < code; ++i)
        row[c.x + i] = bits == 8 ? src[pos + i] : (uint8_t)(i & 1 ? src[pos + i / 2] & 15
                                                                   : src[pos + i / 2] >> 4);
      c.x += code;
      pos += size;
      wrapped = 0;
    } else { /* escapes: 0 end of line, 1 end of bitmap, 2 delta */
      long skip = c.w - c.x, rows = c.h - c.y;
      if (bits == 8 && !code && wrapped && skip == c.w) { /* right after a run that wrapped */
        wrapped = 0;
        continue;
      }
      if (code == 2) {
        if (pos + 2 > n) return -1;
        skip = src[pos];
        rows = src[pos + 1];
        pos += 2;
      }
      /* OpenCV's RLE4 fails on an end of bitmap before the last row and on
       * a delta that moves down; refused here too */
      if (bits == 4 && ((code == 1 && c.y != c.h - 1) || (code == 2 && rows))) return -7;
      if (code) skip += rows * c.w;
      fill(&c, skip, 0);
      wrapped = 0;
      if (c.y >= c.h) break;
    }
  }
  return 0;
}
