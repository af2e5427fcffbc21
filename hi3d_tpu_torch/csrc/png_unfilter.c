/* Undo the five PNG scanline filters (None, Sub, Up, Average, Paeth) of a
 * decompressed, non-interlaced image: the host-side hot loop of
 * hi3d_tpu_torch/utils/png.py. Average and Paeth predict each byte from the
 * one bpp bytes to its left, so a row is sequential; here it runs as C rather
 * than one Python step a byte. Built with the host C compiler at first use
 * (`cc -O3 -shared -fPIC`) and bound with ctypes.
 *
 * raw: h rows of 1 + stride bytes (filter type, then the filtered row);
 * out: h rows of stride bytes. Returns 0, or 1 + the index of the first row
 * whose filter type is unknown. */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  return (uint8_t)(pb <= pc ? b : c);
}

int hi3d_png_unfilter(const uint8_t* raw, uint8_t* out, int h, long stride, int bpp) {
  for (int y = 0; y < h; ++y) {
    const uint8_t* line = raw + (long)y * (stride + 1) + 1;
    uint8_t* cur = out + (long)y * stride;
    const uint8_t* up = y > 0 ? cur - stride : NULL;  /* the row above, unfiltered */
    const long lead = bpp < stride ? bpp : stride;    /* bytes with no left neighbour */
    long x;
    switch (line[-1]) {
      case 0:
        memcpy(cur, line, (size_t)stride);
        break;
      case 1:
        memcpy(cur, line, (size_t)lead);
        for (x = lead; x < stride; ++x) cur[x] = (uint8_t)(line[x] + cur[x - bpp]);
        break;
      case 2:
        if (up)
          for (x = 0; x < stride; ++x) cur[x] = (uint8_t)(line[x] + up[x]);
        else
          memcpy(cur, line, (size_t)stride);
        break;
      case 3:
        for (x = 0; x < lead; ++x) cur[x] = (uint8_t)(line[x] + (up ? up[x] >> 1 : 0));
        for (x = lead; x < stride; ++x)
          cur[x] = (uint8_t)(line[x] + ((cur[x - bpp] + (up ? up[x] : 0)) >> 1));
        break;
      case 4:
        for (x = 0; x < lead; ++x) cur[x] = (uint8_t)(line[x] + (up ? up[x] : 0));
        for (x = lead; x < stride; ++x)
          cur[x] = (uint8_t)(line[x] + (up ? paeth(cur[x - bpp], up[x], up[x - bpp])
                                           : cur[x - bpp]));
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}
