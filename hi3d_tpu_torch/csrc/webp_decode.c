/* WebP decoding for hi3d_tpu_torch/utils/webp.py, which parses the RIFF
 * container: the lossless (VP8L) format, for images and for the alpha
 * planes of ALPH chunks, the alpha planes' unfiltering, and lossy (VP8) key
 * frames with libwebp's fancy upsampling and 14-bit fixed-point YUV→RGB, so
 * that the RGB(A) is what cv2 gets from libwebp (WebPDecodeBGRInto and
 * WebPDecodeBGRAInto), byte for byte.
 *
 * Built at first use with the host C compiler (`cc -O3 -shared -fPIC`) into
 * build/host/ and loaded with ctypes; plain C, no library.
 *
 * hi3d_webp_lossless(data, size, headerless, width, height, argb)
 *   a VP8L bitstream (its 5-byte header first unless `headerless`, as in an
 *   ALPH chunk) → width × height ARGB words; the transforms (predictor with
 *   its 14 modes, cross-colour, subtract-green, colour indexing with pixel
 *   bundling), the colour cache, LZ77 references with the 120-entry
 *   distance map and meta prefix codes, as the WebP lossless specification
 *   and libwebp's vp8l_dec.c decode them.
 * hi3d_webp_unfilter_alpha(plane, width, height, method)
 *   undoes an alpha plane's horizontal (1), vertical (2) or gradient (3)
 *   filter in place.
 * hi3d_webp_lossy(data, size, width, height, out, channels)
 *   a VP8 key frame (RFC 6386: the boolean decoder, segment and filter
 *   headers, token partitions, coefficient probabilities and their updates,
 *   16×16, 4×4 and chroma intra prediction, the inverse WHT and DCT, the
 *   normal and simple loop filters) → RGB or RGBA (alpha 255) rows, decoded
 *   one macroblock row at a time as libwebp's frame_dec.c does.
 * Each returns 0 or a negative error code (see webp.py's _ERRORS). The
 * sizes are checked here again (ERR_ARGS), so no read or write leaves its
 * buffer whatever the data hold: every read past the end of the data gives
 * zeros and ends in ERR_TRUNCATED, except on libwebp's 8-bit alpha path,
 * whose last code may read past the end (decode_pixels).
 *
 * The probability and quantiser tables are those of RFC 6386 (section 13.5
 * default_coeff_probs and coeff_update_probs; 14.1 dc_qlookup and
 * ac_qlookup; 11.5 the key-frame sub-block mode contexts, in the mode order
 * of libwebp: DC, TM, VE, HE, RD, VR, LD, VL, HD, HU), and the distance map
 * of the WebP lossless specification (section 4.2.2).
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static const uint8_t kCoeffsProba0[1056] = {
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
  189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
  106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
  1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
  181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
  78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
  1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
  184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
  77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
  1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
  170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
  37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
  1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
  207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
  102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
  1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
  177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
  80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
  1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
  131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
  68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
  1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
  184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
  81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
  1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
  99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
  23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
  1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
  109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
  44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
  1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
  94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
  22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
  1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
  124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
  35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
  1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
  121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
  45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
  1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
  203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
  137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
  253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
  175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
  73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
  1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
  239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
  155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
  1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
  201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
  69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
  1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
  223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
  141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
  1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
  190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
  149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
  213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
  55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
  126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
  61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
  1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
  166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
  39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
  1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
  124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
  24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
  1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
  149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
  28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
  1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
  123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
  20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
  1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
  168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
  47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
  1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
  141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
  42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
  1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
static const uint8_t kCoeffsUpdateProba[1056] = {
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
  249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
  234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
  250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
  234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
  255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
  255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
  234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
  251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
  255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
  255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
  248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
  255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
  248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
  255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
static const uint8_t kBModesProba[900] = {
  231, 120, 48, 89, 115, 113, 120, 152, 112,
  152, 179, 64, 126, 170, 118, 46, 70, 95,
  175, 69, 143, 80, 85, 82, 72, 155, 103,
  56, 58, 10, 171, 218, 189, 17, 13, 152,
  114, 26, 17, 163, 44, 195, 21, 10, 173,
  121, 24, 80, 195, 26, 62, 44, 64, 85,
  144, 71, 10, 38, 171, 213, 144, 34, 26,
  170, 46, 55, 19, 136, 160, 33, 206, 71,
  63, 20, 8, 114, 114, 208, 12, 9, 226,
  81, 40, 11, 96, 182, 84, 29, 16, 36,
  134, 183, 89, 137, 98, 101, 106, 165, 148,
  72, 187, 100, 130, 157, 111, 32, 75, 80,
  66, 102, 167, 99, 74, 62, 40, 234, 128,
  41, 53, 9, 178, 241, 141, 26, 8, 107,
  74, 43, 26, 146, 73, 166, 49, 23, 157,
  65, 38, 105, 160, 51, 52, 31, 115, 128,
  104, 79, 12, 27, 217, 255, 87, 17, 7,
  87, 68, 71, 44, 114, 51, 15, 186, 23,
  47, 41, 14, 110, 182, 183, 21, 17, 194,
  66, 45, 25, 102, 197, 189, 23, 18, 22,
  88, 88, 147, 150, 42, 46, 45, 196, 205,
  43, 97, 183, 117, 85, 38, 35, 179, 61,
  39, 53, 200, 87, 26, 21, 43, 232, 171,
  56, 34, 51, 104, 114, 102, 29, 93, 77,
  39, 28, 85, 171, 58, 165, 90, 98, 64,
  34, 22, 116, 206, 23, 34, 43, 166, 73,
  107, 54, 32, 26, 51, 1, 81, 43, 31,
  68, 25, 106, 22, 64, 171, 36, 225, 114,
  34, 19, 21, 102, 132, 188, 16, 76, 124,
  62, 18, 78, 95, 85, 57, 50, 48, 51,
  193, 101, 35, 159, 215, 111, 89, 46, 111,
  60, 148, 31, 172, 219, 228, 21, 18, 111,
  112, 113, 77, 85, 179, 255, 38, 120, 114,
  40, 42, 1, 196, 245, 209, 10, 25, 109,
  88, 43, 29, 140, 166, 213, 37, 43, 154,
  61, 63, 30, 155, 67, 45, 68, 1, 209,
  100, 80, 8, 43, 154, 1, 51, 26, 71,
  142, 78, 78, 16, 255, 128, 34, 197, 171,
  41, 40, 5, 102, 211, 183, 4, 1, 221,
  51, 50, 17, 168, 209, 192, 23, 25, 82,
  138, 31, 36, 171, 27, 166, 38, 44, 229,
  67, 87, 58, 169, 82, 115, 26, 59, 179,
  63, 59, 90, 180, 59, 166, 93, 73, 154,
  40, 40, 21, 116, 143, 209, 34, 39, 175,
  47, 15, 16, 183, 34, 223, 49, 45, 183,
  46, 17, 33, 183, 6, 98, 15, 32, 183,
  57, 46, 22, 24, 128, 1, 54, 17, 37,
  65, 32, 73, 115, 28, 128, 23, 128, 205,
  40, 3, 9, 115, 51, 192, 18, 6, 223,
  87, 37, 9, 115, 59, 77, 64, 21, 47,
  104, 55, 44, 218, 9, 54, 53, 130, 226,
  64, 90, 70, 205, 40, 41, 23, 26, 57,
  54, 57, 112, 184, 5, 41, 38, 166, 213,
  30, 34, 26, 133, 152, 116, 10, 32, 134,
  39, 19, 53, 221, 26, 114, 32, 73, 255,
  31, 9, 65, 234, 2, 15, 1, 118, 73,
  75, 32, 12, 51, 192, 255, 160, 43, 51,
  88, 31, 35, 67, 102, 85, 55, 186, 85,
  56, 21, 23, 111, 59, 205, 45, 37, 192,
  55, 38, 70, 124, 73, 102, 1, 34, 98,
  125, 98, 42, 88, 104, 85, 117, 175, 82,
  95, 84, 53, 89, 128, 100, 113, 101, 45,
  75, 79, 123, 47, 51, 128, 81, 171, 1,
  57, 17, 5, 71, 102, 57, 53, 41, 49,
  38, 33, 13, 121, 57, 73, 26, 1, 85,
  41, 10, 67, 138, 77, 110, 90, 47, 114,
  115, 21, 2, 10, 102, 255, 166, 23, 6,
  101, 29, 16, 10, 85, 128, 101, 196, 26,
  57, 18, 10, 102, 102, 213, 34, 20, 43,
  117, 20, 15, 36, 163, 128, 68, 1, 26,
  102, 61, 71, 37, 34, 53, 31, 243, 192,
  69, 60, 71, 38, 73, 119, 28, 222, 37,
  68, 45, 128, 34, 1, 47, 11, 245, 171,
  62, 17, 19, 70, 146, 85, 55, 62, 70,
  37, 43, 37, 154, 100, 163, 85, 160, 1,
  63, 9, 92, 136, 28, 64, 32, 201, 85,
  75, 15, 9, 9, 64, 255, 184, 119, 16,
  86, 6, 28, 5, 64, 255, 25, 248, 1,
  56, 8, 17, 132, 137, 255, 55, 116, 128,
  58, 15, 20, 82, 135, 57, 26, 121, 40,
  164, 50, 31, 137, 154, 133, 25, 35, 218,
  51, 103, 44, 131, 131, 123, 31, 6, 158,
  86, 40, 64, 135, 148, 224, 45, 183, 128,
  22, 26, 17, 131, 240, 154, 14, 1, 209,
  45, 16, 21, 91, 64, 222, 7, 1, 197,
  56, 21, 39, 155, 60, 138, 23, 102, 213,
  83, 12, 13, 54, 192, 255, 68, 47, 28,
  85, 26, 85, 85, 128, 128, 32, 146, 171,
  18, 11, 7, 63, 144, 171, 4, 4, 246,
  35, 27, 10, 146, 174, 171, 12, 26, 128,
  190, 80, 35, 99, 180, 80, 126, 54, 45,
  85, 126, 47, 87, 176, 51, 41, 20, 32,
  101, 75, 128, 139, 118, 146, 116, 128, 85,
  56, 41, 15, 176, 236, 85, 37, 9, 62,
  71, 30, 17, 119, 118, 255, 17, 18, 138,
  101, 38, 60, 138, 55, 70, 43, 26, 142,
  146, 36, 19, 30, 171, 255, 97, 27, 20,
  138, 45, 61, 62, 219, 1, 81, 188, 64,
  32, 41, 20, 117, 151, 142, 20, 21, 163,
  112, 19, 12, 61, 195, 128, 48, 4, 24,
};
static const uint8_t kDcTable[128] = {
  4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
  18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
  29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
  44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
  59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
  75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
  91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
  122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
static const uint16_t kAcTable[128] = {
  4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
  20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
  36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
  52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
  78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
  110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
  155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
  213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};
static const uint8_t kCodeToPlane[120] = {
  24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42,
  56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4,
  71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69,
  75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
  68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
  102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
  120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78,
  118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
  0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
  81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};

/* ------------------------------------------------------------ errors */

#define ERR_TRUNCATED -1  /* the data ends before the image does */
#define ERR_BITSTREAM -2  /* a code, size or value the format does not allow */
#define ERR_MEMORY -3     /* an allocation failed */
#define ERR_ARGS -4       /* a size or mode outside what the caller may pass */

/* ============================================== VP8L (lossless) decoder */

#define NUM_LITERAL_CODES 256
#define NUM_LENGTH_CODES 24
#define NUM_DISTANCE_CODES 40
#define MAX_CACHE_BITS 11
#define MAX_CODE_LENGTH 15
#define MAX_ALPHABET (NUM_LITERAL_CODES + NUM_LENGTH_CODES + (1 << MAX_CACHE_BITS))
#define LUT_BITS 8

static const uint8_t kCodeLengthCodeOrder[19] = {
    17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};
static const int kAlphabetSize[5] = {
    NUM_LITERAL_CODES + NUM_LENGTH_CODES, NUM_LITERAL_CODES, NUM_LITERAL_CODES,
    NUM_LITERAL_CODES, NUM_DISTANCE_CODES};

typedef struct {  /* LSB-first bit reader */
    const uint8_t *buf;
    long size, pos;  /* bytes; pos: the next byte to load */
    uint64_t val;    /* bits not yet consumed, the next one lowest */
    int nbits;
    long consumed;   /* bits consumed, for the end-of-stream check */
} lbits_t;

static void lfill(lbits_t *br) {
    while (br->nbits <= 56) {
        uint64_t byte = br->pos < br->size ? br->buf[br->pos] : 0;
        br->pos++;
        br->val |= byte << br->nbits;
        br->nbits += 8;
    }
}

static inline uint32_t lread(lbits_t *br, int n) {  /* n <= 32 */
    if (n == 0) return 0;
    if (br->nbits < n) lfill(br);
    uint32_t v = (uint32_t)(br->val & ((((uint64_t)1) << n) - 1));
    br->val >>= n;
    br->nbits -= n;
    br->consumed += n;
    return v;
}

static inline int leos(const lbits_t *br) { return br->consumed > 8 * br->size; }

typedef struct {  /* a canonical prefix code */
    int single;              /* its one symbol, read with no bits; -1 if none */
    int count[MAX_CODE_LENGTH + 1], first[MAX_CODE_LENGTH + 1], offset[MAX_CODE_LENGTH + 1];
    uint16_t lut[1 << LUT_BITS];  /* the next LUT_BITS bits → symbol | length << 12 */
    uint16_t *sorted;        /* symbols in code order */
} hcode_t;

/* Build a code from its lengths; 0 if it is empty, over-subscribed or
 * incomplete (one symbol alone is a code of zero bits). */
static int build_code(hcode_t *h, const int *lengths, int n, uint16_t *sorted) {
    int total = 0, last = -1;
    memset(h->count, 0, sizeof h->count);
    for (int s = 0; s < n; s++) {
        if (lengths[s] < 0 || lengths[s] > MAX_CODE_LENGTH) return 0;
        if (lengths[s]) { h->count[lengths[s]]++; total++; last = s; }
    }
    h->sorted = sorted;
    if (total == 0) return 0;
    if (total == 1) { h->single = last; return 1; }
    h->single = -1;
    long kraft = 0;
    for (int l = 1; l <= MAX_CODE_LENGTH; l++) kraft += (long)h->count[l] << (MAX_CODE_LENGTH - l);
    if (kraft != (1L << MAX_CODE_LENGTH)) return 0;
    int code = 0, off = 0;
    for (int l = 1; l <= MAX_CODE_LENGTH; l++) {
        code = (code + (l > 1 ? h->count[l - 1] : 0)) << (l > 1 ? 1 : 0);
        h->first[l] = code;
        h->offset[l] = off;
        off += h->count[l];
    }
    int next[MAX_CODE_LENGTH + 1];
    memcpy(next, h->offset, sizeof next);
    for (int s = 0; s < n; s++)
        if (lengths[s]) sorted[next[lengths[s]]++] = (uint16_t)s;
    for (int i = 0; i < (1 << LUT_BITS); i++) h->lut[i] = 0xFFFF;
    for (int l = 1; l <= LUT_BITS; l++) {
        for (int i = 0; i < h->count[l]; i++) {
            int c = h->first[l] + i, rev = 0;
            for (int b = 0; b < l; b++) rev |= ((c >> b) & 1) << (l - 1 - b);
            for (int idx = rev; idx < (1 << LUT_BITS); idx += 1 << l)
                h->lut[idx] = (uint16_t)(sorted[h->offset[l] + i] | (l << 12));
        }
    }
    return 1;
}

static inline int read_symbol(lbits_t *br, const hcode_t *h) {
    if (h->single >= 0) return h->single;
    if (br->nbits < MAX_CODE_LENGTH) lfill(br);
    uint16_t e = h->lut[br->val & ((1 << LUT_BITS) - 1)];
    if (e != 0xFFFF) {
        lread(br, e >> 12);
        return e & 0xFFF;
    }
    int code = 0;
    for (int l = 1; l <= MAX_CODE_LENGTH; l++) {
        code = (code << 1) | (int)lread(br, 1);
        int d = code - h->first[l];
        if (d >= 0 && d < h->count[l]) return h->sorted[h->offset[l] + d];
    }
    return -1;  /* unreachable for a complete code */
}

/* ReadHuffmanCodeLengths: the lengths of a code, themselves prefix-coded. */
static int read_code_lengths(lbits_t *br, const int *cl_lengths, int n, int *lengths) {
    hcode_t h;
    uint16_t sorted[19];
    if (!build_code(&h, cl_lengths, 19, sorted)) return ERR_BITSTREAM;
    int max_symbol = n, prev = 8;
    if (lread(br, 1)) {
        int length_nbits = 2 + 2 * (int)lread(br, 3);
        max_symbol = 2 + (int)lread(br, length_nbits);
        if (max_symbol > n) return ERR_BITSTREAM;
    }
    for (int s = 0; s < n;) {
        if (max_symbol-- == 0) break;
        if (leos(br)) return ERR_TRUNCATED;
        int len = read_symbol(br, &h);
        if (len < 16) {
            lengths[s++] = len;
            if (len) prev = len;
        } else {
            static const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
            int repeat = (int)lread(br, extra[len - 16]) + offset[len - 16];
            if (s + repeat > n) return ERR_BITSTREAM;
            int v = len == 16 ? prev : 0;
            while (repeat-- > 0) lengths[s++] = v;
        }
    }
    return 0;
}

/* ReadHuffmanCode: one code of an alphabet of n symbols. */
static int read_code(lbits_t *br, int n, hcode_t *h, uint16_t *sorted, int *lengths) {
    memset(lengths, 0, sizeof(int) * n);
    if (lread(br, 1)) {  /* simple: one or two symbols of length 1 */
        int num = (int)lread(br, 1) + 1;
        int s = (int)lread(br, lread(br, 1) ? 8 : 1);
        if (s < n) lengths[s] = 1;
        if (num == 2) {
            s = (int)lread(br, 8);
            if (s < n) lengths[s] = 1;
        }
    } else {
        int cl[19] = {0};
        int num = (int)lread(br, 4) + 4;
        for (int i = 0; i < num; i++) cl[kCodeLengthCodeOrder[i]] = (int)lread(br, 3);
        int err = read_code_lengths(br, cl, n, lengths);
        if (err) return err;
    }
    if (leos(br)) return ERR_TRUNCATED;
    return build_code(h, lengths, n, sorted) ? 0 : ERR_BITSTREAM;
}

typedef struct { hcode_t codes[5]; } group_t;

typedef struct {
    int type, bits, xsize;  /* xsize: the width of the image it applies to */
    uint32_t *data;
} transform_t;

typedef struct {
    lbits_t br;
    transform_t transforms[4];
    int ntransforms, seen;
    int alpha;  /* the headerless stream of an ALPH chunk */
} vp8l_t;

static inline uint32_t subsample(uint32_t size, int bits) {
    return (size + (1u << bits) - 1) >> bits;
}

static int plane_distance(int xsize, int code) {
    if (code > 120) return code - 120;
    int dist_code = kCodeToPlane[code - 1];
    int yoffset = dist_code >> 4, xoffset = 8 - (dist_code & 0xf);
    int dist = yoffset * xsize + xoffset;
    return dist >= 1 ? dist : 1;
}

static inline int prefix_value(lbits_t *br, int symbol) {  /* GetCopyDistance/Length */
    if (symbol < 4) return symbol + 1;
    int extra = (symbol - 2) >> 1;
    int offset = (2 + (symbol & 1)) << extra;
    return offset + (int)lread(br, extra) + 1;
}

/* DecodeImageStream: an entropy-coded image of xsize × ysize pixels into
 * `out` (allocated here). Level 0 (the main image) first reads the
 * transforms, which change the coded width, and may use meta prefix codes. */
static int decode_stream(vp8l_t *d, int xsize, int ysize, int level0, uint32_t **out,
                         int *coded_xsize);

static int read_transform(vp8l_t *d, int *xsize, int ysize) {
    lbits_t *br = &d->br;
    int type = (int)lread(br, 2);
    if (d->seen & (1 << type)) return ERR_BITSTREAM;  /* each type at most once */
    d->seen |= 1 << type;
    transform_t *t = &d->transforms[d->ntransforms++];
    t->type = type;
    t->xsize = *xsize;
    t->data = NULL;
    t->bits = 0;
    if (type == 0 || type == 1) {  /* predictor, cross-colour */
        t->bits = (int)lread(br, 3) + 2;
        return decode_stream(d, (int)subsample(*xsize, t->bits), (int)subsample(ysize, t->bits),
                             0, &t->data, NULL);
    }
    if (type == 3) {  /* colour indexing */
        int num = (int)lread(br, 8) + 1;
        t->bits = num > 16 ? 0 : num > 4 ? 1 : num > 2 ? 2 : 3;
        *xsize = (int)subsample(*xsize, t->bits);
        uint32_t *pal = NULL;
        int err = decode_stream(d, num, 1, 0, &pal, NULL);
        if (err) return err;
        /* ExpandColorMap: deltas added byte by byte, the rest transparent black */
        t->data = (uint32_t *)calloc(256, sizeof(uint32_t));
        if (!t->data) { free(pal); return ERR_MEMORY; }
        uint8_t *src = (uint8_t *)pal, *dst = (uint8_t *)t->data;
        for (int i = 0; i < 4; i++) dst[i] = src[i];
        for (int i = 4; i < 4 * num; i++) dst[i] = (uint8_t)(src[i] + dst[i - 4]);
        free(pal);
    }
    return 0;
}

/* libwebp's VP8LBitReader near the end of the data, where the 8-bit alpha
 * path (below) can read past the end and still succeed: a read at bit
 * position p takes (uint32)(val_ >> (bit_pos_ & 63)) of a 64-bit window
 * that holds the last 8 bytes once all are loaded, so bits past the end
 * read as zeros while the read starts inside the window and as the
 * window's own bits again from its start once it starts past it; the end
 * of the data, when a check finds a bit read past it, restarts bit_pos_ at
 * 0 (VP8LSetEndOfStream). Reads inside the data are the data's bits. */
typedef struct {
    uint64_t w;  /* the window: the last 8 bytes (fewer: all, zero-padded) */
    long base;   /* the bit of the data at the window's bit 0 */
    int eos, bit;  /* the end found, and bit_pos_ since */
} ltail_t;

static void tail_init(ltail_t *t, const lbits_t *br) {
    long n = br->size < 8 ? br->size : 8;
    t->w = 0;
    for (long i = 0; i < n; i++) t->w |= (uint64_t)br->buf[br->size - n + i] << (8 * i);
    t->base = 8 * (br->size - n);
    t->eos = t->bit = 0;
}

static uint32_t tail_peek(const lbits_t *br, const ltail_t *t) {  /* VP8LPrefetchBits */
    if (t->eos) return (uint32_t)(t->w >> (t->bit & 63));
    long p = br->consumed;
    if (p >= t->base) return (uint32_t)(t->w >> ((p - t->base) & 63));
    uint32_t v = 0;  /* 32 bits inside the data, before the window */
    for (int i = 0; i < 32; i++)
        v |= (uint32_t)((br->buf[(p + i) >> 3] >> ((p + i) & 7)) & 1) << i;
    return v;
}

static void tail_advance(lbits_t *br, ltail_t *t, int n) {  /* VP8LSetBitPos */
    if (t->eos) t->bit += n;
    else br->consumed += n;
}

static void tail_check(lbits_t *br, ltail_t *t, int at_least) {  /* ShiftBytes' end check */
    if (t->eos ? t->bit >= at_least : br->consumed > 8 * br->size) {
        t->eos = 1;
        t->bit = 0;
    }
}

static uint32_t tail_bits(lbits_t *br, ltail_t *t, int n) {  /* VP8LReadBits, n <= 24 */
    if (t->eos) {
        t->bit = 0;
        return 0;
    }
    uint32_t v = tail_peek(br, t) & ((1u << n) - 1);
    br->consumed += n;
    tail_check(br, t, 0);
    return v;
}

/* ReadSymbol: the root table's 8 bits, then a second prefetch for the rest
 * of a longer code. */
static int tail_symbol(lbits_t *br, ltail_t *t, const hcode_t *h) {
    if (h->single >= 0) return h->single;
    uint32_t v = tail_peek(br, t);
    uint16_t e = h->lut[v & ((1 << LUT_BITS) - 1)];
    if (e != 0xFFFF) {
        tail_advance(br, t, e >> 12);
        return e & 0xFFF;
    }
    tail_advance(br, t, LUT_BITS);
    uint64_t bits = (v & ((1 << LUT_BITS) - 1)) | (uint64_t)tail_peek(br, t) << LUT_BITS;
    int code = 0;
    for (int l = 1; l <= MAX_CODE_LENGTH; l++) {
        code = (code << 1) | (int)((bits >> (l - 1)) & 1);
        int d = code - h->first[l];
        if (d >= 0 && d < h->count[l]) {
            tail_advance(br, t, l - LUT_BITS);
            return h->sorted[h->offset[l] + d];
        }
    }
    return -1;
}

static int tail_prefix(lbits_t *br, ltail_t *t, int symbol) {  /* GetCopyDistance */
    if (symbol < 4) return symbol + 1;
    int extra = (symbol - 2) >> 1;
    return ((2 + (symbol & 1)) << extra) + (int)tail_bits(br, t, extra) + 1;
}

/* With `eight_bit` the image is decoded as libwebp's DecodeAlphaData
 * decodes an alpha plane of palette indices (its 8-bit path): the end of the
 * data counts only when it comes before the last pixel, so a stream whose
 * last code reads past its end still decodes, and the last 256 bits are read
 * through libwebp's reader (`tail_*`), which is what that code reads. */
static int decode_pixels(vp8l_t *d, uint32_t *data, int width, int height, int cache_bits,
                         const group_t *groups, const uint32_t *meta, int meta_bits,
                         int eight_bit) {
    lbits_t *br = &d->br;
    uint32_t cache[1 << MAX_CACHE_BITS];
    long total = (long)width * height, pos = 0, last_cached = 0;
    int col = 0, row = 0;
    int mask = meta_bits ? (1 << meta_bits) - 1 : -1;
    int meta_w = meta_bits ? (int)subsample(width, meta_bits) : 0;
    const group_t *g = groups;
    if (cache_bits) memset(cache, 0, sizeof(uint32_t) << cache_bits);
#define GROUP_AT(c, r) (meta ? &groups[meta[((r) >> meta_bits) * meta_w + ((c) >> meta_bits)]] \
                             : groups)
    ltail_t tail;
    int in_tail = 0;
    while (pos < total) {
        if ((col & mask) == 0) g = GROUP_AT(col, row);
        if (eight_bit && !in_tail && 8 * br->size - br->consumed < 256) {
            tail_init(&tail, br);
            in_tail = 1;
        }
        if (in_tail) {  /* one step of DecodeAlphaData, through libwebp's reader */
            tail_check(br, &tail, 32);  /* VP8LFillBitWindow */
            int code = tail_symbol(br, &tail, &g->codes[0]);
            if (code < 0) return ERR_BITSTREAM;
            if (code < NUM_LITERAL_CODES) {
                data[pos++] = ((uint32_t)g->codes[3].single << 24) |
                              ((uint32_t)g->codes[1].single << 16) | ((uint32_t)code << 8) |
                              (uint32_t)g->codes[2].single;
                if (++col >= width) { col = 0; row++; }
            } else if (code < NUM_LITERAL_CODES + NUM_LENGTH_CODES) {
                int length = tail_prefix(br, &tail, code - NUM_LITERAL_CODES);
                int dist_symbol = tail_symbol(br, &tail, &g->codes[4]);
                if (dist_symbol < 0) return ERR_BITSTREAM;
                tail_check(br, &tail, 32);
                int dist = plane_distance(width, tail_prefix(br, &tail, dist_symbol));
                if (pos < dist || total - pos < length) return ERR_BITSTREAM;
                for (int i = 0; i < length; i++) data[pos + i] = data[pos + i - dist];
                pos += length;
                col += length;
                while (col >= width) { col -= width; row++; }
                if (pos < total && (col & mask)) g = GROUP_AT(col, row);
            } else {
                return ERR_BITSTREAM;
            }
            if (tail.eos || br->consumed > 8 * br->size) return pos < total ? ERR_TRUNCATED : 0;
            continue;
        }
        if (eight_bit ? leos(br) : br->consumed > 8 * br->size + 64) return ERR_TRUNCATED;
        int code = read_symbol(br, &g->codes[0]);
        if (code < 0) return ERR_BITSTREAM;
        if (code < NUM_LITERAL_CODES) {
            uint32_t red = (uint32_t)read_symbol(br, &g->codes[1]);
            uint32_t blue = (uint32_t)read_symbol(br, &g->codes[2]);
            uint32_t alpha = (uint32_t)read_symbol(br, &g->codes[3]);
            data[pos] = (alpha << 24) | (red << 16) | ((uint32_t)code << 8) | blue;
        } else if (code < NUM_LITERAL_CODES + NUM_LENGTH_CODES) {
            int length = prefix_value(br, code - NUM_LITERAL_CODES);
            int dist_symbol = read_symbol(br, &g->codes[4]);
            if (dist_symbol < 0) return ERR_BITSTREAM;
            int dist = plane_distance(width, prefix_value(br, dist_symbol));
            if (!eight_bit && leos(br)) return ERR_TRUNCATED;
            if (pos < dist || total - pos < length) return ERR_BITSTREAM;
            for (int i = 0; i < length; i++) data[pos + i] = data[pos + i - dist];
            pos += length;
            col += length;
            while (col >= width) { col -= width; row++; }
            if (col & mask) g = GROUP_AT(col, row);
            if (cache_bits)
                for (; last_cached < pos; last_cached++)
                    cache[(0x1e35a7bdu * data[last_cached]) >> (32 - cache_bits)] = data[last_cached];
            continue;
        } else {
            int key = code - NUM_LITERAL_CODES - NUM_LENGTH_CODES;
            if (!cache_bits || key >= (1 << cache_bits)) return ERR_BITSTREAM;
            for (; last_cached < pos; last_cached++)
                cache[(0x1e35a7bdu * data[last_cached]) >> (32 - cache_bits)] = data[last_cached];
            data[pos] = cache[key];
        }
        pos++;
        if (++col >= width) { col = 0; row++; }
        if (cache_bits)
            for (; last_cached < pos; last_cached++)
                cache[(0x1e35a7bdu * data[last_cached]) >> (32 - cache_bits)] = data[last_cached];
    }
#undef GROUP_AT
    return !eight_bit && leos(br) ? ERR_TRUNCATED : 0;
}

static int decode_stream(vp8l_t *d, int xsize, int ysize, int level0, uint32_t **out,
                         int *coded_xsize) {
    lbits_t *br = &d->br;
    int err = 0, cache_bits = 0, meta_bits = 0, ngroups = 1, nused = 1;
    uint32_t *meta = NULL, *data = NULL;
    int *map = NULL, *lengths = NULL;
    group_t *groups = NULL;
    uint16_t *sorted = NULL;
    if (level0) {
        while (lread(br, 1)) {
            if (d->ntransforms >= 4) return ERR_BITSTREAM;
            err = read_transform(d, &xsize, ysize);
            if (err) return err;
        }
    }
    if (lread(br, 1)) {
        cache_bits = (int)lread(br, 4);
        if (cache_bits < 1 || cache_bits > MAX_CACHE_BITS) return ERR_BITSTREAM;
    }
    if (level0 && lread(br, 1)) {  /* meta prefix codes */
        meta_bits = (int)lread(br, 3) + 2;
        int mw = (int)subsample(xsize, meta_bits), mh = (int)subsample(ysize, meta_bits);
        err = decode_stream(d, mw, mh, 0, &meta, NULL);
        if (err) return err;
        ngroups = 0;
        for (long i = 0; i < (long)mw * mh; i++) {
            meta[i] = (meta[i] >> 8) & 0xffff;
            if ((int)meta[i] >= ngroups) ngroups = (int)meta[i] + 1;
        }
        /* groups the image never names are read and dropped */
        map = (int *)malloc(sizeof(int) * ngroups);
        if (!map) { err = ERR_MEMORY; goto done; }
        for (int i = 0; i < ngroups; i++) map[i] = -1;
        nused = 0;
        for (long i = 0; i < (long)mw * mh; i++)
            if (map[meta[i]] < 0) map[meta[i]] = nused++;
        for (long i = 0; i < (long)mw * mh; i++) meta[i] = (uint32_t)map[meta[i]];
    }
    int green_size = kAlphabetSize[0] + (cache_bits ? 1 << cache_bits : 0);
    int per_group = green_size + 3 * NUM_LITERAL_CODES + NUM_DISTANCE_CODES;
    groups = (group_t *)malloc(sizeof(group_t) * (size_t)(nused + 1));
    sorted = (uint16_t *)malloc(sizeof(uint16_t) * (size_t)(nused + 1) * per_group);
    lengths = (int *)malloc(sizeof(int) * MAX_ALPHABET);
    if (!groups || !sorted || !lengths) { err = ERR_MEMORY; goto done; }
    for (int i = 0; i < ngroups; i++) {
        int slot = map ? map[i] : i;
        if (slot < 0) slot = nused;  /* the scratch group */
        uint16_t *s = sorted + (size_t)slot * per_group;
        for (int j = 0; j < 5; j++) {
            int n = j == 0 ? green_size : kAlphabetSize[j];
            err = read_code(br, n, &groups[slot].codes[j], s, lengths);
            if (err) goto done;
            s += n;
        }
    }
    data = (uint32_t *)malloc(sizeof(uint32_t) * (size_t)xsize * (size_t)ysize + 4);
    if (!data) { err = ERR_MEMORY; goto done; }
    /* libwebp's Is8bOptimizable alpha: colour indexing alone, no cache, one
     * symbol each for red, blue and alpha */
    int eight_bit = level0 && d->alpha && d->ntransforms == 1 && d->transforms[0].type == 3 &&
                    !cache_bits;
    for (int i = 0; i < nused && eight_bit; i++)
        eight_bit = groups[i].codes[1].single >= 0 && groups[i].codes[2].single >= 0 &&
                    groups[i].codes[3].single >= 0;
    err = decode_pixels(d, data, xsize, ysize, cache_bits, groups, meta, meta_bits, eight_bit);
done:
    free(meta);
    free(map);
    free(groups);
    free(sorted);
    free(lengths);
    if (err) { free(data); return err; }
    *out = data;
    if (coded_xsize) *coded_xsize = xsize;
    return 0;
}

static inline uint32_t add_pixels(uint32_t a, uint32_t b) {
    return (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
           (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
}

static inline uint32_t average2(uint32_t a, uint32_t b) {
    return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

static inline int clip255(int a) { return a < 0 ? 0 : a > 255 ? 255 : a; }

static inline uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {  /* T, L, TL */
    int sum = 0;
    for (int s = 0; s < 32; s += 8) {
        int ca = (a >> s) & 0xff, cb = (b >> s) & 0xff, cc = (c >> s) & 0xff;
        sum += abs(cb - cc) - abs(ca - cc);
    }
    return sum <= 0 ? a : b;
}

static inline uint32_t clamped_full(uint32_t c0, uint32_t c1, uint32_t c2) {
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8)
        out |= (uint32_t)clip255((int)((c0 >> s) & 0xff) + (int)((c1 >> s) & 0xff) -
                                 (int)((c2 >> s) & 0xff)) << s;
    return out;
}

static inline uint32_t clamped_half(uint32_t c0, uint32_t c1) {
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8) {
        int a = (c0 >> s) & 0xff, b = (c1 >> s) & 0xff;
        out |= (uint32_t)clip255(a + (a - b) / 2) << s;
    }
    return out;
}

static uint32_t predict(int mode, const uint32_t *out, long x, int width) {
    uint32_t L = out[x - 1], T = out[x - width], TR = out[x - width + 1], TL = out[x - width - 1];
    switch (mode) {
        case 1: return L;
        case 2: return T;
        case 3: return TR;
        case 4: return TL;
        case 5: return average2(average2(L, TR), T);
        case 6: return average2(L, TL);
        case 7: return average2(L, T);
        case 8: return average2(TL, T);
        case 9: return average2(T, TR);
        case 10: return average2(average2(L, TL), average2(T, TR));
        case 11: return select_pred(T, L, TL);
        case 12: return clamped_full(L, T, TL);
        case 13: return clamped_half(average2(L, T), TL);
        default: return 0xff000000u;
    }
}

static inline int delta(int8_t pred, int8_t color) { return ((int)pred * color) >> 5; }

/* The inverse of transform t on an image of `height` rows: `in` holds the
 * coded pixels (t->xsize wide, or fewer for colour indexing), `out` gets
 * t->xsize wide pixels (`in` and `out` may be one buffer except for colour
 * indexing). */
static void inverse_transform(const transform_t *t, int height, const uint32_t *in,
                              uint32_t *out) {
    int width = t->xsize;
    long n = (long)width * height;
    if (t->type == 0) {  /* predictor: row 0 from the left, column 0 from above */
        int tiles = (int)subsample(width, t->bits);
        for (int y = 0; y < height; y++) {
            for (int x = 0; x < width; x++) {
                long i = (long)y * width + x;
                uint32_t pred;
                if (y == 0) pred = x ? out[i - 1] : 0xff000000u;
                else if (x == 0) pred = out[i - width];
                else pred = predict((t->data[(y >> t->bits) * tiles + (x >> t->bits)] >> 8) & 0xf,
                                    out, i, width);
                out[i] = add_pixels(in[i], pred);
            }
        }
    } else if (t->type == 1) {  /* cross-colour */
        int tiles = (int)subsample(width, t->bits);
        for (int y = 0; y < height; y++) {
            for (int x = 0; x < width; x++) {
                long i = (long)y * width + x;
                uint32_t m = t->data[(y >> t->bits) * tiles + (x >> t->bits)];
                uint32_t argb = in[i];
                int8_t green = (int8_t)(argb >> 8);
                int red = (argb >> 16) & 0xff, blue = argb & 0xff;
                red = (red + delta((int8_t)(m & 0xff), green)) & 0xff;
                blue += delta((int8_t)((m >> 8) & 0xff), green);
                blue = (blue + delta((int8_t)((m >> 16) & 0xff), (int8_t)red)) & 0xff;
                out[i] = (argb & 0xff00ff00u) | ((uint32_t)red << 16) | (uint32_t)blue;
            }
        }
    } else if (t->type == 2) {  /* subtract green: add it back */
        for (long i = 0; i < n; i++) {
            uint32_t argb = in[i], g = (argb >> 8) & 0xff;
            uint32_t rb = ((argb & 0x00ff00ffu) + ((g << 16) | g)) & 0x00ff00ffu;
            out[i] = (argb & 0xff00ff00u) | rb;
        }
    } else {  /* colour indexing, 8 >> bits bits an index, packed in green */
        int bpp = 8 >> t->bits, per = 1 << t->bits;
        int coded = (int)subsample(width, t->bits);
        uint32_t bmask = (1u << bpp) - 1;
        for (int y = 0; y < height; y++) {
            const uint32_t *src = in + (long)y * coded;
            uint32_t *dst = out + (long)y * width;
            uint32_t packed = 0;
            for (int x = 0; x < width; x++) {
                if ((x & (per - 1)) == 0) packed = (*src++ >> 8) & 0xff;
                dst[x] = t->data[packed & bmask];
                packed >>= bpp;
            }
        }
    }
}

/* A VP8L image (a VP8L chunk, or with `headerless` the stream of an ALPH
 * chunk, whose size the caller gives) → width × height ARGB pixels. */
int hi3d_webp_lossless(const uint8_t *data, long size, int headerless, int width, int height,
                       uint32_t *argb) {
    if (size < 0 || width < 1 || height < 1 || width > 16384 || height > (1 << 24))
        return ERR_ARGS;
    vp8l_t d;
    memset(&d, 0, sizeof d);
    d.br.buf = data;
    d.br.size = size;
    d.alpha = headerless;
    if (!headerless) {
        if (size < 5) return ERR_TRUNCATED;
        if (lread(&d.br, 8) != 0x2f) return ERR_BITSTREAM;
        int w = (int)lread(&d.br, 14) + 1, h = (int)lread(&d.br, 14) + 1;
        lread(&d.br, 1);  /* alpha_is_used: the container reports it */
        if (lread(&d.br, 3) != 0) return ERR_BITSTREAM;
        if (w != width || h != height) return ERR_ARGS;
    }
    uint32_t *cur = NULL;
    int err = decode_stream(&d, width, height, 1, &cur, NULL);
    /* undo the transforms, the last read first; colour indexing widens */
    for (int i = d.ntransforms - 1; i >= 0 && !err; i--) {
        const transform_t *t = &d.transforms[i];
        if (t->type == 3) {
            uint32_t *next = (uint32_t *)malloc(sizeof(uint32_t) * (size_t)t->xsize * height);
            if (!next) { err = ERR_MEMORY; break; }
            inverse_transform(t, height, cur, next);
            free(cur);
            cur = next;
        } else {
            inverse_transform(t, height, cur, cur);
        }
    }
    if (!err) memcpy(argb, cur, sizeof(uint32_t) * (size_t)width * height);
    free(cur);
    for (int i = 0; i < d.ntransforms; i++) free(d.transforms[i].data);
    return err;
}

/* The alpha plane's unfiltering (libwebp's filters.c): 1 horizontal, 2
 * vertical, 3 gradient; row 0 is predicted from the left, the first pixel
 * of a later row from above. In place, row by row. */
int hi3d_webp_unfilter_alpha(uint8_t *plane, int width, int height, int method) {
    if (width < 1 || height < 1 || method < 0 || method > 3) return ERR_ARGS;
    if (method == 0) return 0;
    for (int y = 0; y < height; y++) {
        uint8_t *row = plane + (long)y * width;
        const uint8_t *prev = y ? row - width : NULL;
        if (!prev || method == 1) {
            uint8_t pred = prev ? prev[0] : 0;
            for (int x = 0; x < width; x++) row[x] = pred = (uint8_t)(pred + row[x]);
        } else if (method == 2) {
            for (int x = 0; x < width; x++) row[x] = (uint8_t)(prev[x] + row[x]);
        } else {
            int top_left = prev[0], left = prev[0];
            for (int x = 0; x < width; x++) {
                int top = prev[x];
                left = (uint8_t)(row[x] + clip255(left + top - top_left));
                top_left = top;
                row[x] = (uint8_t)left;
            }
        }
    }
    return 0;
}

/* ============================================== VP8 (lossy) key frames */

typedef struct {  /* libwebp's VP8BitReader, loading one byte at a time */
    const uint8_t *buf, *end;
    uint32_t value;
    uint32_t range;  /* range - 1 */
    int bits;        /* bits of `value` not yet consumed past 8 */
    int eof;
} bool_t;

static void bool_load(bool_t *br) {
    if (br->buf < br->end) {
        br->bits += 8;
        br->value = (uint32_t)*br->buf++ | (br->value << 8);
    } else if (!br->eof) {
        br->value <<= 8;
        br->bits += 8;
        br->eof = 1;
    } else {
        br->bits = 0;
    }
}

static void bool_init(bool_t *br, const uint8_t *start, long size) {
    br->buf = start;
    br->end = start + size;
    br->value = 0;
    br->range = 255 - 1;
    br->bits = -8;
    br->eof = 0;
    bool_load(br);
}

static inline int get_bit(bool_t *br, int prob) {
    uint32_t range = br->range;
    if (br->bits < 0) bool_load(br);
    int pos = br->bits;
    uint32_t split = (range * (uint32_t)prob) >> 8;
    uint32_t value = br->value >> pos;
    int bit = value > split;
    if (bit) {
        range -= split;
        br->value -= (split + 1) << pos;
    } else {
        range = split + 1;
    }
    int shift = 7 ^ (31 - __builtin_clz(range));
    range <<= shift;
    br->bits -= shift;
    br->range = range - 1;
    return bit;
}

static inline int get_value(bool_t *br, int bits) {
    int v = 0;
    while (bits-- > 0) v |= get_bit(br, 0x80) << bits;
    return v;
}

static inline int get_signed_value(bool_t *br, int bits) {
    int v = get_value(br, bits);
    return get_bit(br, 0x80) ? -v : v;
}

enum { B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED, B_LD_PRED,
       B_VL_PRED, B_HD_PRED, B_HU_PRED, NUM_BMODES,
       DC_PRED = B_DC_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED, TM_PRED = B_TM_PRED,
       DC_NOTOP = 4, DC_NOLEFT = 5, DC_NOTOPLEFT = 6 };

static const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
static const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
static const uint8_t kCat3[] = {173, 148, 140, 0};
static const uint8_t kCat4[] = {176, 155, 140, 135, 0};
static const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
static const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
static const uint8_t *const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

#define BPS 32  /* the stride of the work block of one macroblock */
#define Y_OFF (BPS * 1 + 8)
#define U_OFF (BPS * 18 + 8)
#define V_OFF (BPS * 18 + 24)

typedef struct {
    int segment, skip, is_i4x4, uvmode;
    uint8_t imodes[16];
    int16_t coeffs[384];
    int inner;  /* filter the inner edges */
} mb_t;

typedef struct {
    int limit, ilevel, hev_thresh;
} fstrength_t;

typedef struct {
    int width, height, mb_w, mb_h;
    bool_t br, parts[8];
    int num_parts;
    /* segment header */
    int use_segment, update_map, absolute_delta;
    int quantizer[4], filter_strength[4];
    uint8_t segment_probs[3];
    /* filter header */
    int simple, level, sharpness, use_lf_delta, ref_lf_delta[4], mode_lf_delta[4];
    int filter_type;
    /* quantisers: y1 dc/ac, y2 dc/ac, uv dc/ac for each segment */
    int dq[4][6];
    uint8_t proba[4][8][3][11];
    int use_skip, skip_p;
    fstrength_t fstrengths[4][2];
    /* contexts */
    uint8_t *intra_t;    /* 4 a macroblock column: the modes above */
    uint8_t intra_l[4];
    uint8_t *nz_top, *nz_dc_top;
    uint8_t nz_left, nz_dc_left;
    /* planes */
    uint8_t *y, *u, *v;
    int ystride, uvstride;
    uint8_t *top_y, *top_u, *top_v;  /* the unfiltered last row of the MB row above */
} vp8_t;

static inline int clip(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }

static int parse_header(vp8_t *d, const uint8_t *buf, long size) {
    if (size < 10) return ERR_TRUNCATED;
    uint32_t bits = buf[0] | (buf[1] << 8) | (buf[2] << 16);
    int key_frame = !(bits & 1), profile = (bits >> 1) & 7, show = (bits >> 4) & 1;
    uint32_t part_length = bits >> 5;
    if (!key_frame || profile > 3 || !show) return ERR_BITSTREAM;
    if (buf[3] != 0x9d || buf[4] != 0x01 || buf[5] != 0x2a) return ERR_BITSTREAM;
    int w = ((buf[7] << 8) | buf[6]) & 0x3fff, h = ((buf[9] << 8) | buf[8]) & 0x3fff;
    if (w != d->width || h != d->height) return ERR_ARGS;
    buf += 10;
    size -= 10;
    if (part_length > (uint32_t)size) return ERR_TRUNCATED;
    bool_t *br = &d->br;
    bool_init(br, buf, part_length);
    buf += part_length;
    size -= part_length;
    get_value(br, 1);  /* colour space */
    get_value(br, 1);  /* clamping type */
    /* segment header */
    d->absolute_delta = 1;
    memset(d->segment_probs, 255, sizeof d->segment_probs);
    d->use_segment = get_value(br, 1);
    if (d->use_segment) {
        d->update_map = get_value(br, 1);
        if (get_value(br, 1)) {
            d->absolute_delta = get_value(br, 1);
            for (int s = 0; s < 4; s++) d->quantizer[s] = get_value(br, 1) ? get_signed_value(br, 7) : 0;
            for (int s = 0; s < 4; s++)
                d->filter_strength[s] = get_value(br, 1) ? get_signed_value(br, 6) : 0;
        }
        if (d->update_map)
            for (int s = 0; s < 3; s++)
                d->segment_probs[s] = (uint8_t)(get_value(br, 1) ? get_value(br, 8) : 255);
    }
    /* filter header */
    d->simple = get_value(br, 1);
    d->level = get_value(br, 6);
    d->sharpness = get_value(br, 3);
    d->use_lf_delta = get_value(br, 1);
    if (d->use_lf_delta && get_value(br, 1)) {
        for (int i = 0; i < 4; i++) if (get_value(br, 1)) d->ref_lf_delta[i] = get_signed_value(br, 6);
        for (int i = 0; i < 4; i++) if (get_value(br, 1)) d->mode_lf_delta[i] = get_signed_value(br, 6);
    }
    d->filter_type = d->level == 0 ? 0 : d->simple ? 1 : 2;
    if (br->eof) return ERR_TRUNCATED;
    /* partitions */
    d->num_parts = 1 << get_value(br, 2);
    int last = d->num_parts - 1;
    if (size < 3L * last) return ERR_TRUNCATED;
    const uint8_t *sz = buf, *part = buf + 3 * last, *end = buf + size;
    long left = size - 3L * last;
    for (int p = 0; p < last; p++) {
        long psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
        if (psize > left) psize = left;
        bool_init(&d->parts[p], part, psize);
        part += psize;
        left -= psize;
        sz += 3;
    }
    bool_init(&d->parts[last], part, left);
    if (part >= end) return ERR_TRUNCATED;
    /* quantisers */
    int base_q0 = get_value(br, 7);
    int dqy1_dc = get_value(br, 1) ? get_signed_value(br, 4) : 0;
    int dqy2_dc = get_value(br, 1) ? get_signed_value(br, 4) : 0;
    int dqy2_ac = get_value(br, 1) ? get_signed_value(br, 4) : 0;
    int dquv_dc = get_value(br, 1) ? get_signed_value(br, 4) : 0;
    int dquv_ac = get_value(br, 1) ? get_signed_value(br, 4) : 0;
    for (int i = 0; i < 4; i++) {
        int q;
        if (d->use_segment) {
            q = d->quantizer[i] + (d->absolute_delta ? 0 : base_q0);
        } else if (i > 0) {
            memcpy(d->dq[i], d->dq[0], sizeof d->dq[0]);
            continue;
        } else {
            q = base_q0;
        }
        int *m = d->dq[i];
        m[0] = kDcTable[clip(q + dqy1_dc, 127)];
        m[1] = kAcTable[clip(q, 127)];
        m[2] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
        m[3] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
        if (m[3] < 8) m[3] = 8;
        m[4] = kDcTable[clip(q + dquv_dc, 117)];
        m[5] = kAcTable[clip(q + dquv_ac, 127)];
    }
    get_value(br, 1);  /* refresh entropy probabilities: one frame, no use */
    for (int i = 0; i < 1056; i++)
        ((uint8_t *)d->proba)[i] = (uint8_t)(get_bit(br, kCoeffsUpdateProba[i]) ? get_value(br, 8)
                                                                              : kCoeffsProba0[i]);
    d->use_skip = get_value(br, 1);
    if (d->use_skip) d->skip_p = get_value(br, 8);
    return br->eof ? ERR_TRUNCATED : 0;
}

static void precompute_filter_strengths(vp8_t *d) {
    if (d->filter_type == 0) return;
    for (int s = 0; s < 4; s++) {
        int base = d->level;
        if (d->use_segment) base = d->filter_strength[s] + (d->absolute_delta ? 0 : d->level);
        for (int i4x4 = 0; i4x4 <= 1; i4x4++) {
            fstrength_t *f = &d->fstrengths[s][i4x4];
            int level = base;
            if (d->use_lf_delta) {
                level += d->ref_lf_delta[0];
                if (i4x4) level += d->mode_lf_delta[0];
            }
            level = level < 0 ? 0 : level > 63 ? 63 : level;
            if (level > 0) {
                int ilevel = level;
                if (d->sharpness > 0) {
                    ilevel >>= d->sharpness > 4 ? 2 : 1;
                    if (ilevel > 9 - d->sharpness) ilevel = 9 - d->sharpness;
                }
                if (ilevel < 1) ilevel = 1;
                f->ilevel = ilevel;
                f->limit = 2 * level + ilevel;
                f->hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
            } else {
                f->limit = 0;
            }
        }
    }
}

static void parse_intra_mode(vp8_t *d, mb_t *mb, int mb_x) {
    bool_t *br = &d->br;
    uint8_t *top = d->intra_t + 4 * mb_x, *left = d->intra_l;
    mb->segment = d->update_map ? (!get_bit(br, d->segment_probs[0])
                                       ? get_bit(br, d->segment_probs[1])
                                       : get_bit(br, d->segment_probs[2]) + 2)
                                : 0;
    mb->skip = d->use_skip ? get_bit(br, d->skip_p) : 0;
    mb->is_i4x4 = !get_bit(br, 145);
    if (!mb->is_i4x4) {
        int ymode = get_bit(br, 156) ? (get_bit(br, 128) ? TM_PRED : H_PRED)
                                     : (get_bit(br, 163) ? V_PRED : DC_PRED);
        mb->imodes[0] = (uint8_t)ymode;
        memset(top, ymode, 4);
        memset(left, ymode, 4);
    } else {
        uint8_t *modes = mb->imodes;
        for (int y = 0; y < 4; y++) {
            int ymode = left[y];
            for (int x = 0; x < 4; x++) {
                const uint8_t *prob = kBModesProba + (top[x] * NUM_BMODES + ymode) * (NUM_BMODES - 1);
                ymode = !get_bit(br, prob[0]) ? B_DC_PRED
                      : !get_bit(br, prob[1]) ? B_TM_PRED
                      : !get_bit(br, prob[2]) ? B_VE_PRED
                      : !get_bit(br, prob[3])
                            ? (!get_bit(br, prob[4]) ? B_HE_PRED
                                                     : (!get_bit(br, prob[5]) ? B_RD_PRED : B_VR_PRED))
                            : (!get_bit(br, prob[6]) ? B_LD_PRED
                               : !get_bit(br, prob[7]) ? B_VL_PRED
                               : !get_bit(br, prob[8]) ? B_HD_PRED : B_HU_PRED);
                top[x] = (uint8_t)ymode;
            }
            memcpy(modes, top, 4);
            modes += 4;
            left[y] = (uint8_t)ymode;
        }
    }
    mb->uvmode = !get_bit(br, 142) ? DC_PRED
               : !get_bit(br, 114) ? V_PRED
               : get_bit(br, 183) ? TM_PRED : H_PRED;
}

static int large_value(bool_t *br, const uint8_t *p) {
    int v;
    if (!get_bit(br, p[3])) {
        v = !get_bit(br, p[4]) ? 2 : 3 + get_bit(br, p[5]);
    } else if (!get_bit(br, p[6])) {
        if (!get_bit(br, p[7])) {
            v = 5 + get_bit(br, 159);
        } else {
            v = 7 + 2 * get_bit(br, 165);
            v += get_bit(br, 145);
        }
    } else {
        int bit1 = get_bit(br, p[8]);
        int bit0 = get_bit(br, p[9 + bit1]);
        int cat = 2 * bit1 + bit0;
        v = 0;
        for (const uint8_t *tab = kCat3456[cat]; *tab; ++tab) v += v + get_bit(br, *tab);
        v += 3 + (8 << cat);
    }
    return v;
}

/* GetCoeffs: one block's tokens from position n; returns the position after
 * the last nonzero coefficient (16 when the block runs to its end). */
static int get_coeffs(bool_t *br, uint8_t (*bands)[3][11], int ctx, int dc_q, int ac_q, int n,
                      int16_t *out) {
    const uint8_t *p = bands[kBands[n]][ctx];
    for (; n < 16; ++n) {
        if (!get_bit(br, p[0])) return n;
        while (!get_bit(br, p[1])) {
            p = bands[kBands[++n]][0];
            if (n == 16) return 16;
        }
        int v;
        if (!get_bit(br, p[2])) {
            v = 1;
            p = bands[kBands[n + 1]][1];
        } else {
            v = large_value(br, p);
            p = bands[kBands[n + 1]][2];
        }
        int s = get_bit(br, 0x80) ? -v : v;
        out[kZigzag[n]] = (int16_t)(s * (n > 0 ? ac_q : dc_q));
    }
    return 16;
}

static void transform_wht(const int16_t *in, int16_t *out) {
    int tmp[16];
    for (int i = 0; i < 4; ++i) {
        int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
        int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
        tmp[0 + i] = a0 + a1;
        tmp[8 + i] = a0 - a1;
        tmp[4 + i] = a3 + a2;
        tmp[12 + i] = a3 - a2;
    }
    for (int i = 0; i < 4; ++i) {
        int dc = tmp[0 + i * 4] + 3;
        int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
        int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
        out[0] = (int16_t)((a0 + a1) >> 3);
        out[16] = (int16_t)((a3 + a2) >> 3);
        out[32] = (int16_t)((a0 - a1) >> 3);
        out[48] = (int16_t)((a3 - a2) >> 3);
        out += 64;
    }
}

/* ParseResiduals: the tokens of a macroblock; returns whether all its
 * coefficients are zero. */
static int parse_residuals(vp8_t *d, mb_t *mb, int mb_x, bool_t *br) {
    const int *q = d->dq[mb->segment];
    int16_t *dst = mb->coeffs;
    uint8_t *tnz_p = &d->nz_top[mb_x], *tdc_p = &d->nz_dc_top[mb_x];
    uint32_t nonzero = 0;
    int first;
    uint8_t (*ac_proba)[3][11];
    memset(dst, 0, 384 * sizeof(*dst));
    if (!mb->is_i4x4) {
        int16_t dc[16] = {0};
        int ctx = *tdc_p + d->nz_dc_left;
        int nz = get_coeffs(br, d->proba[1], ctx, q[2], q[3], 0, dc);
        *tdc_p = d->nz_dc_left = nz > 0;
        transform_wht(dc, dst);
        first = 1;
        ac_proba = d->proba[0];
    } else {
        first = 0;
        ac_proba = d->proba[3];
    }
    uint8_t tnz = *tnz_p & 0x0f, lnz = d->nz_left & 0x0f;
    for (int y = 0; y < 4; ++y) {
        int l = lnz & 1;
        for (int x = 0; x < 4; ++x) {
            int ctx = l + (tnz & 1);
            int nz = get_coeffs(br, ac_proba, ctx, q[0], q[1], first, dst);
            l = nz > first;
            tnz = (uint8_t)((tnz >> 1) | (l << 7));
            nonzero |= nz > 1 || dst[0] != 0;  /* NzCodeBits != 0 */
            dst += 16;
        }
        tnz >>= 4;
        lnz = (uint8_t)((lnz >> 1) | (l << 7));
    }
    uint32_t out_t = tnz, out_l = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
        tnz = (uint8_t)(*tnz_p >> (4 + ch));
        lnz = (uint8_t)(d->nz_left >> (4 + ch));
        for (int y = 0; y < 2; ++y) {
            int l = lnz & 1;
            for (int x = 0; x < 2; ++x) {
                int ctx = l + (tnz & 1);
                int nz = get_coeffs(br, d->proba[2], ctx, q[4], q[5], 0, dst);
                l = nz > 0;
                tnz = (uint8_t)((tnz >> 1) | (l << 3));
                nonzero |= nz > 1 || dst[0] != 0;
                dst += 16;
            }
            tnz >>= 2;
            lnz = (uint8_t)((lnz >> 1) | (l << 5));
        }
        out_t |= (uint32_t)(tnz << 4) << ch;
        out_l |= (uint32_t)(lnz & 0xf0) << ch;
    }
    *tnz_p = (uint8_t)out_t;
    d->nz_left = (uint8_t)out_l;
    return !nonzero;
}

/* ---------------------------------------------- prediction and transforms */

#define DST(x, y) dst[(x) + (y) * BPS]
#define AVG3(a, b, c) ((uint8_t)(((a) + 2 * (b) + (c) + 2) >> 2))
#define AVG2(a, b) (((a) + (b) + 1) >> 1)

static inline uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

static void true_motion(uint8_t *dst, int size) {
    const uint8_t *top = dst - BPS;
    for (int y = 0; y < size; ++y) {
        for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + dst[-1] - top[-1]);
        dst += BPS;
    }
}

static void fill(uint8_t *dst, int size, int v) {
    for (int j = 0; j < size; ++j) memset(dst + j * BPS, v, size);
}

static void predict_block(uint8_t *dst, int size, int mode) {  /* 16×16 luma, 8×8 chroma */
    int shift = size == 16 ? 4 : 3, dc;
    switch (mode) {
        case DC_PRED:
            dc = size;
            for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
            fill(dst, size, dc >> (shift + 1));
            break;
        case TM_PRED: true_motion(dst, size); break;
        case V_PRED:
            for (int j = 0; j < size; ++j) memcpy(dst + j * BPS, dst - BPS, size);
            break;
        case H_PRED:
            for (int j = 0; j < size; ++j) memset(dst + j * BPS, dst[j * BPS - 1], size);
            break;
        case DC_NOTOP:
            dc = size >> 1;
            for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
            fill(dst, size, dc >> shift);
            break;
        case DC_NOLEFT:
            dc = size >> 1;
            for (int j = 0; j < size; ++j) dc += dst[j - BPS];
            fill(dst, size, dc >> shift);
            break;
        default: fill(dst, size, 0x80); break;
    }
}

static void predict4(uint8_t *dst, int mode) {
    const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
    const int X = dst[-1 - BPS], A = dst[-BPS], B = dst[1 - BPS], C = dst[2 - BPS];
    const int D = dst[3 - BPS], E = dst[4 - BPS], F = dst[5 - BPS], G = dst[6 - BPS];
    const int H = dst[7 - BPS];
    switch (mode) {
        case B_DC_PRED: {
            uint32_t dc = 4;
            for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
            fill(dst, 4, dc >> 3);
            break;
        }
        case B_TM_PRED: true_motion(dst, 4); break;
        case B_VE_PRED: {
            uint8_t vals[4] = {AVG3(X, A, B), AVG3(A, B, C), AVG3(B, C, D), AVG3(C, D, E)};
            for (int i = 0; i < 4; ++i) memcpy(dst + i * BPS, vals, 4);
            break;
        }
        case B_HE_PRED:
            memset(dst, AVG3(X, I, J), 4);
            memset(dst + BPS, AVG3(I, J, K), 4);
            memset(dst + 2 * BPS, AVG3(J, K, L), 4);
            memset(dst + 3 * BPS, AVG3(K, L, L), 4);
            break;
        case B_RD_PRED:
            DST(0, 3) = AVG3(J, K, L);
            DST(1, 3) = DST(0, 2) = AVG3(I, J, K);
            DST(2, 3) = DST(1, 2) = DST(0, 1) = AVG3(X, I, J);
            DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = AVG3(A, X, I);
            DST(3, 2) = DST(2, 1) = DST(1, 0) = AVG3(B, A, X);
            DST(3, 1) = DST(2, 0) = AVG3(C, B, A);
            DST(3, 0) = AVG3(D, C, B);
            break;
        case B_LD_PRED:
            DST(0, 0) = AVG3(A, B, C);
            DST(1, 0) = DST(0, 1) = AVG3(B, C, D);
            DST(2, 0) = DST(1, 1) = DST(0, 2) = AVG3(C, D, E);
            DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = AVG3(D, E, F);
            DST(3, 1) = DST(2, 2) = DST(1, 3) = AVG3(E, F, G);
            DST(3, 2) = DST(2, 3) = AVG3(F, G, H);
            DST(3, 3) = AVG3(G, H, H);
            break;
        case B_VR_PRED:
            DST(0, 0) = DST(1, 2) = AVG2(X, A);
            DST(1, 0) = DST(2, 2) = AVG2(A, B);
            DST(2, 0) = DST(3, 2) = AVG2(B, C);
            DST(3, 0) = AVG2(C, D);
            DST(0, 3) = AVG3(K, J, I);
            DST(0, 2) = AVG3(J, I, X);
            DST(0, 1) = DST(1, 3) = AVG3(I, X, A);
            DST(1, 1) = DST(2, 3) = AVG3(X, A, B);
            DST(2, 1) = DST(3, 3) = AVG3(A, B, C);
            DST(3, 1) = AVG3(B, C, D);
            break;
        case B_VL_PRED:
            DST(0, 0) = AVG2(A, B);
            DST(1, 0) = DST(0, 2) = AVG2(B, C);
            DST(2, 0) = DST(1, 2) = AVG2(C, D);
            DST(3, 0) = DST(2, 2) = AVG2(D, E);
            DST(0, 1) = AVG3(A, B, C);
            DST(1, 1) = DST(0, 3) = AVG3(B, C, D);
            DST(2, 1) = DST(1, 3) = AVG3(C, D, E);
            DST(3, 1) = DST(2, 3) = AVG3(D, E, F);
            DST(3, 2) = AVG3(E, F, G);
            DST(3, 3) = AVG3(F, G, H);
            break;
        case B_HD_PRED:
            DST(0, 0) = DST(2, 1) = AVG2(I, X);
            DST(0, 1) = DST(2, 2) = AVG2(J, I);
            DST(0, 2) = DST(2, 3) = AVG2(K, J);
            DST(0, 3) = AVG2(L, K);
            DST(3, 0) = AVG3(A, B, C);
            DST(2, 0) = AVG3(X, A, B);
            DST(1, 0) = DST(3, 1) = AVG3(I, X, A);
            DST(1, 1) = DST(3, 2) = AVG3(J, I, X);
            DST(1, 2) = DST(3, 3) = AVG3(K, J, I);
            DST(1, 3) = AVG3(L, K, J);
            break;
        default:  /* B_HU_PRED */
            DST(0, 0) = AVG2(I, J);
            DST(2, 0) = DST(0, 1) = AVG2(J, K);
            DST(2, 1) = DST(0, 2) = AVG2(K, L);
            DST(1, 0) = AVG3(I, J, K);
            DST(3, 0) = DST(1, 1) = AVG3(J, K, L);
            DST(3, 1) = DST(1, 2) = AVG3(K, L, L);
            DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
            break;
    }
}

#define MUL1(a) ((((a) * 20091) >> 16) + (a))
#define MUL2(a) (((a) * 35468) >> 16)

static void transform_add(const int16_t *in, uint8_t *dst) {  /* TransformOne */
    int C[16], *tmp = C;
    for (int i = 0; i < 4; ++i) {
        int a = in[0] + in[8], b = in[0] - in[8];
        int c = MUL2(in[4]) - MUL1(in[12]), dd = MUL1(in[4]) + MUL2(in[12]);
        tmp[0] = a + dd;
        tmp[1] = b + c;
        tmp[2] = b - c;
        tmp[3] = a - dd;
        tmp += 4;
        in++;
    }
    tmp = C;
    for (int i = 0; i < 4; ++i) {
        int dc = tmp[0] + 4;
        int a = dc + tmp[8], b = dc - tmp[8];
        int c = MUL2(tmp[4]) - MUL1(tmp[12]), dd = MUL1(tmp[4]) + MUL2(tmp[12]);
        dst[0] = clip8(dst[0] + ((a + dd) >> 3));
        dst[1] = clip8(dst[1] + ((b + c) >> 3));
        dst[2] = clip8(dst[2] + ((b - c) >> 3));
        dst[3] = clip8(dst[3] + ((a - dd) >> 3));
        tmp++;
        dst += BPS;
    }
}

static int check_mode(int mb_x, int mb_y, int mode) {
    if (mode == B_DC_PRED) {
        if (mb_x == 0) return mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
        return mb_y == 0 ? DC_NOTOP : DC_PRED;
    }
    return mode;
}

/* ReconstructRow: predict and add the residuals of one macroblock row in
 * the work block `yuv_b` (its left and top context unfiltered), and copy
 * each macroblock into the planes. */
static void reconstruct_row(vp8_t *d, mb_t *mbs, int mb_y, uint8_t *yuv_b) {
    uint8_t *y_dst = yuv_b + Y_OFF, *u_dst = yuv_b + U_OFF, *v_dst = yuv_b + V_OFF;
    for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
    if (mb_y > 0) {
        y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
    } else {
        memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
        memset(u_dst - BPS - 1, 127, 8 + 1);
        memset(v_dst - BPS - 1, 127, 8 + 1);
    }
    for (int mb_x = 0; mb_x < d->mb_w; ++mb_x) {
        const mb_t *mb = &mbs[mb_x];
        if (mb_x > 0) {  /* the left samples from the macroblock before */
            for (int j = -1; j < 16; ++j) memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
            for (int j = -1; j < 8; ++j) {
                memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
                memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
            }
        }
        uint8_t *top_y = d->top_y + 16 * mb_x, *top_u = d->top_u + 8 * mb_x;
        uint8_t *top_v = d->top_v + 8 * mb_x;
        if (mb_y > 0) {
            memcpy(y_dst - BPS, top_y, 16);
            memcpy(u_dst - BPS, top_u, 8);
            memcpy(v_dst - BPS, top_v, 8);
        }
        if (mb->is_i4x4) {
            uint8_t *top_right = y_dst - BPS + 16;
            if (mb_y > 0) {
                if (mb_x >= d->mb_w - 1) memset(top_right, top_y[15], 4);
                else memcpy(top_right, top_y + 16, 4);
            }
            for (int r = 1; r < 4; r++) memcpy(top_right + 4 * r * BPS, top_right, 4);
            for (int n = 0; n < 16; ++n) {
                uint8_t *dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
                predict4(dst, mb->imodes[n]);
                transform_add(mb->coeffs + n * 16, dst);
            }
        } else {
            predict_block(y_dst, 16, check_mode(mb_x, mb_y, mb->imodes[0]));
            for (int n = 0; n < 16; ++n)
                transform_add(mb->coeffs + n * 16, y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
        }
        int uvmode = check_mode(mb_x, mb_y, mb->uvmode);
        predict_block(u_dst, 8, uvmode);
        predict_block(v_dst, 8, uvmode);
        for (int n = 0; n < 4; ++n) {
            int off = (n & 1) * 4 + (n >> 1) * 4 * BPS;
            transform_add(mb->coeffs + (16 + n) * 16, u_dst + off);
            transform_add(mb->coeffs + (20 + n) * 16, v_dst + off);
        }
        if (mb_y < d->mb_h - 1) {
            memcpy(top_y, y_dst + 15 * BPS, 16);
            memcpy(top_u, u_dst + 7 * BPS, 8);
            memcpy(top_v, v_dst + 7 * BPS, 8);
        }
        uint8_t *y_out = d->y + (long)mb_y * 16 * d->ystride + mb_x * 16;
        uint8_t *u_out = d->u + (long)mb_y * 8 * d->uvstride + mb_x * 8;
        uint8_t *v_out = d->v + (long)mb_y * 8 * d->uvstride + mb_x * 8;
        for (int j = 0; j < 16; ++j) memcpy(y_out + (long)j * d->ystride, y_dst + j * BPS, 16);
        for (int j = 0; j < 8; ++j) {
            memcpy(u_out + (long)j * d->uvstride, u_dst + j * BPS, 8);
            memcpy(v_out + (long)j * d->uvstride, v_dst + j * BPS, 8);
        }
    }
}

/* ------------------------------------------------------- the loop filter */

static inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
static inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

static inline void do_filter2(uint8_t *p, int step) {
    int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    int a = 3 * (q0 - p0) + sclip1(p1 - q1);
    int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
}

static inline void do_filter4(uint8_t *p, int step) {
    int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    int a = 3 * (q0 - p0);
    int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3), a3 = (a1 + 1) >> 1;
    p[-2 * step] = clip8(p1 + a3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a3);
}

static inline void do_filter6(uint8_t *p, int step) {
    int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    int q0 = p[0], q1 = p[step], q2 = p[2 * step];
    int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
    int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
    p[-3 * step] = clip8(p2 + a3);
    p[-2 * step] = clip8(p1 + a2);
    p[-step] = clip8(p0 + a1);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a2);
    p[2 * step] = clip8(q2 - a3);
}

static inline int hev(const uint8_t *p, int step, int thresh) {
    return abs(p[-2 * step] - p[-step]) > thresh || abs(p[step] - p[0]) > thresh;
}

static inline int needs_filter(const uint8_t *p, int step, int t) {
    return 4 * abs(p[-step] - p[0]) + abs(p[-2 * step] - p[step]) <= t;
}

static inline int needs_filter2(const uint8_t *p, int step, int t, int it) {
    int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
    if (4 * abs(p0 - q0) + abs(p1 - q1) > t) return 0;
    return abs(p3 - p2) <= it && abs(p2 - p1) <= it && abs(p1 - p0) <= it &&
           abs(q3 - q2) <= it && abs(q2 - q1) <= it && abs(q1 - q0) <= it;
}

/* `size` pixels along an edge: hstride crosses it, vstride runs along it */
static void simple_filter(uint8_t *p, int hstride, int vstride, int size, int thresh) {
    int thresh2 = 2 * thresh + 1;
    for (int i = 0; i < size; ++i, p += vstride)
        if (needs_filter(p, hstride, thresh2)) do_filter2(p, hstride);
}

static void filter_loop(uint8_t *p, int hstride, int vstride, int size, int thresh, int ithresh,
                        int hev_thresh, int edge) {
    int thresh2 = 2 * thresh + 1;
    for (int i = 0; i < size; ++i, p += vstride) {
        if (!needs_filter2(p, hstride, thresh2, ithresh)) continue;
        if (hev(p, hstride, hev_thresh)) do_filter2(p, hstride);
        else if (edge) do_filter6(p, hstride);
        else do_filter4(p, hstride);
    }
}

static void filter_mb(vp8_t *d, const fstrength_t *f, int inner, int mb_x, int mb_y) {
    int limit = f->limit;
    if (limit == 0) return;
    int ys = d->ystride, uvs = d->uvstride;
    uint8_t *y = d->y + (long)mb_y * 16 * ys + mb_x * 16;
    if (d->filter_type == 1) {
        if (mb_x > 0) simple_filter(y, 1, ys, 16, limit + 4);
        if (inner) for (int k = 1; k < 4; k++) simple_filter(y + 4 * k, 1, ys, 16, limit);
        if (mb_y > 0) simple_filter(y, ys, 1, 16, limit + 4);
        if (inner) for (int k = 1; k < 4; k++) simple_filter(y + 4 * k * ys, ys, 1, 16, limit);
        return;
    }
    uint8_t *u = d->u + (long)mb_y * 8 * uvs + mb_x * 8, *v = d->v + (long)mb_y * 8 * uvs + mb_x * 8;
    int il = f->ilevel, ht = f->hev_thresh;
    if (mb_x > 0) {
        filter_loop(y, 1, ys, 16, limit + 4, il, ht, 1);
        filter_loop(u, 1, uvs, 8, limit + 4, il, ht, 1);
        filter_loop(v, 1, uvs, 8, limit + 4, il, ht, 1);
    }
    if (inner) {
        for (int k = 1; k < 4; k++) filter_loop(y + 4 * k, 1, ys, 16, limit, il, ht, 0);
        filter_loop(u + 4, 1, uvs, 8, limit, il, ht, 0);
        filter_loop(v + 4, 1, uvs, 8, limit, il, ht, 0);
    }
    if (mb_y > 0) {
        filter_loop(y, ys, 1, 16, limit + 4, il, ht, 1);
        filter_loop(u, uvs, 1, 8, limit + 4, il, ht, 1);
        filter_loop(v, uvs, 1, 8, limit + 4, il, ht, 1);
    }
    if (inner) {
        for (int k = 1; k < 4; k++) filter_loop(y + 4 * k * ys, ys, 1, 16, limit, il, ht, 0);
        filter_loop(u + 4 * uvs, uvs, 1, 8, limit, il, ht, 0);
        filter_loop(v + 4 * uvs, uvs, 1, 8, limit, il, ht, 0);
    }
}

/* ------------------------------------------- fancy upsampling to RGB(A) */

static inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }

static inline uint8_t yuv_clip8(int v) {  /* VP8Clip8, YUV_FIX2 = 6 */
    return (uint8_t)(((v & ~16383) == 0) ? (v >> 6) : (v < 0) ? 0 : 255);
}

static inline void yuv_to_rgb(int y, int u, int v, uint8_t *rgb) {
    rgb[0] = yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
    rgb[1] = yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
    rgb[2] = yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

#define LOAD_UV(u, v) ((uint32_t)(u) | ((uint32_t)(v) << 16))

/* UpsampleRgbLinePair: two luma rows (bottom may be NULL) between the
 * chroma rows above (top_*) and below (cur_*). */
static void upsample_pair(const uint8_t *top_y, const uint8_t *bottom_y, const uint8_t *top_u,
                          const uint8_t *top_v, const uint8_t *cur_u, const uint8_t *cur_v,
                          uint8_t *top_dst, uint8_t *bottom_dst, int len, int xstep) {
    int last_pair = (len - 1) >> 1;
    uint32_t tl_uv = LOAD_UV(top_u[0], top_v[0]), l_uv = LOAD_UV(cur_u[0], cur_v[0]);
    uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
    yuv_to_rgb(top_y[0], uv0 & 0xff, uv0 >> 16, top_dst);
    if (bottom_y) {
        uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
        yuv_to_rgb(bottom_y[0], uv0 & 0xff, uv0 >> 16, bottom_dst);
    }
    for (int x = 1; x <= last_pair; ++x) {
        uint32_t t_uv = LOAD_UV(top_u[x], top_v[x]), uv = LOAD_UV(cur_u[x], cur_v[x]);
        uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
        uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
        uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
        uint32_t a = (diag_12 + tl_uv) >> 1, b = (diag_03 + t_uv) >> 1;
        yuv_to_rgb(top_y[2 * x - 1], a & 0xff, a >> 16, top_dst + (2 * x - 1) * xstep);
        yuv_to_rgb(top_y[2 * x], b & 0xff, b >> 16, top_dst + (2 * x) * xstep);
        if (bottom_y) {
            a = (diag_03 + l_uv) >> 1;
            b = (diag_12 + uv) >> 1;
            yuv_to_rgb(bottom_y[2 * x - 1], a & 0xff, a >> 16, bottom_dst + (2 * x - 1) * xstep);
            yuv_to_rgb(bottom_y[2 * x], b & 0xff, b >> 16, bottom_dst + (2 * x) * xstep);
        }
        tl_uv = t_uv;
        l_uv = uv;
    }
    if (!(len & 1)) {
        uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
        yuv_to_rgb(top_y[len - 1], uv0 & 0xff, uv0 >> 16, top_dst + (len - 1) * xstep);
        if (bottom_y) {
            uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
            yuv_to_rgb(bottom_y[len - 1], uv0 & 0xff, uv0 >> 16, bottom_dst + (len - 1) * xstep);
        }
    }
}

/* EmitFancyRGB over the whole picture: row 0 from chroma row 0 alone, rows
 * 2k-1 and 2k between chroma rows k-1 and k, the last row of an even
 * height from the last chroma row alone. */
static void emit_fancy_rgb(const vp8_t *d, uint8_t *out, int channels) {
    int w = d->width, h = d->height;
    long stride = (long)w * channels;
    const uint8_t *y = d->y, *u = d->u, *v = d->v;
    upsample_pair(y, NULL, u, v, u, v, out, NULL, w, channels);
    int row = 1;
    for (; row + 1 < h; row += 2) {
        const uint8_t *tu = u + (long)((row - 1) >> 1) * d->uvstride;
        const uint8_t *tv = v + (long)((row - 1) >> 1) * d->uvstride;
        upsample_pair(y + (long)row * d->ystride, y + (long)(row + 1) * d->ystride, tu, tv,
                      tu + d->uvstride, tv + d->uvstride, out + row * stride,
                      out + (row + 1) * stride, w, channels);
    }
    if (row < h) {  /* an even height: the last row */
        const uint8_t *cu = u + (long)((h - 1) >> 1) * d->uvstride;
        const uint8_t *cv = v + (long)((h - 1) >> 1) * d->uvstride;
        upsample_pair(y + (long)(h - 1) * d->ystride, NULL, cu, cv, cu, cv, out + (h - 1) * stride,
                      NULL, w, channels);
    }
}

/* A VP8 key frame (the payload of a VP8 chunk) of width × height →
 * RGB (channels 3) or RGBA with alpha 255 (channels 4), as libwebp's
 * decoder gives it with fancy upsampling. */
int hi3d_webp_lossy(const uint8_t *data, long size, int width, int height, uint8_t *out,
                    int channels) {
    if (size < 0 || width < 1 || height < 1 || width > 16383 || height > 16383 ||
        (channels != 3 && channels != 4))
        return ERR_ARGS;
    vp8_t d;
    memset(&d, 0, sizeof d);
    d.width = width;
    d.height = height;
    d.mb_w = (width + 15) >> 4;
    d.mb_h = (height + 15) >> 4;
    int err = parse_header(&d, data, size);
    if (err) return err;
    precompute_filter_strengths(&d);
    d.ystride = 16 * d.mb_w;
    d.uvstride = 8 * d.mb_w;
    d.y = (uint8_t *)malloc((size_t)d.ystride * 16 * d.mb_h);
    d.u = (uint8_t *)malloc((size_t)d.uvstride * 8 * d.mb_h);
    d.v = (uint8_t *)malloc((size_t)d.uvstride * 8 * d.mb_h);
    d.top_y = (uint8_t *)calloc((size_t)d.mb_w + 1, 16);
    d.top_u = (uint8_t *)calloc((size_t)d.mb_w, 8);
    d.top_v = (uint8_t *)calloc((size_t)d.mb_w, 8);
    d.intra_t = (uint8_t *)malloc(4 * (size_t)d.mb_w);
    d.nz_top = (uint8_t *)calloc((size_t)d.mb_w, 1);
    d.nz_dc_top = (uint8_t *)calloc((size_t)d.mb_w, 1);
    mb_t *mbs = (mb_t *)malloc(sizeof(mb_t) * (size_t)d.mb_w);
    uint8_t yuv_b[BPS * 26];
    if (!d.y || !d.u || !d.v || !d.top_y || !d.top_u || !d.top_v || !d.intra_t || !d.nz_top ||
        !d.nz_dc_top || !mbs) {
        err = ERR_MEMORY;
        goto done;
    }
    memset(d.intra_t, B_DC_PRED, 4 * (size_t)d.mb_w);
    memset(yuv_b, 0, sizeof yuv_b);
    for (int mb_y = 0; mb_y < d.mb_h && !err; ++mb_y) {
        bool_t *tokens = &d.parts[mb_y & (d.num_parts - 1)];
        memset(d.intra_l, B_DC_PRED, 4);
        for (int mb_x = 0; mb_x < d.mb_w; ++mb_x) parse_intra_mode(&d, &mbs[mb_x], mb_x);
        if (d.br.eof) { err = ERR_TRUNCATED; break; }
        d.nz_left = d.nz_dc_left = 0;
        for (int mb_x = 0; mb_x < d.mb_w; ++mb_x) {
            mb_t *mb = &mbs[mb_x];
            int skip = mb->skip;
            if (!skip) {
                skip = parse_residuals(&d, mb, mb_x, tokens);
            } else {
                d.nz_left = d.nz_top[mb_x] = 0;
                if (!mb->is_i4x4) d.nz_dc_left = d.nz_dc_top[mb_x] = 0;
                memset(mb->coeffs, 0, sizeof mb->coeffs);
            }
            mb->inner = mb->is_i4x4 | !skip;
            if (tokens->eof) { err = ERR_TRUNCATED; break; }
        }
        if (err) break;
        reconstruct_row(&d, mbs, mb_y, yuv_b);
        if (d.filter_type)
            for (int mb_x = 0; mb_x < d.mb_w; ++mb_x)
                filter_mb(&d, &d.fstrengths[mbs[mb_x].segment][mbs[mb_x].is_i4x4],
                          mbs[mb_x].inner, mb_x, mb_y);
    }
    if (!err) emit_fancy_rgb(&d, out, channels);
    if (!err && channels == 4)
        for (long i = 0; i < (long)width * height; i++) out[4 * i + 3] = 255;
done:
    free(d.y); free(d.u); free(d.v);
    free(d.top_y); free(d.top_u); free(d.top_v);
    free(d.intra_t); free(d.nz_top); free(d.nz_dc_top);
    free(mbs);
    return err;
}
