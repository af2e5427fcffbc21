/* H.264 decoder of the intra subset h264_encode.c writes (utils/h264.py
 * binds it): the slice data of I slices coded with CAVLC, with I_PCM,
 * Intra16x16 and Intra4x4 macroblocks (flat scaling lists, no 8x8
 * transform), 4:2:0 8-bit, without the loop filter. utils/h264.py parses
 * the parameter sets and slice headers, refuses everything else, and hands
 * each slice's RBSP here with the bit position of its slice_data(); this
 * file checks its arguments again and every syntax element it reads.
 *
 * hi3d_h264_yuv_to_rgb converts the decoded planes as libswscale's unscaled
 * yuv420p -> BGR24 path does (the conversion cv2's FFMPEG backend asks for,
 * with the default BT.601 limited-range matrix): its x86 SIMD arithmetic in
 * 16-bit lanes, chroma repeated over its 2x2, mulhi(a, b) = (a * b) >> 16:
 *   y = mulhi(8 Y - 128, 9539), u = 8 Cb - 1024, v = 8 Cr - 1024
 *   R = clip(y + mulhi(v, 13075))
 *   G = clip(y + mulhi(u, -3209) + mulhi(v, -6660))
 *   B = clip(y + mulhi(u, 16525))
 * The coefficients are those ff_yuv2rgb_c_init_tables rounds from
 * ff_yuv2rgb_coeffs[SWS_CS_DEFAULT] = {104597, 132201, 25675, 53279} and
 * cy = 65536 * 255 / 219, each times 2^13 and rounded to 16 bits. */

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "h264_common.h"

#define MAX_MBS 139264 /* MaxFS of level 6.2 */

typedef struct {
    const uint8_t *buf;
    long size;      /* bytes */
    long pos, end;  /* bits; end: position of rbsp_stop_one_bit */
    int err;
} BitR;

static uint32_t peek_bits(const BitR *r, int n) { /* n <= 25; zeros past the end */
    long byte = r->pos >> 3;
    uint64_t v = 0;
    for (int i = 0; i < 4; i++) v = (v << 8) | (byte + i < r->size ? r->buf[byte + i] : 0);
    return (uint32_t)(((v << (r->pos & 7)) & 0xffffffffu) >> (32 - n));
}

static uint32_t get_bits(BitR *r, int n) {
    if (n == 0) return 0;
    if (r->pos + n > r->end) {
        r->err = 1;
        r->pos = r->end;
        return 0;
    }
    uint32_t v = peek_bits(r, n);
    r->pos += n;
    return v;
}

static uint32_t get_ue(BitR *r) {
    int lz = 0;
    while (!r->err && get_bits(r, 1) == 0)
        if (++lz > 31) {
            r->err = 1;
            return 0;
        }
    if (r->err) return 0;
    uint32_t hi = lz > 16 ? get_bits(r, lz - 16) : 0;
    uint32_t lo = get_bits(r, lz > 16 ? 16 : lz);
    return (uint32_t)(((1ull << lz) - 1) + (((uint64_t)hi << 16) | lo));
}

static int get_se(BitR *r) {
    uint32_t k = get_ue(r);
    return k & 1 ? (int)((k + 1) / 2) : -(int)(k / 2);
}

/* Reads one VLC of `n` entries; returns the index or -1. */
static int get_vlc(BitR *r, const uint8_t *len, const uint8_t *bits, int n) {
    uint32_t p = peek_bits(r, 16);
    for (int i = 0; i < n; i++) {
        if (!len[i]) continue;
        if ((p >> (16 - len[i])) == bits[i]) {
            if (r->pos + len[i] > r->end) break;
            r->pos += len[i];
            return i;
        }
    }
    r->err = 1;
    return -1;
}

typedef struct {
    int mb_w, mb_h, s, qp, cqp_offset;
    uint8_t *y, *u, *v;
    MbInfo *mb;
    char *msg;
    int msg_cap;
} Dec;

static int fail(Dec *d, int mbaddr, const char *what) {
    if (d->msg && d->msg_cap > 0) snprintf(d->msg, (size_t)d->msg_cap, "macroblock %d: %s", mbaddr, what);
    return -1;
}

/* residual_block_cavlc into `coef` (raster of the 4x4 block, or the 4
 * chroma DC levels in order) at scan positions start..start+maxnum-1.
 * Returns TotalCoeff or -1. */
static int read_block(BitR *r, int *coef, int start, int maxnum, int nc, int dc2x2) {
    int tok;
    if (nc < 0) tok = get_vlc(r, CHROMA_DC_TOKEN_LEN, CHROMA_DC_TOKEN_BITS, 4 * 5);
    else tok = get_vlc(r, COEFF_TOKEN_LEN[nc_class(nc)], COEFF_TOKEN_BITS[nc_class(nc)], 4 * 17);
    if (tok < 0) return -1;
    int total = tok >> 2, t1 = tok & 3;
    if (total > maxnum) return -1;
    if (!total) return 0;
    int level[16], run[16];
    for (int i = 0; i < t1; i++) level[i] = get_bits(r, 1) ? -1 : 1;
    int sl = total > 10 && t1 < 3 ? 1 : 0;
    for (int i = t1; i < total; i++) {
        int prefix = 0;
        while (!r->err && get_bits(r, 1) == 0)
            if (++prefix > 15) return -1; /* Baseline: level_prefix <= 15 */
        if (r->err) return -1;
        int code = (prefix < 15 ? prefix : 15) << sl;
        int ssize = prefix == 14 && sl == 0 ? 4 : prefix >= 15 ? prefix - 3 : sl;
        if (sl > 0 || prefix >= 14) code += (int)get_bits(r, ssize);
        if (prefix >= 15 && sl == 0) code += 15;
        if (i == t1 && t1 < 3) code += 2;
        level[i] = code & 1 ? (-code - 1) >> 1 : (code + 2) >> 1;
        if (sl == 0) sl = 1;
        if ((level[i] < 0 ? -level[i] : level[i]) > (3 << (sl - 1)) && sl < 6) sl++;
    }
    int zeros = 0;
    if (total < maxnum) {
        if (nc < 0) zeros = get_vlc(r, CHROMA_DC_ZEROS_LEN[total - 1], CHROMA_DC_ZEROS_BITS[total - 1], 5 - total);
        else zeros = get_vlc(r, TOTAL_ZEROS_LEN[total - 1], TOTAL_ZEROS_BITS[total - 1], 17 - total);
        if (zeros < 0 || zeros > maxnum - total) return -1;
    }
    int left = zeros;
    for (int i = 0; i < total - 1; i++) {
        if (left > 0) {
            int k = left > 7 ? 6 : left - 1;
            run[i] = get_vlc(r, RUN_LEN[k], RUN_BITS[k], k < 6 ? k + 2 : 15);
            if (run[i] < 0 || run[i] > left) return -1;
            left -= run[i];
        } else {
            run[i] = 0;
        }
    }
    run[total - 1] = left;
    if (r->err) return -1;
    int pos = -1;
    for (int i = total - 1; i >= 0; i--) {
        pos += run[i] + 1;
        int k = start + pos;
        coef[dc2x2 ? k : ZIGZAG[k]] = level[i];
    }
    return total;
}

static int check_avail(Dec *d, int addr, int needs, int avail, const char *what) {
    if ((needs & avail) != needs) return fail(d, addr, what);
    return 0;
}

static int decode_mb(Dec *d, BitR *r, int mx, int my, int first_mb) {
    int addr = my * d->mb_w + mx, s = d->s, cs = d->s / 2;
    int avail = mb_availability(mx, my, d->mb_w, first_mb);
    MbInfo *cur = &d->mb[addr];
    const MbInfo *lm = (avail & 2) ? cur - 1 : NULL;
    const MbInfo *tm = (avail & 1) ? cur - d->mb_w : NULL;
    memset(cur, 0, sizeof(*cur));
    memset(cur->i4, I4_DC, sizeof(cur->i4));
    uint32_t mb_type = get_ue(r);
    if (r->err || mb_type > 25) return fail(d, addr, r->err ? "truncated mb_type" : "mb_type above 25 in an I slice");
    if (mb_type == 25) {
        r->pos = (r->pos + 7) & ~7L;
        if (r->pos + 384 * 8 > r->end) return fail(d, addr, "truncated I_PCM samples");
        const uint8_t *p = r->buf + (r->pos >> 3);
        for (int y = 0; y < 16; y++) memcpy(d->y + (my * 16 + y) * s + mx * 16, p + 16 * y, 16);
        for (int y = 0; y < 8; y++) memcpy(d->u + (my * 8 + y) * cs + mx * 8, p + 256 + 8 * y, 8);
        for (int y = 0; y < 8; y++) memcpy(d->v + (my * 8 + y) * cs + mx * 8, p + 320 + 8 * y, 8);
        r->pos += 384 * 8;
        cur->type = MB_PCM;
        memset(cur->nz, 16, sizeof(cur->nz));
        memset(cur->nzc, 16, sizeof(cur->nzc));
        return 0;
    }
    int m16 = 0, cbp;
    if (mb_type == 0) {
        cur->type = MB_I4;
        for (int b = 0; b < 16; b++) {
            int bx = BLK_X[b], by = BLK_Y[b];
            int pm = predicted_i4_mode(cur, lm, tm, bx, by);
            int m = pm;
            if (!get_bits(r, 1)) {
                m = (int)get_bits(r, 3);
                if (m >= pm) m++;
            }
            cur->i4[4 * by + bx] = (int8_t)m;
        }
    } else {
        cur->type = MB_I16;
        m16 = (mb_type - 1) % 4;
    }
    uint32_t cmode = get_ue(r);
    if (cmode > 3) return fail(d, addr, "intra_chroma_pred_mode above 3");
    if (mb_type == 0) {
        uint32_t code = get_ue(r);
        if (code > 47) return fail(d, addr, "coded_block_pattern above 47");
        cbp = INTRA_CBP[code];
    } else {
        cbp = (((mb_type - 1) / 4) % 3) << 4 | (mb_type >= 13 ? 15 : 0);
    }
    if (cbp || mb_type != 0) {
        int dq = get_se(r);
        if (dq < -26 || dq > 25) return fail(d, addr, "mb_qp_delta outside -26..25");
        d->qp = (d->qp + dq + 52) % 52;
    }
    if (r->err) return fail(d, addr, "truncated macroblock header");
    int qp = d->qp, qpc = CHROMA_QP[qp + d->cqp_offset < 0 ? 0 : qp + d->cqp_offset > 51 ? 51 : qp + d->cqp_offset];
    int cbpl = cbp & 15, cbpc = cbp >> 4;
    int luma[16][16], dcl[16], cdc[2][4], cac[2][4][16];
    memset(luma, 0, sizeof(luma));
    memset(dcl, 0, sizeof(dcl));
    memset(cdc, 0, sizeof(cdc));
    memset(cac, 0, sizeof(cac));
    if (mb_type != 0 && read_block(r, dcl, 0, 16, luma_nc(cur, lm, tm, 0, 0), 0) < 0)
        return fail(d, addr, "bad Intra16x16 DC residual");
    for (int b = 0; b < 16; b++) {
        int bx = BLK_X[b], by = BLK_Y[b];
        if (!(cbpl & (1 << (b >> 2)))) continue;
        int n = mb_type == 0 ? read_block(r, luma[b], 0, 16, luma_nc(cur, lm, tm, bx, by), 0)
                             : read_block(r, luma[b], 1, 15, luma_nc(cur, lm, tm, bx, by), 0);
        if (n < 0) return fail(d, addr, "bad luma residual");
        cur->nz[4 * by + bx] = (uint8_t)n;
    }
    if (cbpc)
        for (int k = 0; k < 2; k++)
            if (read_block(r, cdc[k], 0, 4, -1, 1) < 0) return fail(d, addr, "bad chroma DC residual");
    if (cbpc == 2)
        for (int k = 0; k < 2; k++)
            for (int b = 0; b < 4; b++) {
                int n = read_block(r, cac[k][b], 1, 15, chroma_nc(cur, lm, tm, k, b & 1, b >> 1), 0);
                if (n < 0) return fail(d, addr, "bad chroma AC residual");
                cur->nzc[k][b] = (uint8_t)n;
            }
    if (r->err) return fail(d, addr, "truncated residual");

    /* luma */
    if (mb_type == 0) {
        for (int b = 0; b < 16; b++) {
            int bx = BLK_X[b], by = BLK_Y[b], tl, dd[16], rr[16];
            uint8_t top[8], left[4], pred[16];
            int av = neighbours4x4(d->y, s, mx, my, bx, by, avail, top, left, &tl);
            int m = cur->i4[4 * by + bx];
            if (check_avail(d, addr, I4_NEEDS[m], av, "Intra4x4 mode reads unavailable samples")) return -1;
            pred4x4(m, top, left, tl, av, pred);
            dequant4x4(luma[b], dd, qp, 0);
            idct4x4(dd, rr);
            uint8_t *o = d->y + (my * 16 + by * 4) * s + mx * 16 + bx * 4;
            for (int i = 0; i < 16; i++) o[(i >> 2) * s + (i & 3)] = clip1(pred[i] + rr[i]);
        }
    } else {
        uint8_t top[16], left[16], pred[256];
        int tl, dc[16];
        neighbours_mb(d->y, s, mx * 16, my * 16, 16, avail, top, left, &tl);
        if (check_avail(d, addr, I16_NEEDS[m16], avail, "Intra16x16 mode reads unavailable samples")) return -1;
        pred16x16(m16, top, left, tl, avail, pred);
        luma_dc_dequant(dcl, dc, qp);
        for (int b = 0; b < 16; b++) {
            int bx = BLK_X[b], by = BLK_Y[b], dd[16], rr[16];
            dequant4x4(luma[b], dd, qp, 1);
            dd[0] = dc[4 * by + bx];
            idct4x4(dd, rr);
            uint8_t *o = d->y + (my * 16 + by * 4) * s + mx * 16 + bx * 4;
            for (int i = 0; i < 16; i++) o[(i >> 2) * s + (i & 3)] = clip1(pred[(by * 4 + (i >> 2)) * 16 + bx * 4 + (i & 3)] + rr[i]);
        }
    }
    /* chroma */
    if (check_avail(d, addr, IC_NEEDS[cmode], avail, "chroma mode reads unavailable samples")) return -1;
    for (int k = 0; k < 2; k++) {
        uint8_t *p = k ? d->v : d->u, top[8], left[8], pred[64];
        int tl, dc[4];
        neighbours_mb(p, cs, mx * 8, my * 8, 8, avail, top, left, &tl);
        pred_chroma((int)cmode, top, left, tl, avail, pred);
        chroma_dc_dequant(cdc[k], dc, qpc);
        for (int b = 0; b < 4; b++) {
            int x0 = (b & 1) * 4, y0 = (b >> 1) * 4, dd[16], rr[16];
            dequant4x4(cac[k][b], dd, qpc, 1);
            dd[0] = dc[b];
            idct4x4(dd, rr);
            uint8_t *o = p + (my * 8 + y0) * cs + mx * 8 + x0;
            for (int i = 0; i < 16; i++) o[(i >> 2) * cs + (i & 3)] = clip1(pred[(y0 + (i >> 2)) * 8 + x0 + (i & 3)] + rr[i]);
        }
    }
    return 0;
}

/* Decodes the slice_data() of one I slice (CAVLC) whose RBSP is
 * rbsp[0..size) and whose data starts at bit `bit_pos`, from macroblock
 * `first_mb` at slice QP `qp`, into the picture planes y (mb_h*16 rows of
 * mb_w*16), u and v (half each way). mb_slice (mb_w*mb_h, -1 where not yet
 * decoded) gets `slice_num` for every macroblock decoded; *end_mb the
 * address after the last. Returns 0, -1 for a bitstream error (described in
 * msg), -2 out of memory, -5 bad argument, -6 a macroblock decoded twice. */
int hi3d_h264_decode_slice(const uint8_t *rbsp, long size, long bit_pos, int mb_w, int mb_h, int first_mb,
                           int qp, int cqp_offset, int slice_num, int32_t *mb_slice,
                           uint8_t *y, uint8_t *u, uint8_t *v, int *end_mb, char *msg, int msg_cap) {
    if (!rbsp || !mb_slice || !y || !u || !v || !end_mb || size <= 0 || bit_pos < 0 || bit_pos > size * 8) return -5;
    if (mb_w < 1 || mb_h < 1 || mb_w > 1024 || mb_h > 1024 || (long)mb_w * mb_h > MAX_MBS) return -5;
    if (first_mb < 0 || first_mb >= mb_w * mb_h || qp < 0 || qp > 51 || cqp_offset < -12 || cqp_offset > 12) return -5;
    Dec d = {mb_w, mb_h, mb_w * 16, qp, cqp_offset, y, u, v, NULL, msg, msg_cap};
    if (msg && msg_cap > 0) msg[0] = 0;
    BitR r = {rbsp, size, bit_pos, 0, 0};
    long last = size - 1;
    while (last >= 0 && rbsp[last] == 0) last--;
    if (last < 0) return fail(&d, first_mb, "slice RBSP without rbsp_stop_one_bit");
    int tz = 0;
    while (!((rbsp[last] >> tz) & 1)) tz++;
    r.end = last * 8 + 7 - tz;
    if (r.end < bit_pos) return fail(&d, first_mb, "slice header runs past rbsp_stop_one_bit");
    d.mb = calloc((size_t)mb_w * mb_h, sizeof(MbInfo));
    if (!d.mb) return -2;
    int addr = first_mb, rc = 0;
    do {
        if (addr >= mb_w * mb_h) {
            rc = fail(&d, addr, "slice data past the last macroblock");
            break;
        }
        if (mb_slice[addr] != -1) {
            rc = -6;
            fail(&d, addr, "decoded by two slices");
            break;
        }
        if (decode_mb(&d, &r, addr % mb_w, addr / mb_w, first_mb) < 0) {
            rc = -1;
            break;
        }
        mb_slice[addr] = slice_num;
        addr++;
    } while (r.pos < r.end);
    *end_mb = addr;
    free(d.mb);
    return rc;
}

/* Planes (y: h x w of stride ys; u, v: h/2 x w/2 of stride cs) -> RGB
 * (h x w x 3, contiguous). Returns 0, -5 for a bad argument. */
static inline int mulhi16(int a, int b) { return (a * b) >> 16; }

int hi3d_h264_yuv_to_rgb(const uint8_t *y, const uint8_t *u, const uint8_t *v, int w, int h, int ys, int cs,
                         uint8_t *rgb) {
    if (!y || !u || !v || !rgb || w < 2 || h < 2 || (w & 1) || (h & 1) || ys < w || cs < w / 2) return -5;
    for (int j = 0; j < h; j++) {
        const uint8_t *py = y + (long)j * ys, *pu = u + (long)(j >> 1) * cs, *pv = v + (long)(j >> 1) * cs;
        uint8_t *o = rgb + (long)j * w * 3;
        for (int i = 0; i < w; i += 2, o += 6) {
            int cu = pu[i >> 1] * 8 - 1024, cv = pv[i >> 1] * 8 - 1024;
            int r = mulhi16(cv, 13075), g = mulhi16(cu, -3209) + mulhi16(cv, -6660), b = mulhi16(cu, 16525);
            for (int k = 0; k < 2; k++) {
                int l = mulhi16(py[i + k] * 8 - 128, 9539);
                o[3 * k] = clip1(l + r);
                o[3 * k + 1] = clip1(l + g);
                o[3 * k + 2] = clip1(l + b);
            }
        }
    }
    return 0;
}
