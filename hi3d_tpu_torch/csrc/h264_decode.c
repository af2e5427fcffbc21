/* H.264 decoder of the Constrained Baseline subset h264_encode.c writes
 * (utils/h264.py binds it): the slice data of I and P slices coded with
 * CAVLC. I slices hold I_PCM, Intra16x16 and Intra4x4 macroblocks (flat
 * scaling lists, no 8x8 transform); P slices add mb_skip_run, P_L0_16x16,
 * 16x8, 8x16, P_8x8 and P_8x8ref0 with the sub-macroblock types 8x8, 8x4,
 * 4x8 and 4x4, refIdxL0 as te(v), motion vector prediction (8.4.1) and
 * quarter-sample interpolation from the reference list utils/h264.py builds,
 * and intra macroblocks. 4:2:0 8-bit. The deblocking filter runs over a
 * picture once its last slice is decoded (hi3d_h264_deblock). utils/h264.py
 * parses the parameter sets and slice headers, refuses everything else, and
 * hands each slice's RBSP here with the bit position of its slice_data();
 * this file checks its arguments again and every syntax element it reads.
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
    int slice_num, filter_idc, filter_a, filter_b;
    int nref;                /* entries of refs (RefPicList0) */
    const RefPic *refs;
    const int32_t *ref_ids;  /* the picture of each entry, for the filter's bS */
    uint8_t *y, *u, *v;
    MbInfo *mb;
    int64_t *counts;
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

/* The levels of one macroblock's residual() */
typedef struct {
    int luma[16][16], dcl[16], cdc[2][4], cac[2][4][16];
} Residual;

/* mb_qp_delta (where present) and residual() of the macroblock `cur`;
 * i16: an Intra16x16 macroblock (its DC block, AC from scan position 1). */
static int read_residual(Dec *d, BitR *r, int addr, MbInfo *cur, const Nbrs *nb, int i16, int cbp, Residual *res) {
    if (cbp || i16) {
        int dq = get_se(r);
        if (dq < -26 || dq > 25) return fail(d, addr, "mb_qp_delta outside -26..25");
        d->qp = (d->qp + dq + 52) % 52;
    }
    if (r->err) return fail(d, addr, "truncated macroblock header");
    cur->qp = (int8_t)d->qp;
    int cbpl = cbp & 15, cbpc = cbp >> 4;
    memset(res, 0, sizeof(*res));
    if (i16 && read_block(r, res->dcl, 0, 16, luma_nc(cur, nb->a, nb->b, 0, 0), 0) < 0)
        return fail(d, addr, "bad Intra16x16 DC residual");
    for (int b = 0; b < 16; b++) {
        int bx = BLK_X[b], by = BLK_Y[b];
        if (!(cbpl & (1 << (b >> 2)))) continue;
        int nc = luma_nc(cur, nb->a, nb->b, bx, by);
        int n = i16 ? read_block(r, res->luma[b], 1, 15, nc, 0) : read_block(r, res->luma[b], 0, 16, nc, 0);
        if (n < 0) return fail(d, addr, "bad luma residual");
        cur->nz[4 * by + bx] = (uint8_t)n;
    }
    if (cbpc)
        for (int k = 0; k < 2; k++)
            if (read_block(r, res->cdc[k], 0, 4, -1, 1) < 0) return fail(d, addr, "bad chroma DC residual");
    if (cbpc == 2)
        for (int k = 0; k < 2; k++)
            for (int b = 0; b < 4; b++) {
                int n = read_block(r, res->cac[k][b], 1, 15, chroma_nc(cur, nb->a, nb->b, k, b & 1, b >> 1), 0);
                if (n < 0) return fail(d, addr, "bad chroma AC residual");
                cur->nzc[k][b] = (uint8_t)n;
            }
    if (r->err) return fail(d, addr, "truncated residual");
    return 0;
}

/* Both chroma blocks of the macroblock at (mx, my): prediction plus residual */
static void recon_chroma(Dec *d, int mx, int my, uint8_t (*pred)[64], const Residual *res) {
    int cs = d->s / 2, qpc = chroma_qp_of(d->qp, d->cqp_offset);
    for (int k = 0; k < 2; k++) {
        uint8_t *p = k ? d->v : d->u;
        int dc[4];
        chroma_dc_dequant(res->cdc[k], dc, qpc);
        for (int b = 0; b < 4; b++) {
            int x0 = (b & 1) * 4, y0 = (b >> 1) * 4, dd[16], rr[16];
            dequant4x4(res->cac[k][b], dd, qpc, 1);
            dd[0] = dc[b];
            idct4x4(dd, rr);
            uint8_t *o = p + (long)(my * 8 + y0) * cs + mx * 8 + x0;
            for (int i = 0; i < 16; i++) o[(i >> 2) * cs + (i & 3)] = clip1(pred[k][(y0 + (i >> 2)) * 8 + x0 + (i & 3)] + rr[i]);
        }
    }
}

/* Sets the slice's fields of a macroblock about to be decoded. */
static MbInfo *begin_mb(Dec *d, int addr) {
    MbInfo *cur = &d->mb[addr];
    memset(cur, 0, sizeof(*cur));
    memset(cur->i4, I4_DC, sizeof(cur->i4));
    memset(cur->ref, -1, sizeof(cur->ref));
    for (int i = 0; i < 4; i++) cur->refpic[i] = -1;
    cur->qp = (int8_t)d->qp;
    cur->slice = d->slice_num;
    cur->filter_idc = (int8_t)d->filter_idc;
    cur->filter_a = (int8_t)d->filter_a;
    cur->filter_b = (int8_t)d->filter_b;
    return cur;
}

/* Motion compensation and residual of an inter macroblock whose motion
 * data `cur` holds. */
static void recon_inter(Dec *d, int mx, int my, const MbInfo *cur, const Residual *res) {
    uint8_t pred[256], predc[2][64];
    int s = d->s;
    predict_mb(d->refs, mx, my, cur, pred, predc);
    for (int b = 0; b < 16; b++) {
        int bx = BLK_X[b], by = BLK_Y[b], dd[16], rr[16];
        dequant4x4(res->luma[b], dd, d->qp, 0);
        idct4x4(dd, rr);
        uint8_t *o = d->y + (long)(my * 16 + by * 4) * s + mx * 16 + bx * 4;
        for (int i = 0; i < 16; i++) o[(i >> 2) * s + (i & 3)] = clip1(pred[(by * 4 + (i >> 2)) * 16 + bx * 4 + (i & 3)] + rr[i]);
    }
    recon_chroma(d, mx, my, predc, res);
}

/* P_Skip at (mx, my) */
static void decode_skip(Dec *d, int mx, int my, int first_mb) {
    int addr = my * d->mb_w + mx, avail = mb_availability(mx, my, d->mb_w, first_mb), mv[2];
    MbInfo *cur = begin_mb(d, addr);
    Nbrs nb = neighbours_of(d->mb, d->mb_w, mx, my, avail);
    cur->type = MB_INTER;
    pskip_mv(cur, &nb, mv);
    set_motion(cur, 0, 0, 16, 16, 0, d->ref_ids[0], mv);
    static const Residual zero;
    recon_inter(d, mx, my, cur, &zero);
    d->counts[ST_SKIP]++;
    count_partition(d->counts, &d->refs[0], mx * 16, my * 16, 16, 16, mv);
}

/* The motion data (mb_pred or sub_mb_pred) and residual of a P macroblock
 * of mb_type 0-4. */
static int decode_inter(Dec *d, BitR *r, int mx, int my, int mb_type, MbInfo *cur, const Nbrs *nb) {
    int addr = my * d->mb_w + mx;
    int nparts = P_PARTS[mb_type][0], sub[4] = {0, 0, 0, 0}, ref[4] = {0, 0, 0, 0}, mvd[16][2];
    cur->type = MB_INTER;
    d->counts[ST_P16x16 + mb_type]++;
    if (nparts == 4)
        for (int i = 0; i < 4; i++) {
            uint32_t t = get_ue(r);
            if (t > 3) return fail(d, addr, r->err ? "truncated sub_mb_type" : "sub_mb_type above 3 in a P slice");
            sub[i] = (int)t;
            d->counts[ST_SUB8x8 + t]++;
        }
    if (d->nref > 1 && mb_type != P_8x8REF0)
        for (int i = 0; i < nparts; i++) {
            uint32_t v;
            if (d->nref == 2) { /* te(v) with cMax 1: one inverted bit */
                v = !get_bits(r, 1);
                d->counts[ST_TE_BIT]++;
            } else {
                v = get_ue(r);
                d->counts[ST_TE_UE]++;
            }
            if (r->err || (int)v >= d->nref) return fail(d, addr, "ref_idx_l0 past num_ref_idx_l0_active");
            if (!d->refs[v].y) return fail(d, addr, "ref_idx_l0 names no reference picture");
            ref[i] = (int)v;
            d->counts[ST_REF_NONZERO] += v > 0;
        }
    int nmvd = 0;
    for (int i = 0; i < nparts; i++)
        for (int j = 0; j < sub_parts(mb_type, sub, i); j++, nmvd++) {
            mvd[nmvd][0] = get_se(r);
            mvd[nmvd][1] = get_se(r);
            if (mvd[nmvd][0] < -8192 || mvd[nmvd][0] > 8191 || mvd[nmvd][1] < -8192 || mvd[nmvd][1] > 8191)
                return fail(d, addr, "mvd outside -8192..8191");
        }
    if (r->err) return fail(d, addr, "truncated motion data");
    nmvd = 0;
    for (int i = 0; i < nparts; i++)
        for (int j = 0; j < sub_parts(mb_type, sub, i); j++, nmvd++) {
            int pr[4], mvp[2], mv[2];
            part_rect(mb_type, sub, i, j, pr);
            predict_mv(cur, nb, pr[0], pr[1], pr[2], nparts == 2 ? mb_type : P_16x16, i, ref[i], mvp);
            mv[0] = mvp[0] + mvd[nmvd][0];
            mv[1] = mvp[1] + mvd[nmvd][1];
            if (mv[0] < -32768 || mv[0] > 32767 || mv[1] < -32768 || mv[1] > 32767)
                return fail(d, addr, "motion vector outside -32768..32767");
            set_motion(cur, pr[0], pr[1], pr[2], pr[3], ref[i], d->ref_ids[ref[i]], mv);
            count_partition(d->counts, &d->refs[0], mx * 16 + pr[0], my * 16 + pr[1], pr[2], pr[3], mv);
        }
    uint32_t code = get_ue(r);
    if (r->err || code > 47) return fail(d, addr, r->err ? "truncated coded_block_pattern" : "coded_block_pattern above 47");
    Residual res;
    if (read_residual(d, r, addr, cur, nb, 0, INTER_CBP[code], &res) < 0) return -1;
    recon_inter(d, mx, my, cur, &res);
    return 0;
}

static int decode_mb(Dec *d, BitR *r, int mx, int my, int first_mb, int p_slice) {
    int addr = my * d->mb_w + mx, s = d->s, cs = d->s / 2;
    int avail = mb_availability(mx, my, d->mb_w, first_mb);
    MbInfo *cur = begin_mb(d, addr);
    Nbrs nb = neighbours_of(d->mb, d->mb_w, mx, my, avail);
    const MbInfo *lm = nb.a, *tm = nb.b;
    uint32_t mb_type = get_ue(r);
    if (r->err) return fail(d, addr, "truncated mb_type");
    if (p_slice) {
        if (mb_type < 5) return decode_inter(d, r, mx, my, (int)mb_type, cur, &nb);
        mb_type -= 5;
        d->counts[ST_INTRA_IN_P]++;
    }
    if (mb_type > 25) return fail(d, addr, p_slice ? "mb_type above 30 in a P slice" : "mb_type above 25 in an I slice");
    if (mb_type == 25) {
        r->pos = (r->pos + 7) & ~7L;
        if (r->pos + 384 * 8 > r->end) return fail(d, addr, "truncated I_PCM samples");
        const uint8_t *p = r->buf + (r->pos >> 3);
        for (int y = 0; y < 16; y++) memcpy(d->y + (long)(my * 16 + y) * s + mx * 16, p + 16 * y, 16);
        for (int y = 0; y < 8; y++) memcpy(d->u + (long)(my * 8 + y) * cs + mx * 8, p + 256 + 8 * y, 8);
        for (int y = 0; y < 8; y++) memcpy(d->v + (long)(my * 8 + y) * cs + mx * 8, p + 320 + 8 * y, 8);
        r->pos += 384 * 8;
        cur->type = MB_PCM;
        cur->qp = 0; /* the loop filter's qP of I_PCM; the QP prediction keeps d->qp */
        memset(cur->nz, 16, sizeof(cur->nz));
        memset(cur->nzc, 16, sizeof(cur->nzc));
        d->counts[ST_PCM]++;
        return 0;
    }
    int m16 = 0, cbp;
    if (mb_type == 0) {
        cur->type = MB_I4;
        d->counts[ST_I4]++;
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
        d->counts[ST_I16]++;
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
    Residual res;
    if (read_residual(d, r, addr, cur, &nb, mb_type != 0, cbp, &res) < 0) return -1;
    int qp = d->qp;

    /* luma */
    if (mb_type == 0) {
        for (int b = 0; b < 16; b++) {
            int bx = BLK_X[b], by = BLK_Y[b], tl, dd[16], rr[16];
            uint8_t top[8], left[4], pred[16];
            int av = neighbours4x4(d->y, s, mx, my, bx, by, avail, top, left, &tl);
            int m = cur->i4[4 * by + bx];
            if (check_avail(d, addr, I4_NEEDS[m], av, "Intra4x4 mode reads unavailable samples")) return -1;
            pred4x4(m, top, left, tl, av, pred);
            dequant4x4(res.luma[b], dd, qp, 0);
            idct4x4(dd, rr);
            uint8_t *o = d->y + (long)(my * 16 + by * 4) * s + mx * 16 + bx * 4;
            for (int i = 0; i < 16; i++) o[(i >> 2) * s + (i & 3)] = clip1(pred[i] + rr[i]);
        }
    } else {
        uint8_t top[16], left[16], pred[256];
        int tl, dc[16];
        neighbours_mb(d->y, s, mx * 16, my * 16, 16, avail, top, left, &tl);
        if (check_avail(d, addr, I16_NEEDS[m16], avail, "Intra16x16 mode reads unavailable samples")) return -1;
        pred16x16(m16, top, left, tl, avail, pred);
        luma_dc_dequant(res.dcl, dc, qp);
        for (int b = 0; b < 16; b++) {
            int bx = BLK_X[b], by = BLK_Y[b], dd[16], rr[16];
            dequant4x4(res.luma[b], dd, qp, 1);
            dd[0] = dc[4 * by + bx];
            idct4x4(dd, rr);
            uint8_t *o = d->y + (long)(my * 16 + by * 4) * s + mx * 16 + bx * 4;
            for (int i = 0; i < 16; i++) o[(i >> 2) * s + (i & 3)] = clip1(pred[(by * 4 + (i >> 2)) * 16 + bx * 4 + (i & 3)] + rr[i]);
        }
    }
    /* chroma */
    if (check_avail(d, addr, IC_NEEDS[cmode], avail, "chroma mode reads unavailable samples")) return -1;
    uint8_t predc[2][64];
    for (int k = 0; k < 2; k++) {
        uint8_t top[8], left[8];
        int tl;
        neighbours_mb(k ? d->v : d->u, cs, mx * 8, my * 8, 8, avail, top, left, &tl);
        pred_chroma((int)cmode, top, left, tl, avail, predc[k]);
    }
    recon_chroma(d, mx, my, predc, &res);
    return 0;
}

/* Decodes the slice_data() of one I (slice_type 2) or P (0) slice (CAVLC)
 * whose RBSP is rbsp[0..size) and whose data starts at bit `bit_pos`, from
 * macroblock `first_mb` up to (not including) `limit_mb`, at slice QP `qp`,
 * into the picture planes y (mb_h*16 rows of mb_w*16), u and v (half each
 * way) and the picture's macroblock state `mbinfo` (mb_w*mb_h entries of
 * hi3d_h264_mbinfo_size() bytes, which the filter reads). filter: the
 * slice's disable_deblocking_filter_idc and FilterOffsetA/B. A P slice
 * predicts from its RefPicList0 of `nref` pictures: refs holds their y, u
 * and v planes (3 * nref, the coded size), ref_ids their picture ids.
 * mb_slice (mb_w*mb_h, -1 where not yet decoded) gets `slice_num` for every
 * macroblock decoded; counts (ST_COUNT) what the slice used; *end_mb the
 * address after the last. Returns 0, -1 for a bitstream error (described in
 * msg), -5 bad argument, -6 a macroblock decoded twice. */
int hi3d_h264_decode_slice(const uint8_t *rbsp, long size, long bit_pos, int mb_w, int mb_h, int first_mb,
                           int limit_mb, int slice_type, int qp, int cqp_offset, int filter_idc, int filter_a,
                           int filter_b, int nref, uint8_t *const *refs, const int32_t *ref_ids, int slice_num,
                           int32_t *mb_slice, void *mbinfo, uint8_t *y, uint8_t *u, uint8_t *v, int64_t *counts,
                           int *end_mb, char *msg, int msg_cap) {
    if (!rbsp || !mb_slice || !mbinfo || !y || !u || !v || !counts || !end_mb || size <= 0 || bit_pos < 0 ||
        bit_pos > size * 8)
        return -5;
    if (mb_w < 1 || mb_h < 1 || mb_w > 1024 || mb_h > 1024 || (long)mb_w * mb_h > MAX_MBS) return -5;
    if (first_mb < 0 || first_mb >= mb_w * mb_h || limit_mb <= first_mb || limit_mb > mb_w * mb_h) return -5;
    if (qp < 0 || qp > 51 || cqp_offset < -12 || cqp_offset > 12) return -5;
    if (filter_idc < 0 || filter_idc > 2 || filter_a < -12 || filter_a > 12 || filter_b < -12 || filter_b > 12) return -5;
    if ((slice_type != 0 && slice_type != 2) || (slice_type == 0 && (nref < 1 || nref > 32 || !refs || !ref_ids)))
        return -5;
    RefPic rp[32];
    for (int i = 0; slice_type == 0 && i < nref; i++) { /* entries past the pictures there are: NULL */
        if (!refs[3 * i] != !refs[3 * i + 1] || !refs[3 * i] != !refs[3 * i + 2]) return -5;
        RefPic p = {refs[3 * i], refs[3 * i + 1], refs[3 * i + 2], mb_w * 16, mb_h * 16, mb_w * 16};
        rp[i] = p;
    }
    if (slice_type == 0 && !rp[0].y) return -5;
    Dec d = {mb_w, mb_h, mb_w * 16, qp, cqp_offset, slice_num, filter_idc, filter_a, filter_b,
             slice_type == 0 ? nref : 0, rp, ref_ids, y, u, v, (MbInfo *)mbinfo, counts, msg, msg_cap};
    if (msg && msg_cap > 0) msg[0] = 0;
    BitR r = {rbsp, size, bit_pos, 0, 0};
    long last = size - 1;
    while (last >= 0 && rbsp[last] == 0) last--;
    if (last < 0) return fail(&d, first_mb, "slice RBSP without rbsp_stop_one_bit");
    int tz = 0;
    while (!((rbsp[last] >> tz) & 1)) tz++;
    r.end = last * 8 + 7 - tz;
    if (r.end < bit_pos) return fail(&d, first_mb, "slice header runs past rbsp_stop_one_bit");
    int addr = first_mb, more = 1;
    while (more) {
        if (slice_type == 0) {
            uint32_t run = get_ue(&r);
            if (r.err) return fail(&d, addr, "truncated mb_skip_run");
            if (run > (uint32_t)(limit_mb - addr)) return fail(&d, addr, "mb_skip_run past the slice's macroblocks");
            if (run && addr % mb_w + (int)run > mb_w) counts[ST_SKIP_RUN_WRAP]++;
            for (uint32_t i = 0; i < run; i++, addr++) {
                if (mb_slice[addr] != -1) {
                    fail(&d, addr, "decoded by two slices");
                    *end_mb = addr;
                    return -6;
                }
                decode_skip(&d, addr % mb_w, addr / mb_w, first_mb);
                mb_slice[addr] = slice_num;
            }
            if (run && r.pos >= r.end) {
                counts[ST_SKIP_RUN_END]++;
                break;
            }
        }
        if (addr >= limit_mb) {
            *end_mb = addr;
            return fail(&d, addr, "slice data past its last macroblock");
        }
        if (mb_slice[addr] != -1) {
            fail(&d, addr, "decoded by two slices");
            *end_mb = addr;
            return -6;
        }
        if (decode_mb(&d, &r, addr % mb_w, addr / mb_w, first_mb, slice_type == 0) < 0) {
            *end_mb = addr;
            return -1;
        }
        mb_slice[addr] = slice_num;
        addr++;
        more = r.pos < r.end;
    }
    *end_mb = addr;
    return 0;
}

/* sizeof(MbInfo): the bytes a macroblock takes in hi3d_h264_decode_slice's
 * and hi3d_h264_deblock's `mbinfo` */
int hi3d_h264_mbinfo_size(void) { return (int)sizeof(MbInfo); }

/* The deblocking filter over a decoded picture (planes of the coded size,
 * mb_w x mb_h macroblocks, every one decoded into mbinfo), in place;
 * counts the edges it filtered by bS. Returns 0, -5 for a bad argument. */
int hi3d_h264_deblock(uint8_t *y, uint8_t *u, uint8_t *v, int mb_w, int mb_h, const void *mbinfo, int cqp_offset,
                      int64_t *counts) {
    if (!y || !u || !v || !mbinfo || mb_w < 1 || mb_h < 1 || (long)mb_w * mb_h > MAX_MBS || cqp_offset < -12 ||
        cqp_offset > 12)
        return -5;
    deblock_picture(y, u, v, mb_w, mb_h, (const MbInfo *)mbinfo, cqp_offset, counts);
    return 0;
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
