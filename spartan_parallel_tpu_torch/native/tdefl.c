/* tdefl.c — a from-scratch C implementation of the miniz "tdefl"
 * DEFLATE compressor algorithm (zlib container, one-shot), written for
 * divergence D1 (PARITY.md): the reference computes its instance digest
 * with flate2's rust_backend = miniz_oxide (Cargo.toml:31,51;
 * src/r1csinstance.rs:218-222), which is a port of miniz's tdefl — an
 * ALGORITHM-level different DEFLATE than CPython's madler zlib, so the
 * two produce different (both valid) streams for the same input+level.
 *
 * This file reimplements the tdefl algorithm faithfully: 32KB dictionary
 * with 15-bit hash chains, probe counts from the tdefl level table, lazy
 * one-step parsing with the >=128-length greedy cutoff and the
 * len==3/dist>=8K reject, 64KB LZ code buffer flushed through dynamic/
 * static/raw block selection, Moffat–Katajainen in-place code-length
 * construction with the tdefl max-code-size enforcement, and the tdefl
 * code-length RLE packing. Level 6 (flate2 Compression::default()) maps
 * to 128 probes, lazy parsing, as in miniz's s_tdefl_num_probes.
 *
 * VALIDATION LIMIT: no Rust toolchain exists in this environment, so the
 * output has not been diffed against miniz_oxide itself; tests pin this
 * implementation's output bytes (golden vectors) and assert
 * decompressibility + roundtrip via CPython zlib. See PARITY.md D1.
 *
 * Public entry (ctypes):
 *   long spartan_tdefl_zlib(const uint8_t *src, long src_len,
 *                           uint8_t *dst, long dst_cap, int level);
 * returns the number of output bytes, or -1 if dst_cap is too small.
 */

#include <stdint.h>
#include <string.h>

typedef uint8_t u8;
typedef uint16_t u16;
typedef uint32_t u32;
typedef uint64_t u64;

enum {
    LZ_DICT_SIZE = 32768,
    LZ_DICT_MASK = LZ_DICT_SIZE - 1,
    MIN_MATCH = 3,
    MAX_MATCH = 258,
    LZ_CODE_BUF_SIZE = 64 * 1024,
    OUT_BUF_SIZE = (LZ_CODE_BUF_SIZE * 13) / 10,
    LZ_HASH_BITS = 15,
    LZ_HASH_SHIFT = (LZ_HASH_BITS + 2) / 3,
    LZ_HASH_SIZE = 1 << LZ_HASH_BITS,
    MAX_HUFF_SYMBOLS_0 = 288,
    MAX_HUFF_SYMBOLS_1 = 32,
    MAX_HUFF_SYMBOLS_2 = 19,
    MAX_HUFF_SYMBOLS = 288,
    MAX_SUPPORTED_HUFF_CODESIZE = 32,
};

/* miniz s_tdefl_num_probes: probe budget per compression level 0..10 */
static const u16 s_num_probes[11] = {0,   1,   6,   32,  16, 32,
                                     128, 256, 512, 768, 1500};

static const u16 s_bitmasks[17] = {0x0000, 0x0001, 0x0003, 0x0007, 0x000F,
                                   0x001F, 0x003F, 0x007F, 0x00FF, 0x01FF,
                                   0x03FF, 0x07FF, 0x0FFF, 0x1FFF, 0x3FFF,
                                   0x7FFF, 0xFFFF};

/* DEFLATE length/distance symbol tables (computed once; identical values
 * to miniz's s_tdefl_len_sym/len_extra/small_dist_sym/... statics). */
static u8 s_len_sym_init = 0;
static u8 s_len_sym[256];        /* index: match_len - 3 -> sym - 257 +257 */
static u8 s_len_extra[256];
static u8 s_small_dist_sym[512]; /* index: dist - 1 (0..511) */
static u8 s_small_dist_extra[512];
static u8 s_large_dist_sym[128]; /* index: (dist - 1) >> 8 */
static u8 s_large_dist_extra[128];

static void init_tables(void) {
    /* length codes 257..285 (stored as the full symbol value) */
    static const int len_base[29] = {3,  4,  5,  6,  7,  8,  9,  10,
                                     11, 13, 15, 17, 19, 23, 27, 31,
                                     35, 43, 51, 59, 67, 83, 99, 115,
                                     131, 163, 195, 227, 258};
    static const int len_eb[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2,
                                   2, 2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5,
                                   0};
    static const int dist_base[30] = {
        1,    2,    3,    4,    5,    7,     9,     13,    17,   25,
        33,   49,   65,   97,   129,  193,   257,   385,   513,  769,
        1025, 1537, 2049, 3073, 4097, 6145,  8193,  12289, 16385, 24577};
    static const int dist_eb[30] = {0, 0, 0,  0,  1,  1,  2,  2,  3,  3,
                                    4, 4, 5,  5,  6,  6,  7,  7,  8,  8,
                                    9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
    int i, j;
    if (s_len_sym_init) return;
    for (i = 0; i < 256; i++) {
        int len = i + 3, sym = 28;
        for (j = 0; j < 28; j++)
            if (len < len_base[j + 1]) { sym = j; break; }
        if (len == 258) sym = 28;
        s_len_sym[i] = (u8)(sym + 257 - 256); /* stored biased: sym-256 */
        s_len_extra[i] = (u8)len_eb[sym];
    }
    /* NOTE: miniz stores len syms as full 257..285 in a u16 table; we
     * bias by -256 to fit u8 and un-bias at use sites. */
    for (i = 0; i < 512; i++) {
        int d = i + 1, sym = 29;
        for (j = 0; j < 29; j++)
            if (d < dist_base[j + 1]) { sym = j; break; }
        s_small_dist_sym[i] = (u8)sym;
        s_small_dist_extra[i] = (u8)dist_eb[sym];
    }
    for (i = 0; i < 128; i++) {
        int d = (i << 8) + 1, sym = 29; /* representative distance */
        for (j = 0; j < 29; j++)
            if (d < dist_base[j + 1]) { sym = j; break; }
        s_large_dist_sym[i] = (u8)sym;
        s_large_dist_extra[i] = (u8)dist_eb[sym];
    }
    s_len_sym_init = 1;
}

typedef struct {
    u32 m_key;
    u16 m_sym_index;
} sym_freq;

typedef struct {
    const u8 *src;
    u64 src_len, src_pos;
    u8 *out;
    long out_cap, out_len;
    int overflow;

    u32 lookahead_pos, lookahead_size, dict_size;
    u8 dict[LZ_DICT_SIZE + MAX_MATCH - 1];
    u16 hash[LZ_HASH_SIZE];
    u16 next[LZ_DICT_SIZE];

    u32 max_probes[2];
    int greedy;

    u8 lz_code_buf[LZ_CODE_BUF_SIZE];
    u8 *pLZ_code_buf, *pLZ_flags;
    u32 num_flags_left, total_lz_bytes;
    u32 lz_code_buf_dict_pos;

    u16 huff_count[3][MAX_HUFF_SYMBOLS];
    u16 huff_codes[3][MAX_HUFF_SYMBOLS];
    u8 huff_code_sizes[3][MAX_HUFF_SYMBOLS];

    u32 bit_buffer, bits_in;
    u8 output_buf[OUT_BUF_SIZE];
    u8 *pOutput_buf, *pOutput_buf_end;
    u32 saved_match_dist, saved_match_len, saved_lit;
    u32 block_index;
    u32 adler32;
} tdefl;

static void put_bits(tdefl *d, u32 bits, u32 len) {
    d->bit_buffer |= bits << d->bits_in;
    d->bits_in += len;
    while (d->bits_in >= 8) {
        if (d->pOutput_buf < d->pOutput_buf_end)
            *d->pOutput_buf++ = (u8)d->bit_buffer;
        d->bit_buffer >>= 8;
        d->bits_in -= 8;
    }
}

/* ---- Huffman construction (tdefl_optimize_huffman_table et al.) ---- */
static sym_freq *radix_sort_syms(u32 num_syms, sym_freq *syms0,
                                 sym_freq *syms1) {
    u32 total_passes = 2, pass_shift, pass, i, hist[256 * 2];
    sym_freq *cur = syms0, *new_ = syms1;
    memset(hist, 0, sizeof(hist));
    for (i = 0; i < num_syms; i++) {
        u32 freq = syms0[i].m_key;
        hist[freq & 0xFF]++;
        hist[256 + ((freq >> 8) & 0xFF)]++;
    }
    while ((total_passes > 1) && (num_syms == hist[(total_passes - 1) * 256]))
        total_passes--;
    for (pass_shift = 0, pass = 0; pass < total_passes;
         pass++, pass_shift += 8) {
        const u32 *pHist = &hist[pass << 8];
        u32 offsets[256], cur_ofs = 0;
        for (i = 0; i < 256; i++) {
            offsets[i] = cur_ofs;
            cur_ofs += pHist[i];
        }
        for (i = 0; i < num_syms; i++)
            new_[offsets[(cur[i].m_key >> pass_shift) & 0xFF]++] = cur[i];
        {
            sym_freq *t = cur;
            cur = new_;
            new_ = t;
        }
    }
    return cur;
}

/* Moffat–Katajainen in-place minimum-redundancy code lengths */
static void calculate_minimum_redundancy(sym_freq *A, int n) {
    int root, leaf, next, avbl, used, dpth;
    if (n == 0) return;
    if (n == 1) {
        A[0].m_key = 1;
        return;
    }
    A[0].m_key += A[1].m_key;
    root = 0;
    leaf = 2;
    for (next = 1; next < n - 1; next++) {
        if (leaf >= n || A[root].m_key < A[leaf].m_key) {
            A[next].m_key = A[root].m_key;
            A[root++].m_key = (u16)next;
        } else
            A[next].m_key = A[leaf++].m_key;
        if (leaf >= n || (root < next && A[root].m_key < A[leaf].m_key)) {
            A[next].m_key = (u16)(A[next].m_key + A[root].m_key);
            A[root++].m_key = (u16)next;
        } else
            A[next].m_key = (u16)(A[next].m_key + A[leaf++].m_key);
    }
    A[n - 2].m_key = 0;
    for (next = n - 3; next >= 0; next--)
        A[next].m_key = A[A[next].m_key].m_key + 1;
    avbl = 1;
    used = dpth = 0;
    root = n - 2;
    next = n - 1;
    while (avbl > 0) {
        while (root >= 0 && (int)A[root].m_key == dpth) {
            used++;
            root--;
        }
        while (avbl > used) {
            A[next--].m_key = (u16)dpth;
            avbl--;
        }
        avbl = 2 * used;
        dpth++;
        used = 0;
    }
}

static void huffman_enforce_max_code_size(int *pNum_codes,
                                          int code_list_len,
                                          int max_code_size) {
    int i;
    u32 total = 0;
    if (code_list_len <= 1) return;
    for (i = max_code_size + 1; i <= MAX_SUPPORTED_HUFF_CODESIZE; i++)
        pNum_codes[max_code_size] += pNum_codes[i];
    for (i = max_code_size; i > 0; i--)
        total += ((u32)pNum_codes[i]) << (max_code_size - i);
    while (total != (1UL << max_code_size)) {
        pNum_codes[max_code_size]--;
        for (i = max_code_size - 1; i > 0; i--)
            if (pNum_codes[i]) {
                pNum_codes[i]--;
                pNum_codes[i + 1] += 2;
                break;
            }
        total--;
    }
}

static void optimize_huffman_table(tdefl *d, int table_num, int table_len,
                                   int code_size_limit, int static_table) {
    int i, j, l;
    int num_codes[1 + MAX_SUPPORTED_HUFF_CODESIZE];
    u32 next_code[MAX_SUPPORTED_HUFF_CODESIZE + 1];
    memset(num_codes, 0, sizeof(num_codes));
    if (static_table) {
        for (i = 0; i < table_len; i++)
            num_codes[d->huff_code_sizes[table_num][i]]++;
    } else {
        sym_freq syms0[MAX_HUFF_SYMBOLS], syms1[MAX_HUFF_SYMBOLS], *pSyms;
        int num_used_syms = 0;
        const u16 *pSym_count = &d->huff_count[table_num][0];
        for (i = 0; i < table_len; i++)
            if (pSym_count[i]) {
                syms0[num_used_syms].m_key = pSym_count[i];
                syms0[num_used_syms++].m_sym_index = (u16)i;
            }
        pSyms = radix_sort_syms((u32)num_used_syms, syms0, syms1);
        calculate_minimum_redundancy(pSyms, num_used_syms);
        for (i = 0; i < num_used_syms; i++) num_codes[pSyms[i].m_key]++;
        huffman_enforce_max_code_size(num_codes, num_used_syms,
                                      code_size_limit);
        memset(d->huff_code_sizes[table_num], 0,
               sizeof(d->huff_code_sizes[table_num]));
        memset(d->huff_codes[table_num], 0,
               sizeof(d->huff_codes[table_num]));
        for (i = 1, j = num_used_syms; i <= code_size_limit; i++)
            for (l = num_codes[i]; l > 0; l--)
                d->huff_code_sizes[table_num][pSyms[--j].m_sym_index] =
                    (u8)i;
    }
    next_code[1] = 0;
    for (j = 0, i = 2; i <= code_size_limit; i++)
        next_code[i] = j = ((j + num_codes[i - 1]) << 1);
    for (i = 0; i < table_len; i++) {
        u32 rev_code = 0, code, code_size;
        if ((code_size = d->huff_code_sizes[table_num][i]) == 0) continue;
        code = next_code[code_size]++;
        for (l = (int)code_size; l > 0; l--, code >>= 1)
            rev_code = (rev_code << 1) | (code & 1);
        d->huff_codes[table_num][i] = (u16)rev_code;
    }
}

/* ---- block emission ---- */
static const u8 s_packed_code_size_syms_swizzle[] = {
    16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};

static void start_dynamic_block(tdefl *d) {
    int num_lit_codes, num_dist_codes, num_bit_lengths;
    u32 i, total_code_sizes_to_pack, num_packed_code_sizes, rle_z_count,
        rle_repeat_count, packed_code_sizes_index;
    u8 code_sizes_to_pack[MAX_HUFF_SYMBOLS_0 + MAX_HUFF_SYMBOLS_1];
    u8 packed_code_sizes[MAX_HUFF_SYMBOLS_0 + MAX_HUFF_SYMBOLS_1];
    u8 prev_code_size = 0xFF;

    d->huff_count[0][256] = 1;
    optimize_huffman_table(d, 0, MAX_HUFF_SYMBOLS_0, 15, 0);
    optimize_huffman_table(d, 1, MAX_HUFF_SYMBOLS_1, 15, 0);

    for (num_lit_codes = 286; num_lit_codes > 257; num_lit_codes--)
        if (d->huff_code_sizes[0][num_lit_codes - 1]) break;
    for (num_dist_codes = 30; num_dist_codes > 1; num_dist_codes--)
        if (d->huff_code_sizes[1][num_dist_codes - 1]) break;

    memcpy(code_sizes_to_pack, &d->huff_code_sizes[0][0],
           (size_t)num_lit_codes);
    memcpy(code_sizes_to_pack + num_lit_codes, &d->huff_code_sizes[1][0],
           (size_t)num_dist_codes);
    total_code_sizes_to_pack = (u32)(num_lit_codes + num_dist_codes);
    num_packed_code_sizes = 0;
    rle_z_count = 0;
    rle_repeat_count = 0;

    memset(&d->huff_count[2][0], 0,
           sizeof(d->huff_count[2][0]) * MAX_HUFF_SYMBOLS_2);

#define RLE_PREV_CODE_SIZE()                                              \
    {                                                                     \
        if (rle_repeat_count) {                                           \
            if (rle_repeat_count < 3) {                                   \
                d->huff_count[2][prev_code_size] = (u16)(                 \
                    d->huff_count[2][prev_code_size] + rle_repeat_count); \
                while (rle_repeat_count--)                                \
                    packed_code_sizes[num_packed_code_sizes++] =          \
                        prev_code_size;                                   \
            } else {                                                      \
                d->huff_count[2][16] = (u16)(d->huff_count[2][16] + 1);   \
                packed_code_sizes[num_packed_code_sizes++] = 16;          \
                packed_code_sizes[num_packed_code_sizes++] =              \
                    (u8)(rle_repeat_count - 3);                           \
            }                                                             \
            rle_repeat_count = 0;                                         \
        }                                                                 \
    }

#define RLE_ZERO_CODE_SIZE()                                              \
    {                                                                     \
        if (rle_z_count) {                                                \
            if (rle_z_count < 3) {                                        \
                d->huff_count[2][0] =                                     \
                    (u16)(d->huff_count[2][0] + rle_z_count);             \
                while (rle_z_count--)                                     \
                    packed_code_sizes[num_packed_code_sizes++] = 0;       \
            } else if (rle_z_count <= 10) {                               \
                d->huff_count[2][17] = (u16)(d->huff_count[2][17] + 1);   \
                packed_code_sizes[num_packed_code_sizes++] = 17;          \
                packed_code_sizes[num_packed_code_sizes++] =              \
                    (u8)(rle_z_count - 3);                                \
            } else {                                                      \
                d->huff_count[2][18] = (u16)(d->huff_count[2][18] + 1);   \
                packed_code_sizes[num_packed_code_sizes++] = 18;          \
                packed_code_sizes[num_packed_code_sizes++] =              \
                    (u8)(rle_z_count - 11);                               \
            }                                                             \
            rle_z_count = 0;                                              \
        }                                                                 \
    }

    for (i = 0; i < total_code_sizes_to_pack; i++) {
        u8 code_size = code_sizes_to_pack[i];
        if (!code_size) {
            RLE_PREV_CODE_SIZE();
            if (++rle_z_count == 138) { RLE_ZERO_CODE_SIZE(); }
        } else {
            RLE_ZERO_CODE_SIZE();
            if (code_size != prev_code_size) {
                RLE_PREV_CODE_SIZE();
                d->huff_count[2][code_size] =
                    (u16)(d->huff_count[2][code_size] + 1);
                packed_code_sizes[num_packed_code_sizes++] = code_size;
            } else if (++rle_repeat_count == 6) {
                RLE_PREV_CODE_SIZE();
            }
        }
        prev_code_size = code_size;
    }
    if (rle_repeat_count) {
        RLE_PREV_CODE_SIZE();
    } else {
        RLE_ZERO_CODE_SIZE();
    }

    optimize_huffman_table(d, 2, MAX_HUFF_SYMBOLS_2, 7, 0);

    put_bits(d, 2, 2);
    put_bits(d, (u32)(num_lit_codes - 257), 5);
    put_bits(d, (u32)(num_dist_codes - 1), 5);
    for (num_bit_lengths = 18; num_bit_lengths >= 0; num_bit_lengths--)
        if (d->huff_code_sizes[2]
                              [s_packed_code_size_syms_swizzle
                                   [num_bit_lengths]])
            break;
    num_bit_lengths = num_bit_lengths + 1;
    if (num_bit_lengths < 4) num_bit_lengths = 4;
    put_bits(d, (u32)(num_bit_lengths - 4), 4);
    for (i = 0; (int)i < num_bit_lengths; i++)
        put_bits(d,
                 d->huff_code_sizes[2][s_packed_code_size_syms_swizzle[i]],
                 3);

    for (packed_code_sizes_index = 0;
         packed_code_sizes_index < num_packed_code_sizes;) {
        u32 code = packed_code_sizes[packed_code_sizes_index++];
        put_bits(d, d->huff_codes[2][code], d->huff_code_sizes[2][code]);
        if (code >= 16)
            put_bits(d, packed_code_sizes[packed_code_sizes_index++],
                     (u32)"\02\03\07"[code - 16]);
    }
}

static void start_static_block(tdefl *d) {
    u32 i;
    u8 *p = &d->huff_code_sizes[0][0];
    for (i = 0; i <= 143; ++i) *p++ = 8;
    for (; i <= 255; ++i) *p++ = 9;
    for (; i <= 279; ++i) *p++ = 7;
    for (; i <= 287; ++i) *p++ = 8;
    memset(d->huff_code_sizes[1], 5, 32);
    optimize_huffman_table(d, 0, 288, 15, 1);
    optimize_huffman_table(d, 1, 32, 15, 1);
    put_bits(d, 1, 2);
}

static int compress_lz_codes(tdefl *d) {
    u32 flags = 1;
    u8 *pLZ_codes;
    for (pLZ_codes = d->lz_code_buf; pLZ_codes < d->pLZ_code_buf;
         flags >>= 1) {
        if (flags == 1) flags = (u32)(*pLZ_codes++) | 0x100;
        if (flags & 1) {
            u32 sym, num_extra_bits;
            u32 match_len = pLZ_codes[0];
            u32 match_dist = pLZ_codes[1] | ((u32)pLZ_codes[2] << 8);
            pLZ_codes += 3;
            {
                u32 lsym = (u32)s_len_sym[match_len] + 256; /* un-bias */
                put_bits(d, d->huff_codes[0][lsym],
                         d->huff_code_sizes[0][lsym]);
                put_bits(d, match_len & s_bitmasks[s_len_extra[match_len]],
                         s_len_extra[match_len]);
            }
            if (match_dist < 512) {
                sym = s_small_dist_sym[match_dist];
                num_extra_bits = s_small_dist_extra[match_dist];
            } else {
                sym = s_large_dist_sym[match_dist >> 8];
                num_extra_bits = s_large_dist_extra[match_dist >> 8];
            }
            put_bits(d, d->huff_codes[1][sym], d->huff_code_sizes[1][sym]);
            put_bits(d, match_dist & s_bitmasks[num_extra_bits],
                     num_extra_bits);
        } else {
            u32 lit = *pLZ_codes++;
            put_bits(d, d->huff_codes[0][lit], d->huff_code_sizes[0][lit]);
        }
    }
    put_bits(d, d->huff_codes[0][256], d->huff_code_sizes[0][256]);
    return d->pOutput_buf < d->pOutput_buf_end;
}

static int compress_block(tdefl *d, int static_block) {
    if (static_block)
        start_static_block(d);
    else
        start_dynamic_block(d);
    return compress_lz_codes(d);
}

static void out_emit(tdefl *d, const u8 *p, long n) {
    if (d->out_len + n > d->out_cap) {
        d->overflow = 1;
        return;
    }
    memcpy(d->out + d->out_len, p, (size_t)n);
    d->out_len += n;
}

static int flush_block(tdefl *d, int finish) {
    u32 saved_bit_buf, saved_bits_in;
    u8 *pSaved_output_buf;
    int comp_block_succeeded = 0;

    d->pOutput_buf = d->output_buf;
    d->pOutput_buf_end = d->output_buf + OUT_BUF_SIZE - 16;

    *d->pLZ_flags = (u8)(*d->pLZ_flags >> d->num_flags_left);
    d->pLZ_code_buf -= (d->num_flags_left == 8);

    if (!d->block_index) {
        /* zlib header: CMF 0x78 (deflate, 32K window); FLG with FLEVEL 2
         * ("default") and FCHECK making the pair a multiple of 31 —
         * 0x9C, matching flate2/miniz_oxide's ZlibEncoder at level 6.
         * (miniz C's tdefl hardcodes 0x78 0x01 here; miniz_oxide computes
         * the FLEVEL from the compression level as zlib requires.) */
        put_bits(d, 0x78, 8);
        put_bits(d, 0x9C, 8);
    }
    put_bits(d, finish ? 1 : 0, 1);

    pSaved_output_buf = d->pOutput_buf;
    saved_bit_buf = d->bit_buffer;
    saved_bits_in = d->bits_in;

    comp_block_succeeded = compress_block(d, d->total_lz_bytes < 48);

    if ((d->total_lz_bytes) &&
        ((u32)(d->pOutput_buf - pSaved_output_buf + 1U) >=
         d->total_lz_bytes) &&
        ((d->lookahead_pos - d->lz_code_buf_dict_pos) <= d->dict_size)) {
        /* expanded: emit a raw (stored) block instead */
        u32 i;
        d->pOutput_buf = pSaved_output_buf;
        d->bit_buffer = saved_bit_buf;
        d->bits_in = saved_bits_in;
        put_bits(d, 0, 2);
        if (d->bits_in) put_bits(d, 0, 8 - d->bits_in);
        for (i = 2; i; --i, d->total_lz_bytes ^= 0xFFFF)
            put_bits(d, d->total_lz_bytes & 0xFFFF, 16);
        for (i = 0; i < d->total_lz_bytes; ++i)
            put_bits(d,
                     d->dict[(d->lz_code_buf_dict_pos + i) & LZ_DICT_MASK],
                     8);
    } else if (!comp_block_succeeded) {
        d->pOutput_buf = pSaved_output_buf;
        d->bit_buffer = saved_bit_buf;
        d->bits_in = saved_bits_in;
        compress_block(d, 1);
    }

    if (finish) {
        if (d->bits_in) put_bits(d, 0, 8 - d->bits_in);
        {
            u32 i, a = d->adler32;
            for (i = 0; i < 4; i++) {
                put_bits(d, (a >> 24) & 0xFF, 8);
                a <<= 8;
            }
        }
    }

    out_emit(d, d->output_buf, (long)(d->pOutput_buf - d->output_buf));

    memset(&d->huff_count[0][0], 0,
           sizeof(d->huff_count[0][0]) * MAX_HUFF_SYMBOLS_0);
    memset(&d->huff_count[1][0], 0,
           sizeof(d->huff_count[1][0]) * MAX_HUFF_SYMBOLS_1);
    d->pLZ_code_buf = d->lz_code_buf + 1;
    d->pLZ_flags = d->lz_code_buf;
    d->num_flags_left = 8;
    d->lz_code_buf_dict_pos += d->total_lz_bytes;
    d->total_lz_bytes = 0;
    d->block_index++;
    return d->overflow ? -1 : 0;
}

/* ---- match finding (tdefl_find_match) ---- */
static u16 read_u16(const u8 *p) {
    return (u16)(p[0] | ((u16)p[1] << 8));
}

static void find_match(tdefl *d, u32 lookahead_pos, u32 max_dist,
                       u32 max_match_len, u32 *pMatch_dist,
                       u32 *pMatch_len) {
    u32 dist, pos = lookahead_pos & LZ_DICT_MASK, match_len = *pMatch_len,
             probe_pos = pos, next_probe_pos, probe_len;
    u32 num_probes_left = d->max_probes[match_len >= 32];
    const u8 *s = d->dict + pos;
    u16 c01, s01;
    if (max_match_len <= match_len) return;
    c01 = read_u16(&d->dict[pos + match_len - 1]);
    s01 = read_u16(s);
    for (;;) {
        for (;;) {
            if (--num_probes_left == 0) return;
#define PROBE                                                         \
    next_probe_pos = d->next[probe_pos];                              \
    if ((!next_probe_pos) ||                                          \
        ((dist = (u16)(lookahead_pos - next_probe_pos)) > max_dist))  \
        return;                                                       \
    probe_pos = next_probe_pos & LZ_DICT_MASK;                        \
    if (read_u16(&d->dict[probe_pos + match_len - 1]) == c01) break;
            PROBE;
            PROBE;
            PROBE;
        }
        if (!dist) break;
        {
            const u8 *q8 = d->dict + probe_pos;
            u32 k;
            if (read_u16(q8) != s01) continue;
            /* words 1..128 at byte offsets 2, 4, ..., 256 (the first
             * word matched via s01; 2 + 128*2 = 258 = MAX_MATCH) */
            for (k = 1; k < 129; k++)
                if (read_u16(s + 2 * k) != read_u16(q8 + 2 * k)) break;
            if (k == 129) {
                *pMatch_dist = dist;
                *pMatch_len =
                    (max_match_len < MAX_MATCH) ? max_match_len : MAX_MATCH;
                break;
            }
            probe_len = 2 * k + (u32)(s[2 * k] == q8[2 * k]);
            if (probe_len > match_len) {
                *pMatch_dist = dist;
                match_len = (max_match_len < probe_len) ? max_match_len
                                                        : probe_len;
                *pMatch_len = match_len;
                if (match_len == MAX_MATCH) break;
                c01 = read_u16(&d->dict[pos + match_len - 1]);
            }
        }
    }
}

static void record_literal(tdefl *d, u8 lit) {
    d->total_lz_bytes++;
    *d->pLZ_code_buf++ = lit;
    *d->pLZ_flags = (u8)(*d->pLZ_flags >> 1);
    if (--d->num_flags_left == 0) {
        d->num_flags_left = 8;
        d->pLZ_flags = d->pLZ_code_buf++;
    }
    d->huff_count[0][lit]++;
}

static void record_match(tdefl *d, u32 match_len, u32 match_dist) {
    u32 s0, s1;
    d->total_lz_bytes += match_len;
    d->pLZ_code_buf[0] = (u8)(match_len - MIN_MATCH);
    match_dist -= 1;
    d->pLZ_code_buf[1] = (u8)(match_dist & 0xFF);
    d->pLZ_code_buf[2] = (u8)(match_dist >> 8);
    d->pLZ_code_buf += 3;
    *d->pLZ_flags = (u8)((*d->pLZ_flags >> 1) | 0x80);
    if (--d->num_flags_left == 0) {
        d->num_flags_left = 8;
        d->pLZ_flags = d->pLZ_code_buf++;
    }
    s0 = s_small_dist_sym[match_dist & 511];
    s1 = s_large_dist_sym[(match_dist >> 8) & 127];
    d->huff_count[1][(match_dist < 512) ? s0 : s1]++;
    d->huff_count[0][(u32)s_len_sym[match_len - MIN_MATCH] + 256]++;
}

static u32 adler32(u32 adler, const u8 *p, u64 len) {
    u32 s1 = adler & 0xFFFF, s2 = adler >> 16;
    u64 i = 0;
    while (i < len) {
        u64 block = len - i;
        if (block > 5552) block = 5552;
        {
            u64 e = i + block;
            for (; i < e; i++) {
                s1 += p[i];
                s2 += s1;
            }
        }
        s1 %= 65521;
        s2 %= 65521;
    }
    return (s2 << 16) | s1;
}

/* ---- the normal-speed parse loop (tdefl_compress_normal) ---- */
static int compress_normal(tdefl *d) {
    const u8 *pSrc = d->src + d->src_pos;
    u64 src_buf_left = d->src_len - d->src_pos;

    while (src_buf_left || d->lookahead_size) {
        u32 len_to_move, cur_match_dist, cur_match_len, cur_pos;
        /* dictionary/hash update; keeps lookahead at MAX_MATCH */
        if ((d->lookahead_size + d->dict_size) >= (MIN_MATCH - 1)) {
            u32 dst_pos =
                (d->lookahead_pos + d->lookahead_size) & LZ_DICT_MASK;
            u32 ins_pos = d->lookahead_pos + d->lookahead_size - 2;
            u32 hash =
                ((u32)d->dict[ins_pos & LZ_DICT_MASK] << LZ_HASH_SHIFT) ^
                d->dict[(ins_pos + 1) & LZ_DICT_MASK];
            u32 num_bytes_to_process =
                (u32)((src_buf_left < MAX_MATCH - d->lookahead_size)
                          ? src_buf_left
                          : MAX_MATCH - d->lookahead_size);
            const u8 *pSrc_end = pSrc + num_bytes_to_process;
            src_buf_left -= num_bytes_to_process;
            d->lookahead_size += num_bytes_to_process;
            while (pSrc != pSrc_end) {
                u8 c = *pSrc++;
                d->dict[dst_pos] = c;
                if (dst_pos < (MAX_MATCH - 1))
                    d->dict[LZ_DICT_SIZE + dst_pos] = c;
                hash = ((hash << LZ_HASH_SHIFT) ^ c) & (LZ_HASH_SIZE - 1);
                d->next[ins_pos & LZ_DICT_MASK] = d->hash[hash];
                d->hash[hash] = (u16)ins_pos;
                dst_pos = (dst_pos + 1) & LZ_DICT_MASK;
                ins_pos++;
            }
        } else {
            while (src_buf_left && (d->lookahead_size < MAX_MATCH)) {
                u8 c = *pSrc++;
                u32 dst_pos =
                    (d->lookahead_pos + d->lookahead_size) & LZ_DICT_MASK;
                src_buf_left--;
                d->dict[dst_pos] = c;
                if (dst_pos < (MAX_MATCH - 1))
                    d->dict[LZ_DICT_SIZE + dst_pos] = c;
                if ((++d->lookahead_size + d->dict_size) >= MIN_MATCH) {
                    u32 ins_pos = d->lookahead_pos + d->lookahead_size - 3;
                    u32 hash =
                        (((u32)d->dict[ins_pos & LZ_DICT_MASK]
                          << (LZ_HASH_SHIFT * 2)) ^
                         (((u32)d->dict[(ins_pos + 1) & LZ_DICT_MASK]
                           << LZ_HASH_SHIFT) ^
                          c)) &
                        (LZ_HASH_SIZE - 1);
                    d->next[ins_pos & LZ_DICT_MASK] = d->hash[hash];
                    d->hash[hash] = (u16)ins_pos;
                }
            }
        }
        {
            u32 cap = LZ_DICT_SIZE - d->lookahead_size;
            if (d->dict_size > cap) d->dict_size = cap;
        }
        /* (one-shot FINISH semantics: never wait for more input) */

        /* lazy/greedy parse */
        len_to_move = 1;
        cur_match_dist = 0;
        cur_match_len =
            d->saved_match_len ? d->saved_match_len : (MIN_MATCH - 1);
        cur_pos = d->lookahead_pos & LZ_DICT_MASK;
        find_match(d, d->lookahead_pos, d->dict_size, d->lookahead_size,
                   &cur_match_dist, &cur_match_len);
        if (((cur_match_len == MIN_MATCH) &&
             (cur_match_dist >= 8U * 1024U)) ||
            (cur_pos == cur_match_dist)) {
            cur_match_dist = cur_match_len = 0;
        }
        if (d->saved_match_len) {
            if (cur_match_len > d->saved_match_len) {
                record_literal(d, (u8)d->saved_lit);
                if (cur_match_len >= 128) {
                    record_match(d, cur_match_len, cur_match_dist);
                    d->saved_match_len = 0;
                    len_to_move = cur_match_len;
                } else {
                    d->saved_lit = d->dict[cur_pos];
                    d->saved_match_dist = cur_match_dist;
                    d->saved_match_len = cur_match_len;
                }
            } else {
                record_match(d, d->saved_match_len, d->saved_match_dist);
                len_to_move = d->saved_match_len - 1;
                d->saved_match_len = 0;
            }
        } else if (!cur_match_dist) {
            record_literal(d, d->dict[cur_pos]);
        } else if (d->greedy || (cur_match_len >= 128)) {
            record_match(d, cur_match_len, cur_match_dist);
            len_to_move = cur_match_len;
        } else {
            d->saved_lit = d->dict[cur_pos];
            d->saved_match_dist = cur_match_dist;
            d->saved_match_len = cur_match_len;
        }

        d->lookahead_pos += len_to_move;
        d->lookahead_size -= len_to_move;
        {
            u32 ds = d->dict_size + len_to_move;
            d->dict_size = (ds < LZ_DICT_SIZE) ? ds : LZ_DICT_SIZE;
        }
        /* time to flush the LZ codes? */
        if ((d->pLZ_code_buf >
             &d->lz_code_buf[LZ_CODE_BUF_SIZE - 8]) ||
            ((d->total_lz_bytes > 31 * 1024) &&
             ((((u32)(d->pLZ_code_buf - d->lz_code_buf) * 115) >> 7) >=
              d->total_lz_bytes))) {
            d->src_pos = d->src_len - src_buf_left;
            if (flush_block(d, 0) < 0) return -1;
            pSrc = d->src + d->src_pos;
            /* src_buf_left unchanged (flush consumes no input) */
        }
    }
    d->src_pos = d->src_len - src_buf_left;
    return 0;
}

long spartan_tdefl_zlib(const u8 *src, long src_len, u8 *dst, long dst_cap,
                        int level) {
    static tdefl d_static; /* 200KB+: keep off the stack */
    tdefl *d = &d_static;
    u32 probes;
    init_tables();
    memset(d, 0, sizeof(*d));
    if (level < 0) level = 6;
    if (level > 10) level = 10;
    probes = s_num_probes[level];
    d->max_probes[0] = 1 + ((probes + 2) / 3);
    d->max_probes[1] = 1 + (((probes >> 2) + 2) / 3);
    d->greedy = (level <= 3);
    d->src = src;
    d->src_len = (u64)src_len;
    d->out = dst;
    d->out_cap = dst_cap;
    d->pLZ_code_buf = d->lz_code_buf + 1;
    d->pLZ_flags = d->lz_code_buf;
    d->num_flags_left = 8;
    d->pOutput_buf = d->output_buf;
    d->pOutput_buf_end = d->output_buf + OUT_BUF_SIZE - 16;
    d->adler32 = 1;

    d->adler32 = adler32(1, src, (u64)src_len);
    if (compress_normal(d) < 0) return -1;
    if (flush_block(d, 1) < 0) return -1;
    if (d->overflow) return -1;
    return d->out_len;
}
