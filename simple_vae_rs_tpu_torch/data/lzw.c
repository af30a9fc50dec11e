/* TIFF-variant LZW codec (TIFF 6.0 §13, libtiff-compatible early change).
 *
 * Native counterpart of the pure-Python codec in tiffio.py (the port's copy
 * of the JAX package's data/lzw.c): the Python loops run at a few MB/s,
 * which would make strip decode the bottleneck of the data pipeline on
 * compressed Sen2Venus tiles, and strip encode that of writing compressed
 * products. Both run at memory speed here. Built on demand by
 * data/lzw_native.py (cc -O3 -shared -fPIC) into build/svrs_lzw/ and loaded
 * with ctypes; tiffio falls back to the Python codec only when no C
 * toolchain is available. Semantics are pinned to the Python codec by the
 * tests (random streams and truncated strips for the decoder, byte-identical
 * output for the encoder).
 *
 * svrs_lzw_decode returns: bytes written to dst; -1 on a corrupt stream;
 * -2 when dst is too small (caller regrows and retries). A stream that
 * ends without an EOI code returns what was decoded (tolerates truncated
 * strips). svrs_lzw_encode returns bytes written or -2 (dst too small).
 */

#define LZW_CLEAR 256
#define LZW_EOI 257
#define LZW_FIRST 258
#define LZW_TABLE 4096

static int first_char(int code, const unsigned short *prefix) {
    while (code >= LZW_FIRST)
        code = prefix[code];
    return code; /* < 256 */
}

long svrs_lzw_decode(const unsigned char *src, long n, unsigned char *dst,
                     long cap) {
    unsigned short prefix[LZW_TABLE];
    unsigned char suffix[LZW_TABLE];
    unsigned char stack[LZW_TABLE];
    int width = 9, next = LZW_FIRST, old = -1;
    long pos = 0, out = 0;
    unsigned long bitbuf = 0;
    int nbits = 0;

    for (;;) {
        while (nbits < width) {
            if (pos >= n)
                return out; /* missing EOI: tolerate truncated strip */
            bitbuf = (bitbuf << 8) | src[pos++];
            nbits += 8;
        }
        int code = (int)((bitbuf >> (nbits - width)) & ((1UL << width) - 1));
        nbits -= width;

        if (code == LZW_EOI)
            return out;
        if (code == LZW_CLEAR) {
            width = 9;
            next = LZW_FIRST;
            old = -1;
            continue;
        }
        int added = 0;
        if (code == next) { /* KwKwK: entry is old-string + first(old) */
            if (old < 0)
                return -1;
            if (next < LZW_TABLE) {
                prefix[next] = (unsigned short)old;
                suffix[next] = (unsigned char)first_char(old, prefix);
                next++;
                added = 1;
            } else {
                return -1; /* encoder must have cleared by now */
            }
        } else if (code > next) {
            /* CLEAR/EOI were consumed above, so any non-table code here
             * means a corrupt stream */
            return -1;
        }

        /* emit string(code) via the reversal stack */
        int sp = 0, c = code;
        while (c >= LZW_FIRST) {
            if (sp >= LZW_TABLE)
                return -1;
            stack[sp++] = suffix[c];
            c = prefix[c];
        }
        stack[sp++] = (unsigned char)c;
        if (out + sp > cap)
            return -2;
        while (sp > 0)
            dst[out++] = stack[--sp];

        if (!added && old >= 0 && next < LZW_TABLE) {
            prefix[next] = (unsigned short)old;
            suffix[next] = (unsigned char)first_char(code, prefix);
            next++;
            added = 1;
        }
        /* early change: grow the width when the table reaches 511/1023/
         * 2047 entries (matches the Python decoder and libtiff) */
        if (added && next + 1 >= (1 << width) && width < 12)
            width++;
        old = code;
    }
}

/* Greedy LZW encoder, byte-identical to tiffio._lzw_encode: CLEAR first,
 * width bump when next_code reaches the current width's capacity (the
 * decoder-side early change mirrored), table reset at 4094 entries, and
 * the final-code width-bump quirk before EOI. The string table is the
 * classic (prefix_code, byte) -> code hash with generation stamps so a
 * reset never re-clears the table. */
#define LZW_HSIZE 9013 /* prime, ~2.3x the 3836 max live entries */

#include <stdlib.h>
#include <string.h>

long svrs_lzw_encode(const unsigned char *src, long n, unsigned char *dst,
                     long cap) {
    /* per-call heap tables (ctypes releases the GIL, so concurrent
     * encodes must not share state); one ~100 KB alloc + one memset per
     * strip is noise next to the strip itself */
    int *hkey = malloc(LZW_HSIZE * sizeof(int));
    unsigned short *hcode = malloc(LZW_HSIZE * sizeof(unsigned short));
    int *hgen = malloc(LZW_HSIZE * sizeof(int));
    if (!hkey || !hcode || !hgen) {
        free(hkey);
        free(hcode);
        free(hgen);
        return -1; /* allocation failure: caller falls back, no retry */
    }
    memset(hgen, 0, LZW_HSIZE * sizeof(int)); /* generation 0 = stale */
    int gen = 1;

    unsigned long bitbuf = 0;
    int nbits = 0;
    long out = 0;
    int width = 9, next = LZW_FIRST, prev = -1;

#define LZW_EMIT(code_)                                                    \
    do {                                                                   \
        bitbuf = (bitbuf << width) | (unsigned long)(code_);               \
        nbits += width;                                                    \
        while (nbits >= 8) {                                               \
            if (out >= cap) {                                              \
                out = -2;                                                  \
                goto done;                                                 \
            }                                                              \
            dst[out++] = (unsigned char)((bitbuf >> (nbits - 8)) & 0xFF);  \
            nbits -= 8;                                                    \
        }                                                                  \
    } while (0)

    LZW_EMIT(LZW_CLEAR);
    for (long i = 0; i < n; i++) {
        int c = src[i];
        if (prev < 0) {
            prev = c;
            continue;
        }
        unsigned key = ((unsigned)prev << 8) | (unsigned)c;
        unsigned long h = (key * 2654435761UL) % LZW_HSIZE;
        int found = -1;
        while (hgen[h] == gen) {
            if (hkey[h] == (int)key) {
                found = hcode[h];
                break;
            }
            h = (h + 1) % LZW_HSIZE;
        }
        if (found >= 0) {
            prev = found;
            continue;
        }
        LZW_EMIT(prev);
        hgen[h] = gen; /* h sits on the first stale slot of the probe */
        hkey[h] = (int)key;
        hcode[h] = (unsigned short)next;
        next++;
        if (next >= (1 << width) && width < 12)
            width++;
        if (next >= 4094) { /* table nearly full: reset (at bumped width) */
            LZW_EMIT(LZW_CLEAR);
            gen++;
            next = LZW_FIRST;
            width = 9;
        }
        prev = c;
    }
    if (prev >= 0) {
        LZW_EMIT(prev);
        /* the decoder adds a table entry for this final code and may bump
         * its width before reading EOI — mirror it (see _lzw_encode) */
        if (next + 1 >= (1 << width) && width < 12)
            width++;
    }
    LZW_EMIT(LZW_EOI);
    if (nbits) {
        if (out >= cap) {
            out = -2;
            goto done;
        }
        dst[out++] = (unsigned char)((bitbuf << (8 - nbits)) & 0xFF);
    }
done:
    free(hkey);
    free(hcode);
    free(hgen);
    return out;
#undef LZW_EMIT
}
