/* Keccak-f[1600] permutation, host-side C.
 *
 * Backs the STROBE-128 sponge of the merlin Fiat-Shamir transcript
 * (utils/strobe.py; reference uses the merlin crate, src/transcript.rs).
 * The transcript is inherently sequential and host-resident; the pure
 * Python permutation (~0.8 ms/call) was a measurable fixed cost per
 * proof (hundreds of challenges each flushing the sponge), so the hot
 * permutation lives here.  Validated against hashlib SHA3 in
 * tests/test_host_core.py through the Python wrapper.
 */

#include <stdint.h>

#define ROTL64(v, n) (((v) << (n)) | ((v) >> (64 - (n))))

static const uint64_t KECCAK_RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

/* lane (x, y) at index x + 5*y, matching utils/keccak.py */
void keccak_f1600(uint64_t a[25]) {
  uint64_t c[5], d[5], b[25];
  for (int round = 0; round < 24; round++) {
    /* theta */
    for (int x = 0; x < 5; x++)
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
    for (int x = 0; x < 5; x++)
      d[x] = c[(x + 4) % 5] ^ ROTL64(c[(x + 1) % 5], 1);
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++) a[x + 5 * y] ^= d[x];
    /* rho + pi: b[y + 5*((2x+3y) mod 5)] = rotl(a[x + 5y], r[x][y]) */
    static const int ROT[5][5] = {{0, 36, 3, 41, 18},
                                  {1, 44, 10, 45, 2},
                                  {62, 6, 43, 15, 61},
                                  {28, 55, 25, 21, 56},
                                  {27, 20, 39, 8, 14}};
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++) {
        int r = ROT[x][y];
        uint64_t v = a[x + 5 * y];
        b[y + 5 * ((2 * x + 3 * y) % 5)] = r ? ROTL64(v, r) : v;
      }
    /* chi */
    for (int y = 0; y < 5; y++)
      for (int x = 0; x < 5; x++)
        a[x + 5 * y] =
            b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y]) & b[(x + 2) % 5 + 5 * y]);
    /* iota */
    a[0] ^= KECCAK_RC[round];
  }
}
