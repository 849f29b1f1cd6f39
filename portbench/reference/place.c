/* The read-until index's bucket placement rule, written from its statement
 * on bucket counts alone: which entries a table of 2^B buckets of K slots
 * keeps, and in which of their two buckets.  The reference looks entries
 * up in a sorted array, so this is all it needs of the table.
 *
 * Entries come in ascending-hash order.  Entry h has a home bucket
 * b1 = h mod 2^B and an alternate b2 = b1 xor (((h >> B) * 0x9E3779B1)
 * mod 2^32 >> (32 - B)).  It goes to the less full of the two, the home on
 * a tie, if that has room; else to the other if that has room; else it is
 * dropped.  The second entry of a hash that has two (the next entry, same
 * hash) goes where the first went if that has room, else to the first's
 * other bucket if that has room; it is dropped if both are full or if the
 * first was dropped.
 *
 * place[i]: 0 dropped, 1 home, 2 alternate (where b2 = b1: home).
 * load: caller-zeroed, 2^B bytes.  Returns the number dropped.
 *
 * Build: cc -O2 -shared -fPIC place.c -o _pb_place.so
 */

#include <stdint.h>

int64_t pb_place(const uint32_t *h, int64_t n, int B, int K, uint8_t *load,
                 uint8_t *place)
{
    const uint32_t mask = (B >= 32) ? 0xFFFFFFFFu : ((1u << B) - 1);
    int64_t dropped = 0;
    uint32_t prev = 0;        /* the bucket the previous entry went to */
    int prev_where = 0;       /* 0: dropped, 1: home, 2: alternate */
    for (int64_t i = 0; i < n; ++i) {
        /* the buckets of an entry a few places on, fetched early: the
         * loop reads two random bytes of a large array an entry */
        if (i + 16 < n) {
            uint32_t x = h[i + 16];
            uint32_t a = x & mask;
            __builtin_prefetch(load + a);
            __builtin_prefetch(load + ((a ^ (((x >> B) * 0x9E3779B1u)
                                              >> (32 - B))) & mask));
        }
        uint32_t home = h[i] & mask;
        uint32_t alt = (home ^ (((h[i] >> B) * 0x9E3779B1u) >> (32 - B)))
                       & mask;
        uint32_t to = 0;
        int where = 0;
        if (i > 0 && h[i] == h[i - 1]) {
            if (prev_where != 0) {
                uint32_t other = (prev_where == 1) ? alt : home;
                if (load[prev] < K) {
                    to = prev;
                    where = prev_where;
                } else if (load[other] < K) {
                    to = other;
                    where = (prev_where == 1) ? 2 : 1;
                }
            }
        } else if (load[home] <= load[alt]) {
            if (load[home] < K) {
                to = home;
                where = 1;
            } else if (load[alt] < K) {
                to = alt;
                where = 2;
            }
        } else {
            if (load[alt] < K) {
                to = alt;
                where = 2;
            } else if (load[home] < K) {
                to = home;
                where = 1;
            }
        }
        if (where != 0 && home == alt)
            where = 1;
        if (where == 0) {
            ++dropped;
        } else {
            load[to] += 1;
            prev = to;
        }
        place[i] = (uint8_t)where;
        prev_where = where;
    }
    return dropped;
}
