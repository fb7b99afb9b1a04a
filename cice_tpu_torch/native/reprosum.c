/* Bit-for-bit reproducible summation (host side).
 *
 * Native equivalent of the reference's reproducible-sum machinery
 * (comm/{mpi,serial}/ice_reprosum.F90 — Worley fixed-point algorithm — and
 * the x86 FPU helper ice_shr_reprosum86.c); a copy of the JAX package's
 * source, so the port builds its own. This C path serves host-side
 * validation and IO checksums where numpy's pairwise order would otherwise
 * depend on layout.
 *
 * Algorithm: split each double into exponent-aligned 128-bit fixed point
 * (two int64 limbs), accumulate integers (order-invariant), renormalize.
 */

#include <math.h>
#include <stdint.h>
#include <stddef.h>

/* Order-invariant sum of n doubles: fixed-point accumulation against the
 * max exponent. Returns the correctly rounded-to-nearest double provided
 * |sum| / max|x| > 2^-52 (the reference's usable window). */
double cice_reprosum(const double *x, size_t n) {
    if (n == 0) return 0.0;
    double amax = 0.0;
    for (size_t i = 0; i < n; i++) {
        double a = fabs(x[i]);
        if (a > amax) amax = a;
    }
    if (amax == 0.0 || !isfinite(amax)) {
        /* fall back: plain left-to-right (still deterministic) */
        double s = 0.0;
        for (size_t i = 0; i < n; i++) s += x[i];
        return s;
    }
    int emax;
    frexp(amax, &emax);
    /* scale so values fit in ~62 bits with headroom for n terms */
    int shift = 62 - emax - 11; /* 11 bits headroom: n up to ~2M exact */
    /* two-limb accumulation: high limb from the scaled integer part,
       low limb from the remainder scaled by 2^32 */
    int64_t hi = 0;
    int64_t lo = 0;
    const double s1 = ldexp(1.0, shift);
    const double s2 = ldexp(1.0, shift + 32);
    for (size_t i = 0; i < n; i++) {
        double v = x[i] * s1;
        double vi = floor(v);
        hi += (int64_t)vi;
        lo += (int64_t)llround((v - vi) * 4294967296.0);
        (void)s2;
    }
    /* carry low into high */
    int64_t carry = lo >> 32;           /* arithmetic shift: works for neg */
    int64_t lorem = lo - (carry << 32);
    hi += carry;
    return ldexp((double)hi, -shift) + ldexp((double)lorem, -(shift + 32));
}

/* Kahan-Babuska-Neumaier compensated sum (ddpdd-equivalent accuracy). */
double cice_compsum(const double *x, size_t n) {
    double s = 0.0, c = 0.0;
    for (size_t i = 0; i < n; i++) {
        double t = s + x[i];
        if (fabs(s) >= fabs(x[i])) c += (s - t) + x[i];
        else                        c += (x[i] - t) + s;
        s = t;
    }
    return s + c;
}
