"""Exact rational comparisons in pure int32 — the precision core.

The reference compares channel ratios (a/b with a, b in 0..255) against
decimal constants in Java doubles (AbstractColorDepthSearchAlgorithm
.java:260-388). Reformulated exactly over the rationals:

    u / v <= C9 / 10^9      (u <= 2^17, v <= 2^16, C9 < 2^35)

Accelerators prefer 32-bit lanes, so instead of int64/float64 we evaluate the
cross-multiplied comparison u * 10^9 <= C9 * v with a staged quotient
decomposition that never leaves int32:

    C9 = Q * 10^6 + R                 (host-side Python ints; Q <= ~3000)
    u * 10^9 <= C9 * v
      <=>  10^6 * (u*10^3 - Q*v) <= R * v
      <=>  D < 0
           or (D <= Dmax and 64 * (D*15625 - Rhi*v) <= Rlo * v)
    where D = u*10^3 - Q*v, R = Rhi*64 + Rlo  (10^6 = 15625 * 64),
          E = D*15625 - Rhi*v, and the band guards keep every
          intermediate within int32.

All magnitudes are proved in-range for u <= 131072, v <= 65536:
  |D|  <= max(u*10^3, Q*v) <= 1.32e8
  D*15625 (only needed for 0 <= D <= Dmax=65601) <= 1.03e9
  Rhi*v <= 15624*65536 = 1.02e9 ; Rlo*v <= 63*65536 = 4.2e6 ; 64*E
  (only needed for 0 <= E <= Emax=65536) <= 4.2e6.

This gives bit-exact rational semantics. NB: this is *exact rational*
comparison; Java's double evaluation can differ on exact rational ties
(e.g. |0.51 - 0.5| vs 0.01) by one final-bit rounding. Ties require the
difference of two 8-bit-ratio fractions to equal the threshold exactly —
none occur in the reference's golden fixtures (asserted in tests), and
the rational semantics is the mathematically well-defined one.
"""

from __future__ import annotations

from typing import Tuple


def c9_split(c9: int) -> Tuple[int, int, int]:
    """Split a 10^-9-scaled constant for ratio_leq_c9. Returns (Q, Rhi, Rlo)."""
    if c9 < 0:
        raise ValueError("negative thresholds not supported")
    q, r = divmod(int(c9), 10 ** 6)
    if q > 3000:
        raise ValueError(f"C9 too large for int32 staging: {c9}")
    r_hi, r_lo = divmod(r, 64)
    return q, r_hi, r_lo


def ratio_leq_c9(np, u, v, c9: int):
    """Exact u/v <= c9/1e9 elementwise, u,v int32 arrays (u<=2^17, v<=2^16, v>=1).

    `np` is the array namespace (numpy or jax.numpy) so the same staging
    runs on host and device.
    """
    q, r_hi, r_lo = c9_split(c9)
    d = u * 1000 - q * v
    e = d * 15625 - r_hi * v
    in_band_d = (d >= 0) & (d <= 65601)
    in_band_e = (e >= 0) & (e <= 65601)
    # final exact compare, only meaningful inside both bands
    final = (64 * np.where(in_band_e, e, 0)) <= r_lo * v
    res_e = np.where(e < 0, True, np.where(in_band_e, final, False))
    return np.where(d < 0, True, np.where(in_band_d, res_e, False))


def ratio_geq_c9(np, u, v, c9: int):
    """Exact u/v >= c9/1e9 elementwise (same staging, flipped senses)."""
    if c9 <= 0:
        return u >= 0  # all-True for the scorer's non-negative numerators
    q, r_hi, r_lo = c9_split(c9)
    d = u * 1000 - q * v
    e = d * 15625 - r_hi * v
    in_band_d = (d >= 0) & (d <= 65601)
    in_band_e = (e >= 0) & (e <= 65601)
    final = (64 * np.where(in_band_e, e, 0)) >= r_lo * v
    res_e = np.where(e < 0, False, np.where(in_band_e, final, True))
    return np.where(d < 0, False, np.where(in_band_d, res_e, True))


def ratio_lt_frac(np, a, b, num: int, den: int):
    """Exact a/b < num/den elementwise for small ints (a,b<=255, num/den ~ 1)."""
    return a * den < num * b


def ratio_gt_frac(np, a, b, num: int, den: int):
    """Exact a/b > num/den elementwise."""
    return a * den > num * b
