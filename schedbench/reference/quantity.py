"""Kubernetes resource quantities as exact integers of milli-units."""

from __future__ import annotations

from fractions import Fraction

_SUFFIX = {
    "n": Fraction(1, 10 ** 9), "u": Fraction(1, 10 ** 6),
    "m": Fraction(1, 1000), "": Fraction(1),
    "k": Fraction(10 ** 3), "M": Fraction(10 ** 6), "G": Fraction(10 ** 9),
    "T": Fraction(10 ** 12), "P": Fraction(10 ** 15), "E": Fraction(10 ** 18),
    "Ki": Fraction(2 ** 10), "Mi": Fraction(2 ** 20), "Gi": Fraction(2 ** 30),
    "Ti": Fraction(2 ** 40), "Pi": Fraction(2 ** 50), "Ei": Fraction(2 ** 60),
}


def milli(q) -> int:
    """'100m' -> 100, '8' -> 8000, '250Mi' -> 262144000000 (rounded up to
    a whole milli-unit, as the API server rounds)."""
    s = str(q).strip()
    for suf in sorted(_SUFFIX, key=len, reverse=True):
        if suf and s.endswith(suf):
            num, mult = s[: -len(suf)], _SUFFIX[suf]
            break
    else:
        num, mult = s, Fraction(1)
    v = Fraction(num) * mult * 1000
    return -((-v.numerator) // v.denominator)
