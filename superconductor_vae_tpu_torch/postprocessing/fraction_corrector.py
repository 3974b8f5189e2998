"""Fraction repair: denominator snapping + site-sum constraints (port of
postprocessing/fraction_corrector.py; host code, the same logic).

As the reference (reference: postprocessing/fraction_corrector.py:45-291):
snap fractions to the nearest of the 28 common denominators seen in training
data, enforce denominator consistency within a formula, and optionally adjust
consecutive doped-site fractions toward an integer site sum.
"""

from __future__ import annotations

import dataclasses
import math
import re
from fractions import Fraction
from typing import List, Tuple

COMMON_DENOMINATORS = (
    2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 14, 15, 16, 20, 25, 28, 30, 32, 40, 50,
    60, 64, 80, 100, 125, 200, 250, 1000,
)

_FRAC = re.compile(r'\((\d+)/(\d+)\)')


@dataclasses.dataclass
class FractionCorrectionResult:
    original: str
    corrected: str
    corrections: List[str]

    @property
    def was_corrected(self) -> bool:
        return self.original != self.corrected


class FractionCorrector:
    def __init__(self, denominators: Tuple[int, ...] = COMMON_DENOMINATORS,
                 snap_tolerance: float = 0.02,
                 enforce_site_sums: bool = True):
        self.denominators = denominators
        self.snap_tolerance = snap_tolerance
        self.enforce_site_sums = enforce_site_sums

    def _snap_value(self, value: float) -> Tuple[int, int]:
        """Closest fraction p/q with q in the common set."""
        best = (round(value * 1000), 1000)
        best_err = abs(best[0] / best[1] - value)
        for q in self.denominators:
            p = round(value * q)
            if p <= 0:
                continue
            err = abs(p / q - value)
            if err < best_err - 1e-12 or (err <= best_err and q < best[1]):
                best, best_err = (p, q), err
        g = math.gcd(*best)
        return best[0] // g, best[1] // g

    def correct(self, formula: str) -> FractionCorrectionResult:
        corrections: List[str] = []

        def snap(m):
            p, q = int(m.group(1)), int(m.group(2))
            if q == 0:
                corrections.append(f'dropped zero-denominator ({p}/0)')
                return ''
            if q in self.denominators:
                g = math.gcd(p, q)
                if g > 1:
                    corrections.append(f'canonicalized ({p}/{q})')
                    return f'({p//g}/{q//g})'
                return m.group(0)
            val = p / q
            np_, nq = self._snap_value(val)
            if abs(np_ / nq - val) <= self.snap_tolerance and (np_, nq) != (p, q):
                corrections.append(f'snapped ({p}/{q}) -> ({np_}/{nq})')
                return f'({np_}/{nq})'
            return m.group(0)

        f = _FRAC.sub(snap, formula)

        if self.enforce_site_sums:
            f = self._fix_site_sums(f, corrections)

        return FractionCorrectionResult(
            original=formula, corrected=f, corrections=corrections)

    def _fix_site_sums(self, formula: str, corrections: List[str]) -> str:
        """If consecutive fractional occupancies sum to nearly (but not
        exactly) an integer, nudge the LAST one so they do — doped sites
        should sum to full occupancy."""
        matches = list(_FRAC.finditer(formula))
        if len(matches) < 2:
            return formula
        vals = [Fraction(int(m.group(1)), int(m.group(2))) for m in matches]
        total = float(sum(vals))
        nearest = round(total)
        if nearest >= 1 and 0 < abs(total - nearest) <= 0.05:
            deficit = Fraction(nearest) - sum(vals[:-1])
            if 0 < deficit < 2:
                m = matches[-1]
                new = f'({deficit.numerator}/{deficit.denominator})'
                corrections.append(
                    f'site-sum fix {m.group(0)} -> {new} (sum {total:.3f} -> {nearest})')
                return formula[:m.start()] + new + formula[m.end():]
        return formula
