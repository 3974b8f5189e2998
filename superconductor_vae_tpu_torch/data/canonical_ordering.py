"""Canonical element ordering and order augmentation for formula strings
(port of data/canonical_ordering.py).

Five ordering methods (electronegativity, alphabetical, abundance, Hill,
atomic number) and random order augmentation: chemical formulas are
order-agnostic, so training on several orderings improves robustness.
Parsing keeps each element's raw amount string (``(p/q)`` fraction,
integer or decimal), so a re-ordering round-trips through the tokenizer.
Host-side string code, the JAX package's line for line; the augmentation
draws from ``random.Random(seed)`` as there, so a seed gives the same
spellings.
"""

from __future__ import annotations

import random
import re
from enum import Enum
from fractions import Fraction
from typing import List, Optional, Sequence, Tuple

from ..chem.elements import SYMBOL_TO_Z, get_element_property

# Element+amount scanner for the shared fraction-format grammar
# (El, El(p/q), El(n), Eln, Eln.m). The grammar — not the reference's
# code — determines this pattern; named groups keep it structurally our
# own. (Reference's equivalent scanner: data/canonical_ordering.py:126.)
_ELEM_RE = re.compile(
    r'(?P<sym>[A-Z][a-z]?)'
    r'(?:'
    r'\((?P<num>\d+)/(?P<den>\d+)\)'      # parenthesized fraction (p/q)
    r'|\((?P<pint>\d+)\)'                 # parenthesized integer (n)
    r'|(?P<dec>\d+(?:\.\d+)?)'            # bare integer / decimal
    r')?'
)


class OrderingMethod(Enum):
    ELECTRONEGATIVITY = 'electronegativity'
    ALPHABETICAL = 'alphabetical'
    ABUNDANCE = 'abundance'
    HILL_SYSTEM = 'hill'
    ATOMIC_NUMBER = 'atomic_number'


def parse_ordered(formula: str) -> List[Tuple[str, str, float]]:
    """Formula -> ordered [(element, raw amount string, numeric value)].

    Handles ``La(7/10)Sr(3/10)CuO4``, ``YBa2Cu3O7``, ``Mg0.9Al0.1B2``.
    Unknown symbols are skipped (mirrors the reference's lenient parse).
    """
    out = []
    for m in _ELEM_RE.finditer(formula):
        sym = m.group('sym')
        if sym not in SYMBOL_TO_Z:
            continue
        if m.group('num') and m.group('den'):
            amt = f"({m.group('num')}/{m.group('den')})"
            val = float(Fraction(int(m.group('num')), int(m.group('den'))))
        elif m.group('pint'):
            amt = f"({m.group('pint')})"
            val = float(m.group('pint'))
        elif m.group('dec'):
            amt = m.group('dec')
            val = float(m.group('dec'))
        else:
            amt, val = '', 1.0
        out.append((sym, amt, val))
    return out


def _sort_key(method: OrderingMethod):
    if method == OrderingMethod.ELECTRONEGATIVITY:
        # lower electronegativity first: cations before anions
        return lambda e: (get_element_property(e[0], 'electronegativity')
                          or 2.0, e[0])
    if method == OrderingMethod.ALPHABETICAL:
        return lambda e: (e[0],)
    if method == OrderingMethod.ABUNDANCE:
        # larger fraction first, alphabetical tiebreak
        return lambda e: (-e[2], e[0])
    if method == OrderingMethod.HILL_SYSTEM:
        return lambda e: ((0 if e[0] == 'C' else 1 if e[0] == 'H' else 2),
                          e[0])
    if method == OrderingMethod.ATOMIC_NUMBER:
        return lambda e: (SYMBOL_TO_Z.get(e[0], 999), e[0])
    return lambda e: (e[0],)


def join_ordered(elements: Sequence[Tuple[str, str, float]]) -> str:
    return ''.join(f'{sym}{amt}' for sym, amt, _ in elements)


def canonicalize(formula: str,
                 method: OrderingMethod = OrderingMethod.ELECTRONEGATIVITY
                 ) -> str:
    """Reorder a formula's elements by the given canonical method."""
    elements = parse_ordered(formula)
    if not elements:
        return formula
    return join_ordered(sorted(elements, key=_sort_key(method)))


def canonicalize_batch(formulas: Sequence[str],
                       method: OrderingMethod =
                       OrderingMethod.ELECTRONEGATIVITY) -> List[str]:
    return [canonicalize(f, method) for f in formulas]


# convenience wrappers (reference: canonical_ordering.py:298-316)
def to_electronegativity_order(formula: str) -> str:
    return canonicalize(formula, OrderingMethod.ELECTRONEGATIVITY)


def to_alphabetical_order(formula: str) -> str:
    return canonicalize(formula, OrderingMethod.ALPHABETICAL)


def to_abundance_order(formula: str) -> str:
    return canonicalize(formula, OrderingMethod.ABUNDANCE)


class OrderAugmentation:
    """Order-shuffling data augmentation (reference: :228-295).

    Generates up to ``n_augmentations`` distinct random element orderings
    per formula; duplicates are skipped.
    """

    def __init__(self, n_augmentations: int = 2,
                 seed: Optional[int] = None):
        self.n_augmentations = n_augmentations
        self.rng = random.Random(seed)

    def augment(self, formula: str,
                include_original: bool = True) -> List[str]:
        elements = parse_ordered(formula)
        if len(elements) <= 1:
            # single-element formulas have exactly one spelling
            return [formula] if include_original else []
        out = [formula] if include_original else []
        seen = {formula}
        target = self.n_augmentations + (1 if include_original else 0)
        for _ in range(self.n_augmentations * 2):
            if len(out) >= target:
                break
            shuffled = list(elements)
            self.rng.shuffle(shuffled)
            f = join_ordered(shuffled)
            if f not in seen:
                seen.add(f)
                out.append(f)
        return out

    def augment_batch(self, formulas: Sequence[str],
                      include_original: bool = True) -> List[str]:
        out: List[str] = []
        for f in formulas:
            out.extend(self.augment(f, include_original))
        return out
