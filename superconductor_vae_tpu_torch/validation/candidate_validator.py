"""Chemical plausibility validation for generated formulas (port of
validation/candidate_validator.py; host code, the same logic).

As the reference validator (reference: validation/candidate_validator.py:
55-505): charge balance via common oxidation states, electronegativity spread,
element-compatibility heuristics, stoichiometry sanity, and a composition
-based superconductor-likelihood score with structure-type inference.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..chem.elements import (
    SYMBOL_TO_Z, get_element_property, get_oxidation_states,
)
from ..data.pipeline import parse_formula_composition


@dataclasses.dataclass
class ValidationResult:
    formula: str
    is_valid: bool
    score: float                      # 0..1 plausibility
    checks: Dict[str, bool]
    issues: List[str]
    sc_likelihood: float
    structure_type: Optional[str] = None


_NOBLE = {'He', 'Ne', 'Ar', 'Kr', 'Xe', 'Rn'}


class CandidateValidator:
    def __init__(self, charge_tolerance: float = 1.0,
                 max_en_spread: float = 3.2, max_elements: int = 9,
                 max_amount: float = 50.0):
        self.charge_tolerance = charge_tolerance
        self.max_en_spread = max_en_spread
        self.max_elements = max_elements
        self.max_amount = max_amount

    # -- checks --------------------------------------------------------------
    def _charge_balance(self, comp: Dict[str, float]) -> Tuple[bool, str]:
        """Can ANY combination of common oxidation states balance (approx)?
        Greedy: assign anions their most-negative state, cations their range,
        and test whether 0 lies inside the achievable charge interval."""
        lo = hi = 0.0
        for el, amt in comp.items():
            states = get_oxidation_states(el) or [0]
            lo += amt * min(states)
            hi += amt * max(states)
        ok = lo - self.charge_tolerance <= 0.0 <= hi + self.charge_tolerance
        return ok, '' if ok else f'charge interval [{lo:.1f},{hi:.1f}] excludes 0'

    def _en_spread(self, comp: Dict[str, float]) -> Tuple[bool, str]:
        ens = [get_element_property(el, 'electronegativity') or 0.0
               for el in comp]
        ens = [e for e in ens if e > 0]
        if len(ens) < 2:
            return True, ''
        spread = max(ens) - min(ens)
        ok = spread <= self.max_en_spread
        return ok, '' if ok else f'electronegativity spread {spread:.2f}'

    def _compatibility(self, comp: Dict[str, float]) -> Tuple[bool, str]:
        els = set(comp)
        if els & _NOBLE:
            return False, f'noble gas in formula: {els & _NOBLE}'
        if {'F', 'Tl'} <= els:
            return False, 'forbidden pair F+Tl'
        return True, ''

    def _stoichiometry(self, comp: Dict[str, float]) -> Tuple[bool, str]:
        if not comp:
            return False, 'no parseable elements'
        if len(comp) > self.max_elements:
            return False, f'{len(comp)} elements (> {self.max_elements})'
        for el, amt in comp.items():
            if amt <= 0 or amt > self.max_amount:
                return False, f'{el} amount {amt} out of range'
        return True, ''

    def _sc_likelihood(self, comp: Dict[str, float]) -> Tuple[float, Optional[str]]:
        els = set(comp)
        if {'Cu', 'O'} <= els and els & {'Ba', 'Sr', 'La', 'Y', 'Bi', 'Tl', 'Hg', 'Ca'}:
            return 0.9, 'cuprate-layered'
        if 'Fe' in els and els & {'As', 'P', 'Se', 'Te'}:
            return 0.8, 'iron-based'
        if {'Mg', 'B'} <= els or ('B' in els and len(els) <= 3):
            return 0.7, 'diboride'
        if 'H' in els and comp.get('H', 0) >= 4:
            return 0.6, 'hydride (high pressure)'
        if els & {'Nb', 'V', 'Ta'} and len(els) <= 3:
            return 0.6, 'A15/alloy'
        if els & {'U', 'Ce', 'Yb', 'Pu'}:
            return 0.5, 'heavy-fermion'
        if len(els) <= 2:
            return 0.4, 'simple-metallic'
        return 0.25, None

    # -- API -----------------------------------------------------------------
    def validate(self, formula: str) -> ValidationResult:
        comp = parse_formula_composition(formula)
        checks: Dict[str, bool] = {}
        issues: List[str] = []

        for name, fn in (('stoichiometry', self._stoichiometry),
                         ('charge_balance', self._charge_balance),
                         ('electronegativity', self._en_spread),
                         ('compatibility', self._compatibility)):
            ok, msg = fn(comp)
            checks[name] = ok
            if not ok:
                issues.append(msg)

        sc_like, structure = self._sc_likelihood(comp) if comp else (0.0, None)
        n_pass = sum(checks.values())
        score = (n_pass / len(checks)) * (0.5 + 0.5 * sc_like)
        return ValidationResult(
            formula=formula,
            is_valid=checks['stoichiometry'] and checks['compatibility'],
            score=score, checks=checks, issues=issues,
            sc_likelihood=sc_like, structure_type=structure)

    def validate_batch(self, formulas: List[str]) -> List[ValidationResult]:
        return [self.validate(f) for f in formulas]
