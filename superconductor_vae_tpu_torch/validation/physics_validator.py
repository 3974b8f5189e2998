"""Family-agnostic physical plausibility checks (port of
validation/physics_validator.py; host code, the same logic).

As the reference physics validator (reference:
validation/physics_validator.py:50-517): Hume-Rothery size/electronegativity rules, immiscible element pairs, bond
compatibility, composition reasonableness, and synthesis-route suggestions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from ..chem.elements import get_element_property, SYMBOL_TO_Z
from ..data.pipeline import parse_formula_composition

# classic immiscible / non-reactive metallic pairs
_IMMISCIBLE = {
    frozenset(p) for p in (
        ('Fe', 'Cu'), ('Fe', 'Ag'), ('Cu', 'W'), ('Ag', 'Ni'),
        ('Pb', 'Fe'), ('Pb', 'Al'), ('Cu', 'Mo'), ('Ag', 'Co'),
    )
}


@dataclasses.dataclass
class PhysicsValidationResult:
    formula: str
    is_plausible: bool
    plausibility: float
    checks: Dict[str, bool]
    warnings: List[str]
    synthesis_routes: List[str]


class PhysicsValidator:
    def __init__(self, size_mismatch_limit: float = 0.30,
                 en_diff_limit: float = 2.2):
        self.size_mismatch_limit = size_mismatch_limit
        self.en_diff_limit = en_diff_limit

    def _classify(self, el: str) -> str:
        z = SYMBOL_TO_Z.get(el, 0)
        if el in ('O', 'S', 'Se', 'Te'):
            return 'chalcogen'
        if el in ('F', 'Cl', 'Br', 'I'):
            return 'halogen'
        if el in ('N', 'P', 'As', 'Sb', 'Bi'):
            return 'pnictogen'
        if 57 <= z <= 71 or 89 <= z <= 103:
            return 'f-block'
        d = get_element_property(el, 'd_electrons') or 0
        if 0 < d < 10:
            return 'transition-metal'
        if z in (1,):
            return 'hydrogen'
        return 'main-group'

    def _hume_rothery(self, comp: Dict[str, float]) -> Tuple[bool, List[str]]:
        """Metallic solid solutions need <15-30% size mismatch and modest
        electronegativity difference."""
        warns = []
        metalloids = {'B', 'C', 'Si', 'Ge', 'As', 'Sb', 'Te'}
        metals = [e for e in comp
                  if self._classify(e) in
                  ('transition-metal', 'main-group', 'f-block')
                  and e not in metalloids and e != 'H']
        radii = [(e, get_element_property(e, 'atomic_radius') or 0)
                 for e in metals]
        radii = [(e, r) for e, r in radii if r > 0]
        for i in range(len(radii)):
            for j in range(i + 1, len(radii)):
                (a, ra), (b, rb) = radii[i], radii[j]
                mismatch = abs(ra - rb) / max(ra, rb)
                if mismatch > self.size_mismatch_limit:
                    warns.append(f'size mismatch {a}/{b}: {mismatch:.0%}')
        # Hume-Rothery is an ALLOY rule: hard-fail only for metal-only
        # compositions (>= 3 metals, no anion formers) where every metallic
        # pair mismatches; line compounds with anions get warnings only.
        n_pairs = len(radii) * (len(radii) - 1) // 2
        metal_only = len(metals) == len(comp)
        hard_fail = (metal_only and len(radii) >= 3
                     and n_pairs > 0 and len(warns) >= n_pairs)
        return not hard_fail, warns

    def _bond_compat(self, comp: Dict[str, float]) -> Tuple[bool, List[str]]:
        warns = []
        ens = {e: get_element_property(e, 'electronegativity') or 0
               for e in comp}
        vals = [v for v in ens.values() if v > 0]
        if len(vals) >= 2 and max(vals) - min(vals) > self.en_diff_limit:
            anions = [e for e, v in ens.items()
                      if self._classify(e) in ('chalcogen', 'halogen', 'pnictogen')]
            if not anions:
                warns.append('large EN spread without an anion former')
                return False, warns
        return True, warns

    def _combinations(self, comp: Dict[str, float]) -> Tuple[bool, List[str]]:
        els = set(comp)
        warns = []
        for pair in _IMMISCIBLE:
            if pair <= els:
                warns.append(f'immiscible pair {sorted(pair)}')
        return len(warns) == 0 or len(els) > 3, warns

    def _reasonable(self, comp: Dict[str, float]) -> Tuple[bool, List[str]]:
        if not comp:
            return False, ['empty composition']
        total = sum(comp.values())
        warns = []
        for e, amt in comp.items():
            if amt / total > 0.95 and len(comp) > 1:
                warns.append(f'{e} dominates at {amt/total:.0%}')
        return True, warns

    def _synthesis(self, comp: Dict[str, float]) -> List[str]:
        els = set(comp)
        routes = []
        if 'O' in els:
            routes.append('solid-state oxide synthesis (calcination in O2)')
        if 'H' in els and comp.get('H', 0) >= 2:
            routes.append('high-pressure hydride synthesis (DAC, >100 GPa)')
        if els & {'As', 'P', 'Se', 'Te'} and 'Fe' in els:
            routes.append('sealed-quartz-ampoule flux growth')
        if not routes:
            routes.append('arc melting / solid-state reaction')
        return routes

    def validate(self, formula: str,
                 stoichiometry: Dict[str, float] | None = None
                 ) -> PhysicsValidationResult:
        comp = stoichiometry or parse_formula_composition(formula)
        checks = {}
        warnings: List[str] = []
        for name, fn in (('hume_rothery', self._hume_rothery),
                         ('bond_compatibility', self._bond_compat),
                         ('element_combinations', self._combinations),
                         ('composition', self._reasonable)):
            ok, warns = fn(comp)
            checks[name] = ok
            warnings += warns
        plausibility = sum(checks.values()) / len(checks)
        plausibility *= max(0.3, 1.0 - 0.1 * len(warnings))
        return PhysicsValidationResult(
            formula=formula,
            is_plausible=all(checks.values()),
            plausibility=plausibility,
            checks=checks, warnings=warnings,
            synthesis_routes=self._synthesis(comp))
