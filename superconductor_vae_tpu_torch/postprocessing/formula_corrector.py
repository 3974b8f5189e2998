"""Structural repair of malformed generated formulas (port of
postprocessing/formula_corrector.py; host code, the same logic).

As the reference corrector (reference:
postprocessing/formula_corrector.py:91-470): truncate trailing garbage, fix slashes/empty fractions, balance parentheses,
fuzzy-fix near-miss element symbols, strip invalid characters, validate.
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Tuple

from ..chem.elements import ELEMENT_SYMBOLS, SYMBOL_TO_Z

_VALID = re.compile(r'^(\{\d+\})?([A-Z][a-z]?)((\(\d+/\d+\))|\d+)?$')
_TOKENIZE = re.compile(
    r'\{\d+\}[A-Z][a-z]?(?:\(\d+/\d+\)|\d+)?'
    r'|[A-Z][a-z]?(?:\(\d+/\d+\)|\d+)?')

# case-fix lookup: lowercase symbol -> canonical
_CASEFIX = {s.lower(): s for s in ELEMENT_SYMBOLS[1:]}


@dataclasses.dataclass
class CorrectionResult:
    original: str
    corrected: str
    corrections: List[str]
    is_valid: bool

    @property
    def was_corrected(self) -> bool:
        return self.original != self.corrected


class FormulaCorrector:
    def correct(self, formula: str) -> CorrectionResult:
        corrections: List[str] = []
        f = formula

        # strip invalid characters (keep element chars, digits, (), /, {})
        cleaned = re.sub(r'[^A-Za-z0-9()/{}]', '', f)
        if cleaned != f:
            corrections.append('removed invalid characters')
            f = cleaned

        # multiple slashes inside a fraction -> keep first
        fixed = re.sub(r'\((\d+)/+(\d+)(?:/\d+)*\)', r'(\1/\2)', f)
        if fixed != f:
            corrections.append('fixed multiple slashes')
            f = fixed

        # empty fractions
        fixed = re.sub(r'\(\s*/?\s*\)', '', f)
        if fixed != f:
            corrections.append('removed empty fraction')
            f = fixed

        # fraction without slash: (34) -> heuristically (3/4)
        def _noslash(m):
            digits = m.group(1)
            if len(digits) >= 2:
                return f'({digits[:-1]}/{digits[-1]})' if digits[-1] != '0' \
                    else f'({digits[0]}/{digits[1:]})'
            return digits  # single digit: treat as integer subscript

        fixed = re.sub(r'\((\d+)\)', _noslash, f)
        if fixed != f:
            corrections.append('fixed slashless fraction')
            f = fixed

        # unbalanced parentheses
        if f.count('(') != f.count(')'):
            f2 = f.replace('(', '').replace(')', '') \
                if abs(f.count('(') - f.count(')')) > 1 else (
                    f + ')' if f.count('(') > f.count(')') else f.replace(')', '', 1))
            corrections.append('balanced parentheses')
            f = f2

        # fuzzy element fix: scanner-based — only repair segments that do not
        # already parse as valid element tokens (so "YBa2" stays Y + Ba2 and
        # never becomes Yb)
        if not self.validate(f):
            fixed = self._scan_repair(f)
            if fixed != f:
                corrections.append('fixed element capitalization')
                f = fixed

        # truncate trailing garbage: drop trailing chars that are not part of
        # a valid token sequence
        tokens = _TOKENIZE.findall(f)
        reassembled = ''.join(tokens)
        if reassembled != f and reassembled:
            corrections.append('truncated garbage')
            f = reassembled

        return CorrectionResult(
            original=formula, corrected=f, corrections=corrections,
            is_valid=self.validate(f))

    def _scan_repair(self, f: str) -> str:
        """Greedy left-to-right scan preferring valid symbols, falling back
        to case-fixed 2- then 1-letter candidates."""
        out = []
        i = 0
        while i < len(f):
            ch = f[i]
            if not ch.isalpha():
                out.append(ch)
                i += 1
                continue
            two, one = f[i:i + 2], f[i:i + 1]
            if two[:1].isupper() and two[1:].islower() and two in SYMBOL_TO_Z:
                out.append(two); i += 2
            elif one in SYMBOL_TO_Z:
                out.append(one); i += 1
            elif len(two) == 2 and two.isalpha() and two.lower() in _CASEFIX:
                out.append(_CASEFIX[two.lower()]); i += 2
            elif one.upper() in SYMBOL_TO_Z:
                out.append(one.upper()); i += 1
            else:
                i += 1  # drop unknown letter
        return ''.join(out)

    def validate(self, formula: str) -> bool:
        if not formula:
            return False
        tokens = _TOKENIZE.findall(formula)
        if ''.join(tokens) != formula:
            return False
        for t in tokens:
            sym = re.sub(r'^\{\d+\}', '', t)
            sym = re.sub(r'(\(\d+/\d+\))|\d+$', '', sym)
            if sym not in SYMBOL_TO_Z:
                return False
        return True

    def correct_batch(self, formulas: List[str]) -> List[CorrectionResult]:
        return [self.correct(f) for f in formulas]
