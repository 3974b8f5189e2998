"""Isotope strings (port of the part of chem/isotopes.py that the vocab
migration needs: ``parse_isotope``)."""

from __future__ import annotations

import re
from typing import Tuple

_ISO_RE = re.compile(r'^(\d+)([A-Z][a-z]?)$')


def parse_isotope(iso: str) -> Tuple[int, str]:
    """'18O' -> (18, 'O')."""
    m = _ISO_RE.match(iso)
    if not m:
        raise ValueError(f'bad isotope string: {iso!r}')
    return int(m.group(1)), m.group(2)
