"""Materials Project client for non-superconductor negatives (port of
utils/materials_api.py).

Fetches stable non-SC compositions from the Materials Project REST API
when an API key and the network are available, and otherwise serves the
curated fallback lists (reference: src/superconductor/utils/
materials_api.py:1-398).  Without ``MP_API_KEY`` no request is made.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

# Curated stable non-superconducting compounds used as negatives when the
# API is unreachable (fallback lists as in the reference).
FALLBACK_NON_SC: List[Dict[str, object]] = [
    {'formula': 'NaCl', 'category': 'Non-SC: Materials Project'},
    {'formula': 'SiO2', 'category': 'Non-SC: Materials Project'},
    {'formula': 'Al2O3', 'category': 'Non-SC: Materials Project'},
    {'formula': 'MgO', 'category': 'Non-SC: Materials Project'},
    {'formula': 'TiO2', 'category': 'Non-SC: Materials Project'},
    {'formula': 'Fe2O3', 'category': 'Non-SC: Magnetic'},
    {'formula': 'Fe3O4', 'category': 'Non-SC: Magnetic'},
    {'formula': 'CoFe2O4', 'category': 'Non-SC: Magnetic'},
    {'formula': 'NiO', 'category': 'Non-SC: Magnetic'},
    {'formula': 'Bi2Te3', 'category': 'Non-SC: Thermoelectric'},
    {'formula': 'PbTe', 'category': 'Non-SC: Thermoelectric'},
    {'formula': 'SnSe', 'category': 'Non-SC: Thermoelectric'},
    {'formula': 'CaTiO3', 'category': 'Non-SC: Materials Project'},
    {'formula': 'BaTiO3', 'category': 'Non-SC: Materials Project'},
    {'formula': 'SrTiO3', 'category': 'Non-SC: Materials Project'},
    {'formula': 'ZnO', 'category': 'Non-SC: Materials Project'},
    {'formula': 'GaAs', 'category': 'Non-SC: Materials Project'},
    {'formula': 'InP', 'category': 'Non-SC: Materials Project'},
    {'formula': 'Si3N4', 'category': 'Non-SC: Materials Project'},
    {'formula': 'ZrO2', 'category': 'Non-SC: Materials Project'},
    {'formula': 'MnO2', 'category': 'Non-SC: Magnetic'},
    {'formula': 'Cr2O3', 'category': 'Non-SC: Magnetic'},
    {'formula': 'Sb2Te3', 'category': 'Non-SC: Thermoelectric'},
    {'formula': 'CuO', 'category': 'Non-SC: Materials Project'},
    {'formula': 'WO3', 'category': 'Non-SC: Materials Project'},
]


class MaterialsProjectClient:
    BASE_URL = 'https://api.materialsproject.org/materials/summary/'

    def __init__(self, api_key: Optional[str] = None, timeout: float = 10.0):
        self.api_key = api_key or os.environ.get('MP_API_KEY')
        self.timeout = timeout

    def fetch_non_sc(self, n: int = 1000,
                     elements: Optional[List[str]] = None
                     ) -> List[Dict[str, object]]:
        """Stable non-SC compositions. Falls back to the curated list when
        offline / keyless."""
        if not self.api_key:
            return self._fallback(n)
        try:
            import urllib.request
            params = f'?_limit={n}&is_stable=true&_fields=formula_pretty'
            if elements:
                params += f'&elements={",".join(elements)}'
            req = urllib.request.Request(
                self.BASE_URL + params,
                headers={'X-API-KEY': self.api_key})
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                data = json.loads(r.read())
            return [{'formula': d['formula_pretty'],
                     'category': 'Non-SC: Materials Project'}
                    for d in data.get('data', [])][:n]
        except Exception:
            return self._fallback(n)

    @staticmethod
    def _fallback(n: int) -> List[Dict[str, object]]:
        out = []
        i = 0
        while len(out) < n and i < 100:
            for row in FALLBACK_NON_SC:
                if len(out) >= n:
                    break
                out.append(dict(row))
            i += 1
        return out[:n]
