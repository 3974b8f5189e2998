"""Isotope database derived from the isotope vocabulary (port of
chem/isotopes.py): the ``ISOTOPES`` list of ``data/isotope_vocab.json``,
nuclear spins, the BCS isotope-effect estimate, the ``[n_isotopes, 4]``
feature matrix aligned with the ISO token order, and the isotope-aware
encoding of a formula.  Host-side numpy, as in the JAX package.

Feature columns: (mass_number, mass_deviation_from_natural, nuclear_spin,
isotope_effect_scale) where isotope_effect_scale = (M_nat / M_iso)^alpha with
the BCS alpha = 0.5 (Tc ∝ M^-alpha).
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from .elements import SYMBOL_TO_Z, _PROPERTY_MATRIX, PROPERTY_NAMES

_MASS_COL = PROPERTY_NAMES.index('mass')
_ISO_RE = re.compile(r'^(\d+)([A-Z][a-z]?)$')

# Nuclear spins for the common odd-A / odd-odd isotopes that matter for
# superconductivity studies (NMR-active nuclei); even-even nuclei have spin 0.
_KNOWN_SPINS: Dict[str, float] = {
    '1H': 0.5, '2H': 1.0, '3H': 0.5, '3He': 0.5, '6Li': 1.0, '7Li': 1.5,
    '9Be': 1.5, '10B': 3.0, '11B': 1.5, '13C': 0.5, '14N': 1.0, '15N': 0.5,
    '17O': 2.5, '19F': 0.5, '23Na': 1.5, '25Mg': 2.5, '27Al': 2.5,
    '29Si': 0.5, '31P': 0.5, '33S': 1.5, '35Cl': 1.5, '37Cl': 1.5,
    '39K': 1.5, '41K': 1.5, '43Ca': 3.5, '45Sc': 3.5, '47Ti': 2.5,
    '49Ti': 3.5, '51V': 3.5, '53Cr': 1.5, '55Mn': 2.5, '57Fe': 0.5,
    '59Co': 3.5, '61Ni': 1.5, '63Cu': 1.5, '65Cu': 1.5, '67Zn': 2.5,
    '69Ga': 1.5, '71Ga': 1.5, '73Ge': 4.5, '75As': 1.5, '77Se': 0.5,
    '79Br': 1.5, '81Br': 1.5, '85Rb': 2.5, '87Rb': 1.5, '87Sr': 4.5,
    '89Y': 0.5, '91Zr': 2.5, '93Nb': 4.5, '95Mo': 2.5, '97Mo': 2.5,
    '99Ru': 2.5, '101Ru': 2.5, '103Rh': 0.5, '105Pd': 2.5, '107Ag': 0.5,
    '109Ag': 0.5, '111Cd': 0.5, '113Cd': 0.5, '113In': 4.5, '115In': 4.5,
    '115Sn': 0.5, '117Sn': 0.5, '119Sn': 0.5, '121Sb': 2.5, '123Sb': 3.5,
    '123Te': 0.5, '125Te': 0.5, '127I': 2.5, '133Cs': 3.5, '135Ba': 1.5,
    '137Ba': 1.5, '139La': 3.5, '141Pr': 2.5, '143Nd': 3.5, '145Nd': 3.5,
    '147Sm': 3.5, '149Sm': 3.5, '151Eu': 2.5, '153Eu': 2.5, '155Gd': 1.5,
    '157Gd': 1.5, '159Tb': 1.5, '161Dy': 2.5, '163Dy': 2.5, '165Ho': 3.5,
    '167Er': 3.5, '169Tm': 0.5, '171Yb': 0.5, '173Yb': 2.5, '175Lu': 3.5,
    '177Hf': 3.5, '179Hf': 4.5, '181Ta': 3.5, '183W': 0.5, '185Re': 2.5,
    '187Re': 2.5, '187Os': 0.5, '189Os': 1.5, '191Ir': 1.5, '193Ir': 1.5,
    '195Pt': 0.5, '197Au': 1.5, '199Hg': 0.5, '201Hg': 1.5, '203Tl': 0.5,
    '205Tl': 0.5, '207Pb': 0.5, '209Bi': 4.5, '235U': 3.5,
}

BCS_ALPHA = 0.5


def _default_isotope_list() -> List[str]:
    path = Path(__file__).resolve().parents[2] / 'data' / 'isotope_vocab.json'
    if path.exists():
        with open(path) as f:
            return json.load(f)['isotopes']
    return []


ISOTOPES: List[str] = _default_isotope_list()


def parse_isotope(iso: str) -> Tuple[int, str]:
    """'18O' -> (18, 'O')."""
    m = _ISO_RE.match(iso)
    if not m:
        raise ValueError(f'bad isotope string: {iso!r}')
    return int(m.group(1)), m.group(2)


def nuclear_spin(iso: str) -> float:
    if iso in _KNOWN_SPINS:
        return _KNOWN_SPINS[iso]
    a, sym = parse_isotope(iso)
    z = SYMBOL_TO_Z.get(sym, 0)
    n = a - z
    if z % 2 == 0 and n % 2 == 0:
        return 0.0
    if z % 2 == 1 and n % 2 == 1:
        return 1.0
    return 0.5


def estimate_isotope_effect(iso: str, alpha: float = BCS_ALPHA) -> float:
    """BCS isotope effect Tc ∝ M^-alpha: returns Tc(iso)/Tc(natural)."""
    a, sym = parse_isotope(iso)
    z = SYMBOL_TO_Z.get(sym)
    if z is None:
        return 1.0
    m_nat = float(_PROPERTY_MATRIX[z, _MASS_COL])
    if m_nat <= 0:
        return 1.0
    return (m_nat / float(a)) ** alpha


def isotope_feature_matrix(isotopes: List[str] | None = None) -> np.ndarray:
    """``[n_isotopes, 4]`` feature matrix aligned with ISO token order."""
    isotopes = isotopes if isotopes is not None else ISOTOPES
    feats = np.zeros((len(isotopes), 4), dtype=np.float32)
    for i, iso in enumerate(isotopes):
        a, sym = parse_isotope(iso)
        z = SYMBOL_TO_Z.get(sym, 0)
        m_nat = float(_PROPERTY_MATRIX[z, _MASS_COL]) if z else float(a)
        feats[i] = (
            float(a),
            float(a) - m_nat,
            nuclear_spin(iso),
            estimate_isotope_effect(iso),
        )
    return feats


# ---- per-formula isotope-aware encoding ---------------------------------------

_ISO_COMP_RE = re.compile(
    r'(?:\{(?P<iso_a>\d+)\}|(?P<pre_a>\d+)(?=[A-Z][a-z]?))?'   # {18}O or 18O
    r'(?P<el>[A-Z][a-z]?)'
    r'(?:\((?P<num>\d+)/(?P<den>\d+)\)|(?P<dec>\d+\.\d+)|(?P<int>\d+))?'
)


def encode_isotope_composition(formula: str) -> Dict[str, np.ndarray]:
    """Formula -> isotope-aware per-element features + 4 aggregates.

    Capability parity with the reference ``IsotopeEncoder.encode``
    (reference: encoders/isotope_encoder.py:227-420): per element —
    fraction, (isotope or natural) mass, nuclear spin, mass deviation from
    natural; aggregated — normalized average mass, fraction-weighted spin,
    mean mass deviation, and the BCS isotope-effect factor
    ``(M_natural_total / M_actual_total)^0.5 - 1`` (0 = natural; positive =
    lighter isotopes, higher Tc under BCS).

    Accepts both ``{18}O`` (tokenizer notation) and ``18O``-prefix isotope
    markers alongside (p/q) / decimal / integer amounts.
    """
    symbols: List[str] = []
    fractions: List[float] = []
    masses: List[float] = []
    spins: List[float] = []
    deviations: List[float] = []
    amounts: Dict[str, float] = {}
    iso_of: Dict[str, int] = {}

    for m in _ISO_COMP_RE.finditer(formula):
        el = m.group('el')
        if not el or el not in SYMBOL_TO_Z:
            continue
        qty = 1.0
        if m.group('num') is not None:
            den = int(m.group('den'))
            qty = int(m.group('num')) / den if den else 1.0
        elif m.group('dec') is not None:
            qty = float(m.group('dec'))
        elif m.group('int') is not None:
            qty = float(m.group('int'))
        amounts[el] = amounts.get(el, 0.0) + qty
        a = m.group('iso_a') or m.group('pre_a')
        if a:
            iso_of[el] = int(a)

    if not amounts:
        raise ValueError(f'could not parse formula: {formula!r}')

    total = sum(amounts.values())
    natural_total = 0.0
    actual_total = 0.0
    for el, qty in amounts.items():
        z = SYMBOL_TO_Z[el]
        m_nat = float(_PROPERTY_MATRIX[z, _MASS_COL])
        a = iso_of.get(el, 0)
        if a > 0:
            mass = float(a)
            spin = nuclear_spin(f'{a}{el}')
        else:
            mass = m_nat
            spin = 0.0
        symbols.append(el)
        fractions.append(qty / total)
        masses.append(mass)
        spins.append(spin)
        deviations.append((mass - m_nat) / m_nat if m_nat > 0 else 0.0)
        natural_total += m_nat * qty
        actual_total += mass * qty

    effect = ((natural_total / actual_total) ** BCS_ALPHA
              if natural_total > 0 and actual_total > 0 else 1.0)
    fr = np.asarray(fractions, np.float32)
    ms = np.asarray(masses, np.float32)
    sp = np.asarray(spins, np.float32)
    dv = np.asarray(deviations, np.float32)
    return {
        'symbols': np.asarray(symbols),
        'element_indices': np.asarray(
            [SYMBOL_TO_Z[s] for s in symbols], np.int32),
        'element_fractions': fr,
        'element_masses': ms,
        'element_spins': sp,
        'mass_deviations': dv,
        'total_mass': np.float32(actual_total),
        # aggregated [4] (reference: isotope_encoder.py:383-390)
        'isotope_features': np.asarray(
            [ms.mean() / 200.0, float((sp * fr).sum()), float(dv.mean()),
             effect - 1.0], np.float32),
    }
