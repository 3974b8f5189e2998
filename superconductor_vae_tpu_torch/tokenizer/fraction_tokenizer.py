"""Fraction/isotope-aware semantic tokenizer (copied from
tokenizer/fraction_tokenizer.py of the JAX package, whose token ids it keeps).

Vocabulary layout:

    [0..4]            PAD, BOS, EOS, UNK, FRAC_UNK
    [5..122]          118 element tokens (H .. Og)
    [123..142]        integer tokens "1".."20"
    [143..143+F-1]    FRAC:p/q semantic fraction tokens (F = 4317 shipped vocab)
    [143+F]           ISO_UNK
    [143+F+1 .. ]     ISO:massSymbol isotope tokens (291 shipped vocab)

Device-side consumers read dense numpy LUTs: ``token_type_table`` [V] int32,
``type_masks`` [5, V] bool, ``fraction_value_table`` [V] float32,
``token_to_element_z`` [V] int32 (training/train_step.py build_luts moves
them to the device).  The vocab files are read from the repository's
``data/`` directory.
"""

from __future__ import annotations

import json
import math
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..chem.elements import ELEMENT_SYMBOLS

# --- vocabulary constants (fixed layout) -----------------------------------
PAD_ID, BOS_ID, EOS_ID, UNK_ID, FRAC_UNK_ID = 0, 1, 2, 3, 4
N_SPECIAL = 5
N_ELEMENTS = 118
MAX_INTEGER = 20
ELEMENT_TOKEN_START = N_SPECIAL                        # 5
INTEGER_TOKEN_START = N_SPECIAL + N_ELEMENTS           # 123
FRACTION_TOKEN_START = INTEGER_TOKEN_START + MAX_INTEGER  # 143

PAD_TOKEN, BOS_TOKEN, EOS_TOKEN = '<PAD>', '<BOS>', '<EOS>'
UNK_TOKEN, FRAC_UNK_TOKEN, ISO_UNK_TOKEN = '<UNK>', '<FRAC_UNK>', '<ISO_UNK>'

# token-type classes (order matters: used as class indices by the type head)
TOKEN_TYPE_ELEMENT = 0
TOKEN_TYPE_INTEGER = 1
TOKEN_TYPE_FRACTION = 2
TOKEN_TYPE_SPECIAL = 3   # PAD/BOS/UNK/FRAC_UNK/ISO_UNK/isotopes
TOKEN_TYPE_EOS = 4
N_TOKEN_TYPES = 5

# formula scanner: isotopes first ({mass}El), then (p/q), then El, then int
_SCAN = re.compile(
    r'\{(?P<mass>\d+)\}(?P<iso_el>[A-Z][a-z]?)'
    r'|\((?P<num>\d+)/(?P<den>\d+)\)'
    r'|(?P<el>[A-Z][a-z]?)'
    r'|(?P<int>\d+)'
)

_DATA_DIR = Path(__file__).resolve().parents[2] / 'data'


class FractionAwareTokenizer:
    """Semantic formula tokenizer with dense-LUT exports for device code."""

    def __init__(
        self,
        fractions: Optional[Sequence[str]] = None,
        isotopes: Optional[Sequence[str]] = None,
        max_len: int = 60,
    ):
        self.max_len = max_len
        self.fractions: List[str] = list(fractions) if fractions is not None else []
        self.isotopes: List[str] = list(isotopes) if isotopes is not None else []

        self._frac_to_id: Dict[str, int] = {
            f: FRACTION_TOKEN_START + i for i, f in enumerate(self.fractions)
        }
        self.iso_unk_id: Optional[int] = None
        self._iso_to_id: Dict[str, int] = {}
        if self.isotopes:
            self.iso_unk_id = FRACTION_TOKEN_START + len(self.fractions)
            self.isotope_token_start = self.iso_unk_id + 1
            self._iso_to_id = {
                s: self.isotope_token_start + i for i, s in enumerate(self.isotopes)
            }
        else:
            self.isotope_token_start = None

        self._elem_to_id = {
            sym: ELEMENT_TOKEN_START + i
            for i, sym in enumerate(ELEMENT_SYMBOLS[1:])
        }
        self._build_luts()

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_vocab_files(
        cls,
        fraction_vocab_path: str | Path | None = None,
        isotope_vocab_path: str | Path | None = None,
        max_len: int = 60,
    ) -> 'FractionAwareTokenizer':
        frac_path = Path(fraction_vocab_path or _DATA_DIR / 'fraction_vocab.json')
        iso_path = Path(isotope_vocab_path or _DATA_DIR / 'isotope_vocab.json')
        fractions = json.loads(frac_path.read_text())['fractions']
        isotopes = (
            json.loads(iso_path.read_text())['isotopes'] if iso_path.exists() else []
        )
        return cls(fractions=fractions, isotopes=isotopes, max_len=max_len)

    def save(self, path: str | Path) -> None:
        state = {
            'version': 'V14.0' if self.isotopes else 'V13.0',
            'max_len': self.max_len,
            'fractions': self.fractions,
            'isotopes': self.isotopes,
        }
        Path(path).write_text(json.dumps(state))

    @classmethod
    def load(cls, path: str | Path) -> 'FractionAwareTokenizer':
        state = json.loads(Path(path).read_text())
        return cls(
            fractions=state['fractions'],
            isotopes=state.get('isotopes', []),
            max_len=state['max_len'],
        )

    # -- vocab structure -----------------------------------------------------
    @property
    def vocab_size(self) -> int:
        v = FRACTION_TOKEN_START + len(self.fractions)
        if self.isotopes:
            v += 1 + len(self.isotopes)  # ISO_UNK + isotopes
        return v

    @property
    def n_fraction_tokens(self) -> int:
        return len(self.fractions)

    @property
    def fraction_token_start(self) -> int:
        return FRACTION_TOKEN_START

    @property
    def n_isotope_tokens(self) -> int:
        return len(self.isotopes)

    def is_element_token(self, tid: int) -> bool:
        return ELEMENT_TOKEN_START <= tid < INTEGER_TOKEN_START

    def is_integer_token(self, tid: int) -> bool:
        return INTEGER_TOKEN_START <= tid < FRACTION_TOKEN_START

    def is_fraction_token(self, tid: int) -> bool:
        return FRACTION_TOKEN_START <= tid < FRACTION_TOKEN_START + len(self.fractions)

    def is_isotope_token(self, tid: int) -> bool:
        return bool(self.isotopes) and self.isotope_token_start <= tid < self.vocab_size

    # -- dense LUTs ----------------------------------------------------------
    def _build_luts(self) -> None:
        v = self.vocab_size
        types = np.full(v, TOKEN_TYPE_SPECIAL, dtype=np.int32)
        types[ELEMENT_TOKEN_START:INTEGER_TOKEN_START] = TOKEN_TYPE_ELEMENT
        types[INTEGER_TOKEN_START:FRACTION_TOKEN_START] = TOKEN_TYPE_INTEGER
        types[FRACTION_TOKEN_START:FRACTION_TOKEN_START + len(self.fractions)] = (
            TOKEN_TYPE_FRACTION
        )
        types[EOS_ID] = TOKEN_TYPE_EOS
        self.token_type_table = types

        masks = np.zeros((N_TOKEN_TYPES, v), dtype=bool)
        masks[types, np.arange(v)] = True
        self.type_masks = masks

        frac_vals = np.zeros(v, dtype=np.float32)
        for f, tid in self._frac_to_id.items():
            p, q = f.split('/')
            frac_vals[tid] = int(p) / int(q)
        self.fraction_value_table = frac_vals

        # token -> quantity value: integers carry their value, fractions their
        # float value (used for on-device stoichiometry reconstruction).
        qty = frac_vals.copy()
        for val in range(1, MAX_INTEGER + 1):
            qty[INTEGER_TOKEN_START + val - 1] = float(val)
        self.token_value_table = qty

        # token -> element Z (0 for non-element tokens; isotopes map to parent)
        to_z = np.zeros(v, dtype=np.int32)
        to_z[ELEMENT_TOKEN_START:INTEGER_TOKEN_START] = np.arange(
            1, N_ELEMENTS + 1, dtype=np.int32
        )
        for iso, tid in self._iso_to_id.items():
            sym = re.match(r'^\d+([A-Z][a-z]?)$', iso).group(1)
            to_z[tid] = ELEMENT_SYMBOLS.index(sym)
        self.token_to_element_z = to_z

    # -- encode / decode -----------------------------------------------------
    def token_id(self, tok: str) -> int:
        if tok in self._elem_to_id:
            return self._elem_to_id[tok]
        if tok in self._frac_to_id:
            return self._frac_to_id[tok]
        if tok in self._iso_to_id:
            return self._iso_to_id[tok]
        if tok.isdigit() and 1 <= int(tok) <= MAX_INTEGER:
            return INTEGER_TOKEN_START + int(tok) - 1
        return UNK_ID

    def encode(self, formula: str, add_bos_eos: bool = True, pad: bool = True) -> List[int]:
        """Formula string -> token IDs with GCD canonicalization of fractions.

        Matches the reference encode semantics (fraction_tokenizer.py:380-476):
        fractions are GCD-reduced before lookup; integers > 20 become UNK;
        unknown fractions become FRAC_UNK; unknown isotopes become ISO_UNK.
        """
        ids: List[int] = []
        for m in _SCAN.finditer(formula):
            if m.group('mass') is not None:
                iso = f"{m.group('mass')}{m.group('iso_el')}"
                if iso in self._iso_to_id:
                    ids.append(self._iso_to_id[iso])
                elif self.iso_unk_id is not None:
                    ids.append(self.iso_unk_id)
                else:
                    ids.append(UNK_ID)
            elif m.group('num') is not None:
                p, q = int(m.group('num')), int(m.group('den'))
                g = math.gcd(p, q) or 1
                frac = f'{p // g}/{q // g}'
                ids.append(self._frac_to_id.get(frac, FRAC_UNK_ID))
            elif m.group('el') is not None:
                ids.append(self._elem_to_id.get(m.group('el'), UNK_ID))
            else:
                val = int(m.group('int'))
                if 1 <= val <= MAX_INTEGER:
                    ids.append(INTEGER_TOKEN_START + val - 1)
                else:
                    ids.append(UNK_ID)

        if add_bos_eos:
            ids = [BOS_ID] + ids + [EOS_ID]
        if pad:
            if len(ids) < self.max_len:
                ids = ids + [PAD_ID] * (self.max_len - len(ids))
            elif len(ids) > self.max_len:
                ids = ids[: self.max_len - 1] + [EOS_ID]
        return ids

    def encode_batch(self, formulas: Sequence[str]) -> np.ndarray:
        """Vectorized-output batch encode -> ``[B, max_len]`` int32 array."""
        out = np.zeros((len(formulas), self.max_len), dtype=np.int32)
        for i, f in enumerate(formulas):
            out[i] = self.encode(f)
        return out

    def decode(self, token_ids: Sequence[int], strip_special: bool = True) -> str:
        parts: List[str] = []
        n_frac = len(self.fractions)
        for tid in map(int, token_ids):
            if strip_special and tid in (PAD_ID, BOS_ID, EOS_ID):
                if tid == EOS_ID:
                    break
                continue
            if tid == UNK_ID:
                parts.append('?')
            elif tid == FRAC_UNK_ID:
                parts.append('(?/?)')
            elif self.iso_unk_id is not None and tid == self.iso_unk_id:
                parts.append('{?}?')
            elif self.is_element_token(tid):
                parts.append(ELEMENT_SYMBOLS[tid - ELEMENT_TOKEN_START + 1])
            elif self.is_integer_token(tid):
                parts.append(str(tid - INTEGER_TOKEN_START + 1))
            elif self.is_fraction_token(tid):
                parts.append(f'({self.fractions[tid - FRACTION_TOKEN_START]})')
            elif self.is_isotope_token(tid):
                iso = self.isotopes[tid - self.isotope_token_start]
                m = re.match(r'^(\d+)([A-Z][a-z]?)$', iso)
                parts.append(f'{{{m.group(1)}}}{m.group(2)}' if m else f'{{{iso}}}')
            elif not strip_special and tid in (PAD_ID, BOS_ID, EOS_ID):
                parts.append({PAD_ID: PAD_TOKEN, BOS_ID: BOS_TOKEN, EOS_ID: EOS_TOKEN}[tid])
            else:
                parts.append('?')
        return ''.join(parts)

    def token_name(self, tid: int) -> str:
        if tid < N_SPECIAL:
            return (PAD_TOKEN, BOS_TOKEN, EOS_TOKEN, UNK_TOKEN, FRAC_UNK_TOKEN)[tid]
        if self.is_element_token(tid):
            return ELEMENT_SYMBOLS[tid - ELEMENT_TOKEN_START + 1]
        if self.is_integer_token(tid):
            return str(tid - INTEGER_TOKEN_START + 1)
        if self.is_fraction_token(tid):
            return f'FRAC:{self.fractions[tid - FRACTION_TOKEN_START]}'
        if self.iso_unk_id is not None and tid == self.iso_unk_id:
            return ISO_UNK_TOKEN
        if self.is_isotope_token(tid):
            return f'ISO:{self.isotopes[tid - self.isotope_token_start]}'
        return f'<ID:{tid}>'

    def token_type_targets(self, token_ids: np.ndarray) -> np.ndarray:
        """Token IDs -> type class IDs via dense LUT (host-side numpy)."""
        clamped = np.clip(token_ids, 0, self.vocab_size - 1)
        return self.token_type_table[clamped]

    def fraction_token_to_value(self, tid: int) -> float:
        if not self.is_fraction_token(tid):
            raise ValueError(f'token {tid} is not a fraction token')
        return float(self.fraction_value_table[tid])

    def __repr__(self) -> str:
        return (
            f'FractionAwareTokenizer(vocab_size={self.vocab_size}, '
            f'n_fractions={self.n_fraction_tokens}, '
            f'n_isotopes={self.n_isotope_tokens}, max_len={self.max_len})'
        )


def default_tokenizer(max_len: int = 60) -> FractionAwareTokenizer:
    """Tokenizer built from the shipped vocab files."""
    return FractionAwareTokenizer.from_vocab_files(max_len=max_len)
