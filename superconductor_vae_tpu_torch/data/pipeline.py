"""Data pipeline: CSV -> fixed-shape numpy arrays (port of
data/pipeline.py).

``load_dataset`` builds the arrays the JAX package's ``load_dataset``
builds, bit for bit: tokenized formulas, element slots, Tc (log1p, then
z-scored over the superconductors), Magpie features (NaN -> column mean,
|skew| > threshold columns gaussianized, z-scored over the
superconductors), contrastive and family labels, compositional targets,
generative-holdout exclusion and the UNK filter.  It reads the CSV with the
standard library alone (``read_csv_rows``), since the card's machine has no
pandas, and re-creates the parts of ``pandas.read_csv`` the JAX loader
relies on.  It keeps no npz cache.  Order augmentation
(``order_augment``, ``resample_order_augmentation``) appends element-order
respellings as rows, with ``DatasetArrays.aug_group`` mapping each row to
its source; ``compute_sample_weights`` gives the weighted sampler's
weights.  The Magpie bridge (A.16) is not ported yet.
"""

from __future__ import annotations

import csv
import dataclasses
import gzip
import itertools
import json
import math
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..chem.elements import SYMBOL_TO_Z
from ..models.family_classifier import SuperconductorFamily, classify_batch
from ..tokenizer import (FRAC_UNK_ID, UNK_ID, FractionAwareTokenizer,
                         default_tokenizer)
from .canonical_ordering import OrderAugmentation, join_ordered, parse_ordered
from .compositional_targets import normalized_compositional_targets

MAX_ELEMENTS = 12

# Contrastive category labels
SC_CATEGORY_LABELS = {
    'Cuprates': 0, 'Iron-based': 1, 'Bismuthates': 2, 'Borocarbides': 3,
    'Elemental Superconductors': 4, 'Hydrogen-rich Superconductors': 5,
    'Organic Superconductors': 6, 'Other': 7,
    'Non-SC: Materials Project': 8, 'Non-SC: Magnetic': 9,
    'Non-SC: Thermoelectric': 10, 'Non-SC: Anisotropy': 11,
    'High-pressure (non-hydride)': 12,
}

# columns that are not Magpie features even where they are numeric; every
# non-numeric column (e.g. ``source``) is left out too
NON_FEATURE_COLUMNS = frozenset({
    'formula', 'Tc', 'composition', 'category', 'is_superconductor',
    'compound possible', 'formula_original', 'requires_high_pressure'})

# the cells pandas.read_csv reads as missing by default (its na_values)
_NA_CELLS = frozenset({
    '', '#N/A', '#N/A N/A', '#NA', '-1.#IND', '-1.#QNAN', '-NaN', '-nan',
    '1.#IND', '1.#QNAN', '<NA>', 'N/A', 'NA', 'NULL', 'NaN', 'None', 'n/a',
    'nan', 'null'})


def category_to_label(category: str, use_extended: bool = True,
                      requires_high_pressure: int = 0) -> int:
    """A CSV ``category`` as its contrastive label: high-pressure SC rows
    (other than hydrides) get their own label, unknown non-SC categories
    the last label, other unknown categories 'Other'."""
    if not use_extended:
        return 1 if str(category).startswith('Non-SC') else 0
    category = str(category)
    if (requires_high_pressure == 1
            and category != 'Hydrogen-rich Superconductors'
            and not category.startswith('Non-SC')):
        return SC_CATEGORY_LABELS['High-pressure (non-hydride)']
    if category in SC_CATEGORY_LABELS:
        return SC_CATEGORY_LABELS[category]
    if category.startswith('Non-SC'):
        return max(SC_CATEGORY_LABELS.values())
    return SC_CATEGORY_LABELS['Other']


_COMP_SCAN = re.compile(
    r'(?:\{(?P<mass>\d+)\})?(?P<el>[A-Z][a-z]?)'
    r'(?:\((?P<num>\d+)/(?P<den>\d+)\)|(?P<dec>\d*\.\d+)|(?P<int>\d+))?'
)


def parse_formula_composition(formula: str) -> Dict[str, float]:
    """Formula string -> {element: amount}. Isotopes fold into parent element.

    Amounts repeated for the same element accumulate (crystallographic sites).
    """
    comp: Dict[str, float] = {}
    for m in _COMP_SCAN.finditer(formula):
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
            qty = float(int(m.group('int')))
        comp[el] = comp.get(el, 0.0) + qty
    return comp


def composition_slots(formulas: Sequence[str]):
    """Formulas -> (element_indices int32, element_fractions float32,
    element_mask bool), each [N, 12]: atomic numbers in order of first
    appearance, molar fractions, and the occupied slots."""
    n = len(formulas)
    idx = np.zeros((n, MAX_ELEMENTS), np.int32)
    frac = np.zeros((n, MAX_ELEMENTS), np.float32)
    mask = np.zeros((n, MAX_ELEMENTS), bool)
    for i, f in enumerate(formulas):
        comp = parse_formula_composition(f)
        total = sum(comp.values()) or 1.0
        for j, (el, amt) in enumerate(list(comp.items())[:MAX_ELEMENTS]):
            idx[i, j] = SYMBOL_TO_Z[el]
            frac[i, j] = amt / total
            mask[i, j] = True
    return idx, frac, mask




def _column(cells: Sequence[str]) -> np.ndarray:
    """One CSV column as pandas reads it: float64 when every cell that is
    not missing parses as a number (missing = NaN), else an object array
    of the strings with NaN for the missing cells."""
    missing = [c in _NA_CELLS for c in cells]
    try:
        return np.array([math.nan if m else float(c) for c, m in zip(cells, missing)],
                        np.float64)
    except ValueError:
        col = np.empty(len(cells), object)
        col[:] = [math.nan if m else c for c, m in zip(cells, missing)]
        return col


def _cut_comment(line: str, comment: str) -> str:
    """``line`` cut at its first ``comment`` character, its line end kept."""
    cut = line.find(comment)
    return line if cut < 0 else line[:cut] + line[len(line.rstrip('\r\n')):]


def _read_csv_columns(path: str | Path, n_rows: Optional[int] = None, sep: str = ',',
                      skiprows: int = 0, header: bool = True, comment: Optional[str] = None,
                      bad_lines: str = 'raise', typed: bool = True) -> Dict[str, np.ndarray]:
    """The columns of a CSV (``.csv`` or ``.csv.gz``), in file order, as
    ``pandas.read_csv`` gives them with its defaults: each float64 if
    numeric (``_column``), else object; blank lines skipped, short rows
    padded with missing cells.  Only the first ``n_rows`` rows if given.

    The rest are ``read_csv``'s options of the same meaning: ``sep``;
    ``skiprows`` lines skipped before the header; ``header=False``
    (``header=None``) names the columns 0, 1, ... after the first row's
    width; ``comment`` cuts each line at that character, a line left empty
    being skipped; ``bad_lines='skip'`` (``on_bad_lines='skip'``) drops a
    row with more fields than the header, where the default raises;
    ``typed=False`` (``dtype=str``) keeps every column as strings, missing
    cells NaN."""
    path = Path(path)
    opener = gzip.open if path.suffix == '.gz' else open
    with opener(path, 'rt', newline='') as fh:
        # the csv module reads the file's lines as they are (a quoted field
        # may span lines); a comment is cut from each line, its end kept
        lines = itertools.islice(fh, skiprows, None)
        if comment is not None:
            lines = (_cut_comment(ln, comment) for ln in lines)
        reader = csv.reader(lines, delimiter=sep)
        first = next((row for row in reader if row), [])
        names = first if header else list(range(len(first)))
        rows = [] if header else [first]
        for row in reader:
            if n_rows is not None and len(rows) == n_rows:
                break
            if not row:
                continue
            if len(row) > len(names):
                if bad_lines == 'skip':
                    continue
                raise ValueError(f'{path}: line {skiprows + reader.line_num} has {len(row)} '
                                 f'fields, the header {len(names)}')
            rows.append(row + [''] * (len(names) - len(row)))
    if len(set(names)) != len(names):
        raise ValueError(f'{path}: duplicate column names in {names}')
    cols = list(zip(*rows)) if rows else [()] * len(names)
    if typed:
        return {name: _column(cells) for name, cells in zip(names, cols)}
    out = {}
    for name, cells in zip(names, cols):
        col = np.empty(len(cells), object)
        col[:] = [math.nan if c in _NA_CELLS else c for c in cells]
        out[name] = col
    return out


def read_csv_rows(path: str | Path, n_rows: Optional[int] = None) -> Dict[str, object]:
    """What the JAX ``load_dataset`` takes from a corpus CSV with pandas,
    from its first ``n_rows`` rows (all if None), read with the standard
    library alone.

    Returns ``formula`` (list of str), ``tc`` (float64 [N], Kelvin, missing
    = 0), ``is_sc`` (int32 [N], all 1 without the column), ``hp`` (float32
    [N], ``requires_high_pressure``, missing = NaN, all 0 without the
    column), ``category`` (the column, or None without it), ``magpie``
    (float32 [N, F]: every numeric column outside ``NON_FEATURE_COLUMNS``,
    in file order, missing = NaN) and ``magpie_columns``."""
    cols = _read_csv_columns(path, n_rows)
    n = len(cols['formula'])
    feats = [name for name, col in cols.items()
             if col.dtype == np.float64 and name not in NON_FEATURE_COLUMNS]
    tc = cols['Tc'].astype(np.float64)
    return {
        'formula': [str(f) for f in cols['formula']],
        'tc': np.where(np.isnan(tc), 0.0, tc),
        'is_sc': (cols['is_superconductor'].astype(np.int32)
                  if 'is_superconductor' in cols else np.ones(n, np.int32)),
        'hp': (cols['requires_high_pressure'].astype(np.float32)
               if 'requires_high_pressure' in cols else np.zeros(n, np.float32)),
        'category': cols.get('category'),
        'magpie': (np.stack([cols[c] for c in feats], axis=1) if feats
                   else np.zeros((n, 0))).astype(np.float32),
        'magpie_columns': feats,
    }


@dataclasses.dataclass
class NormStats:
    tc_mean: float
    tc_std: float
    tc_log_transform: bool
    magpie_mean: np.ndarray
    magpie_std: np.ndarray
    magpie_skewed_indices: List[int]
    magpie_sc_only_norm: bool
    comp_target_stats: Optional[dict] = None
    # persisted quantile grids for the skewed columns (aligned with
    # magpie_skewed_indices); None => legacy rank-gauss, whose mapping
    # exists only for corpus rows (see normalize_fresh_magpie)
    magpie_quantile_grids: Optional[List[np.ndarray]] = None

    def tc_to_kelvin(self, tc_norm: np.ndarray) -> np.ndarray:
        x = tc_norm * self.tc_std + self.tc_mean
        if self.tc_log_transform:
            x = np.expm1(x)
        return np.clip(x, 0.0, None)

    def kelvin_to_norm(self, tc_k: np.ndarray) -> np.ndarray:
        x = np.log1p(tc_k) if self.tc_log_transform else np.asarray(tc_k, np.float64)
        return ((x - self.tc_mean) / self.tc_std).astype(np.float32)

    def normalize_fresh_magpie(self, raw: np.ndarray) -> Tuple[np.ndarray,
                                                               np.ndarray]:
        """Normalize a fresh formula's raw Magpie vector as the corpus was:
        quantile-gaussianize the skewed columns against the persisted
        grids, then z-score.  Returns ``(normalized, valid_mask)``; under
        legacy rank-gauss stats (no grids) the skewed columns are set to 0
        (the corpus mean in z-scored units) and masked out."""
        raw = np.asarray(raw, np.float64).copy()
        if raw.shape[-1] != np.asarray(self.magpie_mean).shape[0]:
            raise ValueError(
                f'raw feature dim {raw.shape[-1]} != corpus magpie dim '
                f'{np.asarray(self.magpie_mean).shape[0]} — the fresh '
                'vector must be in the corpus column layout (use the '
                'magpie bridge for reference-layout corpora)')
        valid = np.ones(raw.shape[-1], np.float32)
        if self.magpie_quantile_grids is not None:
            for i, grid in zip(self.magpie_skewed_indices,
                               self.magpie_quantile_grids):
                raw[..., i] = quantile_gaussianize(raw[..., i],
                                                   np.asarray(grid))
        elif self.magpie_skewed_indices:
            for i in self.magpie_skewed_indices:
                raw[..., i] = np.asarray(self.magpie_mean)[i]
                valid[i] = 0.0
        out = ((raw - np.asarray(self.magpie_mean))
               / np.asarray(self.magpie_std)).astype(np.float32)
        return out, valid

    def to_json(self) -> dict:
        return {
            'tc_mean': self.tc_mean, 'tc_std': self.tc_std,
            'tc_log_transform': self.tc_log_transform,
            'magpie_mean': np.asarray(self.magpie_mean).tolist(),
            'magpie_std': np.asarray(self.magpie_std).tolist(),
            'magpie_skewed_indices': list(self.magpie_skewed_indices),
            'magpie_sc_only_norm': self.magpie_sc_only_norm,
            'comp_target_stats': self.comp_target_stats,
            'magpie_quantile_grids': (
                [np.asarray(g).tolist() for g in self.magpie_quantile_grids]
                if self.magpie_quantile_grids is not None else None),
        }


@dataclasses.dataclass
class DatasetArrays:
    """Fixed-shape host arrays for the whole dataset.  ``aug_group`` holds
    each row's source row (rows added by order augmentation share their
    source's index); None without augmentation."""
    formulas: List[str]
    tokens: np.ndarray            # [N, max_len] int32
    element_indices: np.ndarray   # [N, 12] int32
    element_fractions: np.ndarray  # [N, 12] float32 (normalized to sum 1)
    element_mask: np.ndarray      # [N, 12] bool
    tc: np.ndarray                # [N] float32 normalized
    magpie: np.ndarray            # [N, M] float32 normalized
    is_sc: np.ndarray             # [N] int32
    label: np.ndarray             # [N] int32 contrastive label
    hp: np.ndarray                # [N] float32
    family: np.ndarray            # [N] int32 14-class
    comp_targets: np.ndarray      # [N, 15] float32 normalized
    norm_stats: NormStats
    aug_group: Optional[np.ndarray] = None   # [N] int32

    def __len__(self):
        return len(self.tokens)

    @property
    def magpie_dim(self) -> int:
        return self.magpie.shape[1]

    def subset(self, idx: np.ndarray) -> 'DatasetArrays':
        """The rows ``idx`` (copies), for random or stratified eval slices."""
        idx = np.asarray(idx)
        return dataclasses.replace(
            self, formulas=[self.formulas[i] for i in idx], **self.batch(idx),
            aug_group=self.aug_group[idx] if self.aug_group is not None else None)

    def sample_indices(self, n: int, seed: int = 0,
                       stratify_sc: bool = False) -> np.ndarray:
        """Seeded random (optionally is_sc-stratified 50/50) row sample."""
        rng = np.random.default_rng(seed)
        n = min(n, len(self))
        if not stratify_sc:
            return np.sort(rng.choice(len(self), size=n, replace=False))
        pos = np.flatnonzero(self.is_sc == 1)
        neg = np.flatnonzero(self.is_sc != 1)
        n_pos = min(n // 2, len(pos))
        n_neg = min(n - n_pos, len(neg))
        # top up from the larger class if one side is short
        if n_pos + n_neg < n:
            n_pos = min(n - n_neg, len(pos))
        take = np.concatenate([
            rng.choice(pos, size=n_pos, replace=False),
            rng.choice(neg, size=n_neg, replace=False)])
        return np.sort(take)

    def batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        return {
            'tokens': self.tokens[idx],
            'element_indices': self.element_indices[idx],
            'element_fractions': self.element_fractions[idx],
            'element_mask': self.element_mask[idx],
            'tc': self.tc[idx],
            'magpie': self.magpie[idx],
            'is_sc': self.is_sc[idx],
            'label': self.label[idx],
            'hp': self.hp[idx],
            'family': self.family[idx],
            'comp_targets': self.comp_targets[idx],
        }


def _rank_gaussian(col: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Rank -> uniform -> inverse-normal transform (legacy rank-gauss).  The
    per-row jitter breaks ties randomly, so the mapping exists only for
    corpus rows."""
    from scipy.special import ndtri
    jittered = col + rng.normal(0, 1e-6, len(col)).astype(np.float32)
    order = np.argsort(jittered, kind='stable')
    ranks = np.empty(len(col), dtype=np.float64)
    ranks[order] = np.arange(1, len(col) + 1)
    uniform = (ranks - 0.5) / len(col)
    return ndtri(uniform).astype(np.float32)


def build_quantile_grid(col: np.ndarray, n_points: int = 1024) -> np.ndarray:
    """Sorted value grid at uniformly spaced quantiles of a corpus column:
    the persisted, fresh-formula-applicable form of the skew transform."""
    qs = np.linspace(0.0, 1.0, min(n_points, len(col)))
    return np.quantile(np.asarray(col, np.float64), qs)


def quantile_gaussianize(x: np.ndarray, grid: np.ndarray) -> np.ndarray:
    """Map values through a persisted empirical CDF to N(0,1); tied blocks
    map to their mid-rank, so corpus rows and fresh formulas transform
    alike."""
    from scipy.special import ndtri
    x = np.asarray(x, np.float64)
    n = len(grid)
    lo = np.searchsorted(grid, x, side='left')
    hi = np.searchsorted(grid, x, side='right')
    u = (lo + hi) / 2.0 / n
    u = np.clip(u, 0.5 / n, 1.0 - 0.5 / n)
    return ndtri(u).astype(np.float32)


def load_holdout_formulas(path: Optional[Path] = None) -> List[str]:
    """The generative holdout's formulas (the repo's
    ``data/GENERATIVE_HOLDOUT_DO_NOT_TRAIN.json`` by default; [] if absent)."""
    path = Path(path or Path(__file__).resolve().parents[2]
                / 'data' / 'GENERATIVE_HOLDOUT_DO_NOT_TRAIN.json')
    if not path.exists():
        return []
    blob = json.loads(path.read_text())
    return [s['formula'] for s in blob.get('holdout_samples', [])]


def canonical_composition_key(formula: str) -> Optional[Tuple]:
    """Spelling-independent composition identity: normalized element
    fractions rounded to 1e-6 (None for a formula without elements), so
    that holdout exclusion also catches respellings."""
    comp = parse_formula_composition(formula)
    if not comp:
        return None
    tot = sum(comp.values())
    if tot <= 0:
        return None
    return tuple(sorted((el, round(amt / tot, 6)) for el, amt in comp.items()))


def load_dataset(
    csv_path: str | Path,
    max_len: int = 30,
    tokenizer: Optional[FractionAwareTokenizer] = None,
    skew_threshold: float = 3.0,
    sc_only_norm: bool = True,
    tc_log_transform: bool = True,
    exclude_holdout: bool = True,
    limit: Optional[int] = None,
    drop_unk: bool = True,
    magpie_bridge: Optional[str | Path] = None,
    skew_transform: str = 'quantile',
    order_augment: int = 0,
    order_augment_seed: int = 0,
    native: bool = True,
) -> DatasetArrays:
    """CSV -> DatasetArrays, as the JAX ``load_dataset`` with
    ``cache_dir=None``.

    ``limit`` keeps the first rows after normalization, so a limited load
    sees the full corpus's statistics.  ``exclude_holdout`` drops the
    generative holdout's formulas by string and by composition;
    ``drop_unk`` drops rows whose tokens hold UNK or FRAC_UNK.
    ``skew_transform``: 'quantile' gaussianizes the |skew| > threshold
    columns through persisted quantile grids; 'rank_gauss' is the legacy
    jittered transform (run3's and run4's checkpoints), drawn from
    ``default_rng(42)`` one column after another.  ``order_augment=K``
    appends up to K random element-order respellings of every
    multi-element row, drawn from ``order_augment_seed``.
    ``magpie_bridge`` (an npz of chem/featurize.py ``fit_magpie_bridge``)
    maps the CSV's Magpie columns into the reference's layout before the
    skew transform.  ``native`` tokenizes and parses the formulas with the
    C++ library (native/, built on first use; a failed build raises), as
    the JAX loader does; ``native=False`` runs the pure-Python tokenizer
    and parser, which give the same arrays."""
    tokenizer = tokenizer or default_tokenizer(max_len=max_len)
    rows = read_csv_rows(csv_path)
    formulas, tc_raw, is_sc, hp = rows['formula'], rows['tc'], rows['is_sc'], rows['hp']
    if rows['category'] is not None:
        label = np.array([
            category_to_label(c, requires_high_pressure=int(h))
            for c, h in zip(rows['category'], hp)], dtype=np.int32)
    else:
        label = np.zeros(len(formulas), np.int32)

    # Tc normalization: log1p + SC-only z-score
    sc_mask = is_sc == 1
    tc_t = np.log1p(tc_raw) if tc_log_transform else tc_raw
    ref = tc_t[sc_mask] if sc_mask.any() else tc_t
    tc_mean, tc_std = float(ref.mean()), float(ref.std() + 1e-8)
    tc = ((tc_t - tc_mean) / tc_std).astype(np.float32)

    magpie = rows['magpie']
    nan_mask = np.isnan(magpie)
    if nan_mask.any():
        with np.errstate(invalid='ignore'):
            col_means = np.nan_to_num(np.nanmean(magpie, axis=0))
        magpie = np.where(nan_mask, col_means[None, :], magpie)

    if magpie_bridge is not None:
        from ..chem.featurize import apply_magpie_bridge, load_magpie_bridge
        magpie = apply_magpie_bridge(magpie, load_magpie_bridge(magpie_bridge))

    skewed_idx: List[int] = []
    quantile_grids: Optional[List[np.ndarray]] = None
    if skew_threshold > 0:
        from scipy.stats import skew
        rng = np.random.default_rng(42)
        sk = skew(magpie, axis=0)
        skewed_idx = np.where(np.abs(np.nan_to_num(sk)) > skew_threshold)[0].tolist()
        if skew_transform == 'quantile':
            quantile_grids = []
            for i in skewed_idx:
                grid = build_quantile_grid(magpie[:, i])
                quantile_grids.append(grid)
                magpie[:, i] = quantile_gaussianize(magpie[:, i], grid)
        else:
            for i in skewed_idx:
                magpie[:, i] = _rank_gaussian(magpie[:, i], rng)

    stats_rows = sc_mask if (sc_only_norm and sc_mask.any()) else np.ones(len(formulas), bool)
    mg_mean = magpie[stats_rows].mean(axis=0)
    mg_std = magpie[stats_rows].std(axis=0) + 1e-8
    magpie = (magpie - mg_mean) / mg_std

    if limit:
        formulas = formulas[:limit]
        tc, is_sc = tc[:limit], is_sc[:limit]
        hp, label, magpie = hp[:limit], label[:limit], magpie[:limit]

    if native:
        from .. import native as _native
        tokens = _native.tokenize_batch(formulas, tokenizer)
        elem_idx, elem_frac, elem_mask = _native.parse_compositions(
            formulas, tokenizer, MAX_ELEMENTS)
    else:
        tokens = tokenizer.encode_batch(formulas)
        elem_idx, elem_frac, elem_mask = composition_slots(formulas)
    family = np.where(
        is_sc == 1, classify_batch(elem_idx, elem_mask),
        int(SuperconductorFamily.NOT_SUPERCONDUCTOR)).astype(np.int32)
    comp_targets, comp_stats = normalized_compositional_targets(
        elem_idx, elem_frac, elem_mask)

    keep = np.ones(len(formulas), bool)
    if exclude_holdout:
        holdout = set(load_holdout_formulas())
        if holdout:
            hold_keys = {canonical_composition_key(f) for f in holdout}
            hold_keys.discard(None)
            keep = np.array([
                f not in holdout and canonical_composition_key(f) not in hold_keys
                for f in formulas], bool)
    if drop_unk:
        keep &= ~((tokens == UNK_ID) | (tokens == FRAC_UNK_ID)).any(axis=1)

    norm_stats = NormStats(
        tc_mean=tc_mean, tc_std=tc_std, tc_log_transform=tc_log_transform,
        magpie_mean=mg_mean, magpie_std=mg_std,
        magpie_skewed_indices=skewed_idx, magpie_sc_only_norm=sc_only_norm,
        comp_target_stats=comp_stats, magpie_quantile_grids=quantile_grids)
    ds = DatasetArrays(
        formulas=[f for f, k in zip(formulas, keep) if k],
        tokens=tokens[keep].astype(np.int32),
        element_indices=elem_idx[keep],
        element_fractions=elem_frac[keep],
        element_mask=elem_mask[keep],
        tc=tc[keep], magpie=magpie[keep].astype(np.float32),
        is_sc=is_sc[keep], label=label[keep], hp=hp[keep],
        family=family[keep], comp_targets=comp_targets[keep],
        norm_stats=norm_stats)
    if order_augment > 0:
        ds = _apply_order_augmentation(ds, tokenizer, order_augment, order_augment_seed,
                                       native=native)
    return ds


def _build_aug_rows(spellings: List[str], tokenizer: FractionAwareTokenizer,
                    native: bool = True):
    """Tokenize respellings (with the native tokenizer unless ``native``
    is False) and build their appearance-order element slots.  Returns
    (tokens [n, max_len], idx, frac, mask [n, 12], ok [n]) where ``ok``
    marks respellings that round-tripped through the tokenizer."""
    if native:
        from .. import native as _native
        toks = _native.tokenize_batch(spellings, tokenizer)
    else:
        toks = tokenizer.encode_batch(spellings).astype(np.int32)
    n = len(spellings)
    a_idx = np.zeros((n, MAX_ELEMENTS), np.int32)
    a_frac = np.zeros((n, MAX_ELEMENTS), np.float32)
    a_mask = np.zeros((n, MAX_ELEMENTS), bool)
    ok = np.ones(n, bool)
    for j, f in enumerate(spellings):
        comp = parse_formula_composition(f)       # appearance order, sites summed
        if not comp or len(comp) > MAX_ELEMENTS:
            ok[j] = False
            continue
        total = sum(comp.values()) or 1.0
        for s, (el, qty) in enumerate(comp.items()):
            a_idx[j, s] = SYMBOL_TO_Z[el]
            a_frac[j, s] = qty / total
            a_mask[j, s] = True
        # a respelling is the original's tokens reordered, so it fits
        # max_len iff the original did; UNK appears only if it failed to
        # round-trip through the tokenizer
        if ((toks[j] == UNK_ID) | (toks[j] == FRAC_UNK_ID)).any():
            ok[j] = False
    return toks, a_idx, a_frac, a_mask, ok


def resample_order_augmentation(ds: DatasetArrays, tokenizer: FractionAwareTokenizer,
                                seed: int, native: bool = True) -> DatasetArrays:
    """Redraws the element-order respelling of every augmented row (same
    row count, same source rows, fresh permutations from ``seed``).  A
    row whose fresh respelling fails to round-trip keeps its previous
    one; source rows are untouched."""
    if ds.aug_group is None:
        return ds
    aug_rows = np.where(ds.aug_group != np.arange(len(ds)))[0]
    if len(aug_rows) == 0:
        return ds
    rng = np.random.default_rng(seed)
    spellings = []
    for r in aug_rows:
        src_f = ds.formulas[ds.aug_group[r]]
        parts = parse_ordered(src_f)
        if len(parts) > 1:
            order = rng.permutation(len(parts))
            spellings.append(join_ordered([parts[i] for i in order]))
        else:
            spellings.append(src_f)
    toks, a_idx, a_frac, a_mask, ok = _build_aug_rows(spellings, tokenizer, native)
    tokens = ds.tokens.copy()
    e_idx = ds.element_indices.copy()
    e_frac = ds.element_fractions.copy()
    e_mask = ds.element_mask.copy()
    upd = aug_rows[ok]
    formulas = np.array(ds.formulas, dtype=object)
    formulas[upd] = np.array(spellings, dtype=object)[ok]
    tokens[upd] = toks[ok]
    e_idx[upd] = a_idx[ok]
    e_frac[upd] = a_frac[ok]
    e_mask[upd] = a_mask[ok]
    return dataclasses.replace(
        ds, formulas=list(formulas), tokens=tokens,
        element_indices=e_idx, element_fractions=e_frac, element_mask=e_mask)


def _apply_order_augmentation(ds: DatasetArrays, tokenizer: FractionAwareTokenizer,
                              k: int, seed: int, native: bool = True) -> DatasetArrays:
    """Appends up to ``k`` random element-order respellings of every
    multi-element row as rows of their own.  Tokens and element slots
    follow each spelling's appearance order; Tc, Magpie, the labels and
    the compositional targets are the source row's.  A respelling that
    does not round-trip through the tokenizer is skipped."""
    aug = OrderAugmentation(n_augmentations=k, seed=seed)
    src_rows: List[int] = []
    spellings: List[str] = []
    for i, f in enumerate(ds.formulas):
        for g in aug.augment(f, include_original=False):
            src_rows.append(i)
            spellings.append(g)
    if not spellings:
        return ds
    toks, a_idx, a_frac, a_mask, ok = _build_aug_rows(spellings, tokenizer, native)
    src = np.asarray(src_rows)[ok]
    return DatasetArrays(
        formulas=ds.formulas + [s for s, o in zip(spellings, ok) if o],
        tokens=np.concatenate([ds.tokens, toks[ok]]),
        element_indices=np.concatenate([ds.element_indices, a_idx[ok]]),
        element_fractions=np.concatenate([ds.element_fractions, a_frac[ok]]),
        element_mask=np.concatenate([ds.element_mask, a_mask[ok]]),
        tc=np.concatenate([ds.tc, ds.tc[src]]),
        magpie=np.concatenate([ds.magpie, ds.magpie[src]]),
        is_sc=np.concatenate([ds.is_sc, ds.is_sc[src]]),
        label=np.concatenate([ds.label, ds.label[src]]),
        hp=np.concatenate([ds.hp, ds.hp[src]]),
        family=np.concatenate([ds.family, ds.family[src]]),
        comp_targets=np.concatenate([ds.comp_targets, ds.comp_targets[src]]),
        norm_stats=ds.norm_stats,
        aug_group=np.concatenate([np.arange(len(ds)), src]).astype(np.int32),
    )


def compute_sample_weights(
    ds: DatasetArrays,
    balanced: bool = True,
    oversample_hard: bool = True,
    oversample_length_base: float = 15.0,
    oversample_high_tc: bool = True,
    tc_bins: Optional[Dict[float, float]] = None,
) -> np.ndarray:
    """Weighted-sampling weights, normalised to sum 1: SC balance x
    hard-length x high-Tc boosts (reference: train_v12_clean.py:2179-2258),
    each source row's mass split over its order-augmented spellings."""
    n = len(ds)
    w = np.ones(n, np.float64)
    if balanced:
        n_sc = int((ds.is_sc == 1).sum())
        n_non = n - n_sc
        # balance only when the minority class is substantial: 50/50 over a
        # handful of minority rows would replay them hundreds of times
        minority = min(n_sc, n_non)
        if minority >= max(20, int(0.01 * n)):
            w = np.where(ds.is_sc == 1, 1.0 / n_sc, 1.0 / n_non)
    if oversample_hard:
        seq_len = (ds.tokens != 0).sum(axis=1).astype(np.float64)
        n_elem = ds.element_mask.sum(axis=1).astype(np.float64)
        length_boost = 1.0 + np.clip(
            (seq_len - oversample_length_base) / oversample_length_base, 0, 3.0)
        elem_boost = 1.0 + 0.5 * np.clip(n_elem - 3, 0, 4.0)
        w = w * length_boost * elem_boost
    if oversample_high_tc:
        bins = tc_bins or {50.0: 3.0, 100.0: 10.0}
        tc_k = ds.norm_stats.tc_to_kelvin(ds.tc)
        boost = np.ones(n)
        for thr in sorted(bins):
            boost[(tc_k >= thr) & (ds.is_sc == 1)] = bins[thr]
        w = w * boost
    if ds.aug_group is not None:
        counts = np.bincount(ds.aug_group, minlength=ds.aug_group.max() + 1)
        w = w / counts[ds.aug_group]
    return (w / w.sum()).astype(np.float64)
