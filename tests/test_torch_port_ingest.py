"""Offline ingestion in the port (data/ingest_sources.py, utils/
materials_api.py, scripts/ingest.py, all without pandas) against the JAX
package's (pandas) on the cases of tests/test_ingest_sources.py and small
fixture files:
- ``parse_tc_text``, ``clean_formula_text``, the retraction filter and
  ``canonical_key``: equal to JAX's on every case;
- each reader's rows equal JAX's frame row for row (``to_dict('records')``,
  NaN equal to NaN), files with bad and blank lines and missing cells
  included, and quoted fields that span lines or hold characters that
  ``str.splitlines`` would break at; ``merge_sources`` the same, with its
  report;
- the materials fallback as tests/test_misc.py holds JAX's;
- the ingest CLI on the same fixture files, every flag but the REST path,
  writes the same CSV as JAX's scripts/ingest.py, byte for byte.
"""

import math
import runpy
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from superconductor_vae_tpu.data import ingest_sources as jax_src
from superconductor_vae_tpu.utils.materials_api import (
    MaterialsProjectClient as JaxClient)
from superconductor_vae_tpu_torch.data import ingest_sources as src
from superconductor_vae_tpu_torch.data import parse_formula_composition
from superconductor_vae_tpu_torch.scripts import ingest as cli
from superconductor_vae_tpu_torch.utils.materials_api import MaterialsProjectClient
import torch_port_threads  # noqa: F401  (one torch thread a process)

ROOT = Path(__file__).resolve().parents[1]

TC_TEXTS = ['93 K', '93K', '~39 K', '4.2', '92 ± 1 K', '1.5 ± 0.2', '88-92 K', '88–92 K',
            '10-20', '∼23 K', '≈7.7K', None, '', 'NSC', 'n/a', '-', 'not superconducting',
            'varies with doping', 'onset at 90 K', 'Tc1 = 90, Tc2 = 60', '90 K, 60 K',
            '90; 60', '90/110 K', '350 mK', '1.2 meV', '< 2 K', '≤ 4 K',
            'suppressed below 1 K', '93 K at 5 GPa', 'broad transition', '120-90 K']
FORMULAS = ['YBa₂Cu₃O₇', 'YBa2Cu3O7-δ', 'La2-xSrxCuO4', 'Bi2Sr2CaCu2O8+δ',
            'MgB2 + 5 wt% SiC', '(Ag)0.5/YBa2Cu3O7', 'Nb3Sn/Cu', 'Ba(3/5)Sr(2/5)CuO2',
            'Tl2Ba2Ca(19/20)Y(1/20)Cu2O8', 'Nb-Ti', 'La-Ba-Cu-O', '50% Nb + 50% Ti',
            'MgB2 (single phase)', '', '123', None, float('nan')]
RETRACTION = [('LuH2', 280.0), ('CSH7', 287.0), ('Pb9Cu(PO4)6O', 400.0),
              ('La0.7Sr0.3MnO3', 360.0), ('ZnO', 300.0), ('Fe2O3', 250.0),
              ('YBa2Cu3O7', 92.0), ('MgB2', 39.0), ('LaH10', 250.0), ('H3S', 203.0),
              ('Nb3Sn', 18.0), ('LuH2', 10.0)]


def test_text_helpers_equal_jax():
    for t in TC_TEXTS:
        assert src.parse_tc_text(t) == jax_src.parse_tc_text(t), t
    for f in FORMULAS:
        assert src.clean_formula_text(f) == jax_src.clean_formula_text(f), f
    for f, tc in RETRACTION:
        assert (src.is_retracted_or_contaminated(f, tc)
                == jax_src.is_retracted_or_contaminated(f, tc)), f
    for f in ('YBa2Cu3O7', 'Y2Ba4Cu6O14', 'MgB2', 'B2Mg', 'MgB4', '', 'La1.85Sr0.15CuO4'):
        assert src.canonical_key(f) == jax_src.canonical_key(f), f


def _same(a, b):
    return (a == b or (isinstance(a, float) and isinstance(b, float)
                       and math.isnan(a) and math.isnan(b)))


def _assert_rows(got, frame):
    want = frame.to_dict('records')
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            assert _same(g[k], w[k]), (k, g[k], w[k])


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp('sources')
    (d / 'nemad.csv').write_text(
        'Chemical_Composition,Data_Type,Median_Tc_By_Composition_K,'
        'Superconducting_Transition_Temperature\n'
        'YBa₂Cu₃O₇-δ,Experimental,92.0,92 K\n'
        'MgB2,Experimental,,~39 K\n'
        'Nb-Ti,Experimental,9.2,9 K\n'
        'La2CuO4,Computational,35.0,35 K\n'
        'Fe2O3,Experimental,250.0,250 K\n'
        'Nb3Sn,experimental data,,onset at 18 K\n'
        'NbN,Experimental,,16 K,extra,fields\n'
        '\n'
        'V3Si,Experimental,-1,17.1\n')
    rows = ['h1', 'h2', 'h3']
    for formula, tc in [('YBa2Cu3O7-Y', '91'), ('MgB2', '39'), ('LuH3', '274'),
                        ('BadTc', 'xx'), ('La2CuO4Oz', '38'), ('', '5')]:
        rows.append('\t'.join(['a', 'b', formula, 'd', 'e', tc, 'g']))
    (d / 'primary.tsv').write_text('\n'.join(rows) + '\n')
    # quoted fields that span lines or hold other line-breaking characters
    pd.DataFrame({'formula': ['Bi2Sr2CaCu2O8+δ', 'La0.7Ca0.3MnO3', 'Nb3Ge', 'YBa2Cu3O7',
                              'MgB2', 'Nb3Sn'],
                  'criticalTemperature': [85.0, 260.0, 23.2, 93.0, 39.0, 18.0],
                  'materialClass': ['cuprate', 'oxide', None, 'cuprate', 'boride\nlayered',
                                    'A15\u2028inter\x0cmetallic\x1c\x85']}).to_csv(
                      d / 'sc2.csv', index=False)
    (d / '3dsc.csv').write_text('# comment line\nformula_sc,tc,sc_class\n'
                                'Nb3Sn,18.0,A15\nMgB2,39.0,other # note\nYBa2Cu3O7,91.5,\n')
    pd.DataFrame({'Formula': ['FeSe', 'Hg', 'Ba2Cu3O7Y'], 'Tc': [8.0, 4.2, 92.0],
                  'Materials_family': ['iron', 'elemental', 'cuprate']}).to_csv(
                      d / 'sodnet.csv', index=False)
    (d / 'generic.csv').write_text('formula,Tc,note\nLa1.85Sr0.15CuO4,38,a\n'
                                   'YBa2Cu3O4-Y,,b\nNbTi,9.5,c\nMgB2,39.04,d\nMgB2,39.01,e\n'
                                   'SiO2,0,f\n')
    (d / 'supercon.tsv').write_text('0\t1\t2\nname\tTc\tref\nPb\t7.2\tx\nH3S\t203\ty\n')
    (d / 'prev.csv').write_text('formula,Tc\nHg,4.2\n')
    (d / 'dft.csv').write_text('formula,ehull\nNaCl,0.0\nKBr,0.5\nCaTiO3,\nMgO,0.1\n'
                               'Cu2O,0.05\n,0.0\nZnS,0.0\n')
    return d


def test_readers_equal_jax(files):
    d = files
    cols = {'Chemical_Composition': ['YBa₂Cu₃O₇-δ', 'MgB2', 'MgB2'],
            'Data_Type': ['Experimental'] * 3,
            'Median_Tc_By_Composition_K': [92.0, np.nan, np.nan],
            'Superconducting_Transition_Temperature': ['92 K', '~39 K', 'onset at 39 K']}
    _assert_rows(src.read_nemad(cols), jax_src.read_nemad(pd.DataFrame(cols)))
    for reader, name in (('read_nemad', 'nemad.csv'), ('read_mdr', 'primary.tsv'),
                         ('read_supercon2', 'sc2.csv'), ('read_threedsc', '3dsc.csv'),
                         ('read_sodnet', 'sodnet.csv')):
        got = getattr(src, reader)(d / name)
        assert got, reader
        _assert_rows(got, getattr(jax_src, reader)(d / name))
    _assert_rows(src.manual_hydrides(), jax_src.manual_hydrides())


def test_merge_sources_equals_jax(files):
    d = files
    frames = [src.read_nemad(d / 'nemad.csv'), src.read_supercon2(d / 'sc2.csv'),
              src.read_sodnet(d / 'sodnet.csv'), src.manual_hydrides(),
              [{'formula': 'MgB2', 'Tc': 150.0, 'is_superconductor': 1,
                'tc_source': 'experimental', 'dataset': 'mdr_supercon', 'category_hint': ''}]]
    jframes = [jax_src.read_nemad(d / 'nemad.csv'), jax_src.read_supercon2(d / 'sc2.csv'),
               jax_src.read_sodnet(d / 'sodnet.csv'), jax_src.manual_hydrides(),
               pd.DataFrame(frames[-1])]
    holdout = {src.canonical_key('FeSe')}
    existing = {src.canonical_key('Hg')}
    got, rep = src.merge_sources(frames, holdout_keys=holdout, existing_keys=existing)
    want, jrep = jax_src.merge_sources(jframes, holdout_keys=holdout, existing_keys=existing)
    assert rep == jrep and rep['conflicts_resolved'] > 0
    _assert_rows(got, want)
    keys = src.load_holdout_keys(ROOT / 'data' / 'GENERATIVE_HOLDOUT_DO_NOT_TRAIN.json')
    assert keys == jax_src.load_holdout_keys(
        ROOT / 'data' / 'GENERATIVE_HOLDOUT_DO_NOT_TRAIN.json') and keys


def test_materials_fallback():
    client = MaterialsProjectClient(api_key=None)
    rows = client.fetch_non_sc(40)
    assert rows == JaxClient(api_key=None).fetch_non_sc(40)
    assert len(rows) == 40
    assert all(r['category'].startswith('Non-SC') for r in rows)
    assert all(parse_formula_composition(r['formula']) for r in rows)


def test_ingest_cli_writes_jax_csv(files, tmp_path, monkeypatch):
    d = files
    monkeypatch.delenv('MP_API_KEY', raising=False)
    flags = ['--sources', str(d / 'generic.csv'), str(d / 'supercon.tsv'),
             '--nemad', str(d / 'nemad.csv'), '--mdr', str(d / 'primary.tsv'),
             '--supercon2', str(d / 'sc2.csv'), '--threedsc', str(d / '3dsc.csv'),
             '--sodnet', str(d / 'sodnet.csv'), '--manual-hydrides',
             '--exclude-existing', str(d / 'prev.csv'), '--add-non-sc', '30',
             '--non-sc-dft', str(d / 'dft.csv'), '--featurize']
    out = cli.main(flags + ['--out', str(tmp_path / 'port.csv')])
    monkeypatch.setattr(sys, 'argv', ['ingest.py', *flags, '--out', str(tmp_path / 'jax.csv')])
    runpy.run_path(str(ROOT / 'scripts' / 'ingest.py'), run_name='__main__')
    got, want = out.read_text(), (tmp_path / 'jax.csv').read_text()
    assert got.count('\n') > 40
    assert got == want
