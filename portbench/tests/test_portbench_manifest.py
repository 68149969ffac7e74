"""BENCHMARK.json loads, and every name, unit and file it names keeps to
the benchmark's rules."""

import json
import os

import pytest

from portbench import manifest
from portbench.metrics import reader

BENCH = manifest.load()
LINE = lambda s: 1 <= len(s) <= 200 and '\n' not in s and '\t' not in s


def test_top_level_keys():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert BENCH['paths'] == ['portbench']
    assert 1 <= BENCH['run_seconds'] <= 51
    assert all(LINE(w) for w in BENCH['command'])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_units():
    names = []
    for group in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        for e in BENCH[group]:
            assert manifest.NAME.match(e['name']), e['name']
            names.append((group in ('end_to_end', 'per_layer'), e['name']))
            if 'unit' in e:
                assert manifest.UNIT.match(e['unit']), e['unit']
                assert e['better'] in ('lower', 'higher')
    assert len(names) == len(set(names))
    for w in BENCH['workloads']:
        assert manifest.NAME.match(w['config'])
        assert manifest.NAME.match(w['traffic'])
        assert w['chips'] in (1, 4) and LINE(w['why'])


def test_files_found_by_name():
    root = manifest.ROOT
    configs = {c['name'] for c in BENCH['configs']}
    for c in BENCH['configs']:
        path = os.path.join(root, c['file'])
        assert c['file'].startswith('portbench/') and os.path.exists(path)
        with open(path) as f:
            cfg = json.load(f)
        assert cfg['source'] == c['source']
        assert cfg['reduced'] == c['reduced']
        assert cfg['limits'] and all(v > 0 for v in cfg['limits'].values())
    for w in BENCH['workloads']:
        assert w['config'] in configs
        cell = manifest.cell(w['name'])
        assert manifest.driver(cell['traffic']) is not None
        assert any(m['name'] == 'setup_s' for m in cell['end_to_end'])
        assert len(cell['end_to_end']) >= 2 and cell['per_layer']


def test_metrics():
    e2e = {m['name']: m for m in BENCH['end_to_end']}
    assert e2e['setup_s']['bound'] == 0.25
    for m in BENCH['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    cells = {w['name'] for w in BENCH['workloads']}
    for m in BENCH['per_layer']:
        assert m['moves'] in e2e and LINE(m['layer'])
        assert set(m['workloads']) <= cells
        assert callable(reader(m['name']))
        if m['name'].endswith('_roofline'):
            assert m['unit'] == '%'


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        manifest.cell('no.such_cell')
