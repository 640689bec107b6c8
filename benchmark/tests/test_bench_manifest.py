"""BENCHMARK.json against the contract, and every name it gives resolving
to its files, so that a new cell, configuration, traffic mix or metric is
new files plus new entries."""

import json
import shutil

import pytest

from benchmark import manifest

BENCH = manifest.load()
ROOT = manifest.ROOT


def test_top_level_keys_and_command():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs', 'workloads',
                          'end_to_end', 'per_layer'}
    assert BENCH['command'] == ['python3', 'benchmark/run.py']
    assert BENCH['paths'] == ['benchmark']
    assert 1 <= BENCH['run_seconds'] <= 51 and isinstance(BENCH['run_seconds'], int)
    assert (ROOT / 'BENCHMARK.json').stat().st_size <= 64 * 1024


def _names():
    for key in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        for entry in BENCH[key]:
            yield entry['name']
    for cell in BENCH['workloads']:
        yield cell['config']
        yield cell['traffic']
    for cfg in BENCH['configs']:
        yield from cfg['reduced']


def test_names_units_and_texts():
    for name in _names():
        assert manifest.NAME.match(name), name
    for m in BENCH['end_to_end'] + BENCH['per_layer']:
        assert manifest.UNIT.match(m['unit']), m
        assert m['better'] in ('lower', 'higher')
    texts = [c['why'] for c in BENCH['configs'] + BENCH['workloads']]
    texts += [m['layer'] for m in BENCH['per_layer']] + [c['source'] for c in BENCH['configs']]
    for text in texts:
        assert 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text, text
    for key in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        names = [e['name'] for e in BENCH[key]]
        assert len(names) == len(set(names))
    pairs = [(c['config'], c['traffic']) for c in BENCH['workloads']]
    assert len(pairs) == len(set(pairs))


def test_entry_keys():
    for c in BENCH['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
    for w in BENCH['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['chips'] in (1, 4)
    for m in BENCH['end_to_end']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'bound', 'source'}
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    e2e = {m['name'] for m in BENCH['end_to_end']}
    assert 'setup_s' in e2e
    for m in BENCH['per_layer']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'source', 'layer', 'moves'}
        assert m['moves'] in e2e
        assert m['source'] in ('device_trace', 'program_span', 'program_counter', 'host_clock')


@pytest.mark.parametrize('cell', [w['name'] for w in BENCH['workloads']])
def test_every_cell_resolves_by_name(cell):
    spec = manifest.resolve(cell)
    assert spec['config']['name'] == spec['cell']['config']
    limits = set(spec['limits']['limits'])
    assert 'rows_missing' in limits and limits & {'raw_err', 'raw_err_mean'}
    e2e = [m['name'] for m in spec['end_to_end']]
    assert 'setup_s' in e2e and len(e2e) >= 2
    assert spec['per_layer']
    for m in spec['end_to_end'] + spec['per_layer']:
        assert callable(manifest.reader(m['name']))
    for m in spec['per_layer']:
        assert m['moves'] in e2e
    import importlib
    importlib.import_module(f"benchmark.generators.{spec['traffic']['generator']}")
    importlib.import_module(f"benchmark.loops.{spec['traffic']['loop']}")
    importlib.import_module(f"benchmark.reference.{spec['config']['reference']}")


def test_configs_are_used_and_unreduced():
    used = {w['config'] for w in BENCH['workloads']}
    for c in BENCH['configs']:
        assert c['name'] in used
        cfg = json.loads((ROOT / c['file']).read_text())
        assert c['file'].startswith('benchmark/') and cfg['reduced'] == c['reduced'] == []
        assert cfg['linear_size'] == 1024 and cfg['num_stage'] == 3


def test_a_cell_is_added_by_new_files_only(tmp_path):
    """A copy of the benchmark takes a new cell, traffic mix, limits and
    metric as new files plus new entries, and resolves them; no file that
    was there changes."""
    root = tmp_path / 'checkout'
    shutil.copytree(ROOT / 'benchmark', root / 'benchmark')
    before = {p: p.read_bytes() for p in (root / 'benchmark').rglob('*') if p.is_file()}
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    traffic = json.loads((root / 'benchmark/traffic/stereo_crowd_int8.json').read_text())
    traffic.update(people_mean=3.5)
    (root / 'benchmark/traffic/stereo_sparse_int8.json').write_text(json.dumps(traffic))
    (root / 'benchmark/limits/monstereo-sparse-int8.json').write_text(
        (root / 'benchmark/limits/monstereo-crowd-int8.json').read_text())
    (root / 'benchmark/metrics/rows_padded_share.bulk.py').write_text(
        'def read(run):\n    return None\n')
    bench['workloads'].append({'name': 'monstereo-sparse-int8', 'config': 'monstereo',
                               'traffic': 'stereo_sparse_int8', 'chips': 1, 'why': 'sparse'})
    bench['per_layer'].append({'name': 'rows_padded_share.bulk', 'unit': '%',
                               'better': 'lower', 'source': 'program_counter',
                               'layer': 'engine', 'moves': 'detections_per_s'})
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    spec = manifest.resolve('monstereo-sparse-int8', root=root)
    assert spec['traffic']['people_mean'] == 3.5
    assert [m['name'] for m in spec['per_layer']][-1] == 'rows_padded_share.bulk'
    assert manifest.reader('rows_padded_share.bulk', root=root)({}) is None
    for path, data in before.items():
        assert path.read_bytes() == data
