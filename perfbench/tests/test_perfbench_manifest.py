"""BENCHMARK.json against the benchmark's contract, and every cell's files found by name."""

import json
import re

import pytest

from perfbench.lib import manifest

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
M = manifest.manifest()
CELLS = [w['name'] for w in M['workloads']]


def test_the_manifest_has_exactly_the_contract_keys():
    assert set(M) == {'command', 'paths', 'run_seconds', 'configs', 'workloads', 'end_to_end',
                      'per_layer'}
    assert M['command'] == ['python3', 'perfbench/run.py'] and M['paths'] == ['perfbench']
    assert isinstance(M['run_seconds'], int) and 1 <= M['run_seconds'] <= 51
    assert len((manifest.ROOT / 'BENCHMARK.json').read_bytes()) <= 64 * 1024


def test_entries_keep_to_the_contract():
    for c in M['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'} and NAME.match(c['name'])
        assert c['file'].startswith('perfbench/') and (manifest.ROOT / c['file']).is_file()
    assert len({c['file'] for c in M['configs']}) == len(M['configs'])
    for w in M['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert NAME.match(w['name']) and NAME.match(w['traffic']) and w['chips'] in (1, 4)
        assert 1 <= len(w['why']) <= 200 and '\n' not in w['why']
    assert sum(w['chips'] == 4 for w in M['workloads']) <= 1
    assert len({(w['config'], w['traffic']) for w in M['workloads']}) == len(M['workloads'])
    names = [m['name'] for m in M['end_to_end'] + M['per_layer']]
    assert len(set(names)) == len(names) and all(NAME.match(n) for n in names)
    for m in M['end_to_end']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'bound', 'source'}
        assert 0.01 <= m['bound'] <= 0.25 and m['source'] in ('host_clock', 'device_trace')
    assert 'setup_s' in [m['name'] for m in M['end_to_end']]
    e2e = {m['name'] for m in M['end_to_end']}
    for m in M['per_layer']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'source', 'layer', 'moves'}
        assert m['moves'] in e2e and UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
    for m in M['per_layer']:
        if m['name'].endswith('_roofline') or 'mfu' in m['name']:
            assert m['unit'] == '%'


@pytest.mark.parametrize('cell', CELLS)
def test_every_file_of_a_cell_is_found_by_name(cell):
    entry, config_entry, config, traffic = manifest.cell(cell)
    assert config['name'] == entry['config'] and config['reduced'] == config_entry['reduced']
    reference = manifest.reference(config, traffic)
    assert reference.FIELDS and callable(reference.replay)
    for kernel in traffic['kernels']:
        counts = manifest.counts(kernel)
        assert callable(counts.count) and callable(counts.matches)
    assert set(traffic['limits']) == {'parted_share', 'early_parted_share'}
    assert all(0 < limit < 1 for limit in traffic['limits'].values())
    # A fault in half the fleet, or in one card's shard of it, parts that share
    # of the checked chains at once, and fails.
    assert traffic['limits']['early_parted_share'] < min(0.5, 1 / entry['chips'])
    e2e = manifest.metrics_of(cell, 'end_to_end')
    layer = manifest.metrics_of(cell, 'per_layer')
    assert 'setup_s' in [m['name'] for m in e2e] and len(e2e) >= 2 and layer
    for metric in layer:
        assert callable(manifest.reader(metric['name']).read)
        assert metric['moves'] in [m['name'] for m in e2e]


def test_every_metric_file_belongs_to_a_metric():
    files = {p.stem for p in (manifest.BENCH / 'metrics').glob('*.py')}
    assert files == {m['name'] for m in M['per_layer']}
    json.dumps(M)
