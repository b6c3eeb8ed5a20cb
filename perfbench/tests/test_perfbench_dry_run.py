"""A run of every cell on the CPU at a tiny size, through the plain path."""

import json

import pytest

from perfbench import run
from perfbench.lib import manifest
from perfbench.tests.conftest import TINY

CELLS = [w['name'] for w in manifest.manifest()['workloads']]


@pytest.mark.parametrize('cell', CELLS)
def test_a_tiny_run_reaches_its_line_and_is_correct(cell, card_on_cpu):
    result = run.run(cell, 2 ** 31 + 12345, 3.0, False, device='cpu', overrides=TINY[cell])
    line = json.loads(json.dumps(result))
    assert line['correct'] is True, line['checked']
    assert line['metrics'] == {}            # no device metric from the CPU
    assert line['device']['platform'] == 'cpu' and line['attempted'] >= 1
    assert list(line)[-1] == 'checked'
    assert {k: c['value'] for k, c in line['checked'].items()} == {
        'parted_share': 0.0, 'early_parted_share': 0.0}
