"""The control, at a size a test holds: the reference computed in bfloat16,
below the float32 that each configuration states, fails both numbers of the
comparison that a sound run passes."""

import pytest
import torch

from perfbench import readings
from perfbench.lib import manifest
from perfbench.tests.conftest import TINY

CELLS = [w['name'] for w in manifest.manifest()['workloads']]


@pytest.mark.parametrize('cell', CELLS)
def test_the_bfloat16_control_parts_from_the_reference(cell):
    _, _, config, traffic = manifest.cell(cell)
    traffic = dict(traffic, **dict(TINY[cell], records_per_call=6, thin=6))
    reading = readings.control_reading(torch, config, traffic, 2 ** 31 + 77, 'cpu')
    for name, limit in traffic['limits'].items():
        assert reading[name] > limit, reading


@pytest.mark.parametrize('cell', CELLS)
def test_a_sound_program_reading_is_within_the_limit(cell, card_on_cpu, capsys):
    overrides = dict(TINY[cell], records_per_call=6, thin=6)
    out = readings.main(['--workload', cell, '--seeds', str(2 ** 31 + 5), '1'], device='cpu',
                        overrides=overrides)
    assert out[0]['parted_share'] == out[0]['early_parted_share'] == 0.0, out
