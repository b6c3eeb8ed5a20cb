"""The readers of the counters of where the fleet driver's copies land:
``fleet.pinned_share`` and ``fleet.pinned_new_mb`` on a synthetic counter
snapshot, and nothing where the program does not count them (a program
whose copies do not land in page-locked memory, or without counters)."""

import sys
import types

import pytest

from perfbench import run
from perfbench.lib import manifest
from perfbench.lib.counters import MODULE
from perfbench.lib.trace import Trace

COUNTERS = {'fleet.records': 4, 'fleet.host_bytes': 4 * 134_217_728,
            'fleet.final_bytes': 402_653_184, 'fleet.pinned_bytes': 4 * 134_217_728,
            'fleet.pinned_new_bytes': 2_000_000}


def read(metric):
    window = {'ph': 'X', 'cat': 'user_annotation', 'name': 'perfbench.window', 'ts': 100,
              'dur': 1000}
    ctx = run.Context(Trace([window]), [{'seconds': 0.5}] * 2, {}, [0])
    return manifest.reader(metric).read(ctx)


@pytest.fixture
def program(monkeypatch):
    """The program's counters module, holding ``COUNTERS``."""
    module = types.ModuleType(MODULE)
    module.counters = lambda: dict(COUNTERS)
    monkeypatch.setitem(sys.modules, MODULE, module)
    return module


@pytest.mark.parametrize('metric, value', [
    ('fleet.pinned_share', 100 * 4 * 134_217_728 / (4 * 134_217_728 + 402_653_184)),
    ('fleet.pinned_new_mb', 0.5)])
def test_the_pinned_readers_are_ratios_of_the_programs_counters(metric, value, program):
    assert read(metric) == pytest.approx(value)


def test_every_byte_pinned_reads_100_and_nothing_pinned_anew_reads_0(program):
    program.counters = lambda: dict(COUNTERS, **{
        'fleet.pinned_bytes': COUNTERS['fleet.host_bytes'] + COUNTERS['fleet.final_bytes'],
        'fleet.pinned_new_bytes': 0})
    assert read('fleet.pinned_share') == pytest.approx(100.0)
    assert read('fleet.pinned_new_mb') == 0.0


@pytest.mark.parametrize('metric', ['fleet.pinned_share', 'fleet.pinned_new_mb'])
def test_a_program_that_does_not_count_pinned_bytes_reads_nothing(metric, program, monkeypatch):
    program.counters = lambda: {k: v for k, v in COUNTERS.items() if 'pinned' not in k}
    assert read(metric) is None
    monkeypatch.delitem(sys.modules, MODULE, raising=False)
    assert read(metric) is None


def test_no_bytes_copied_reads_no_share(program):
    program.counters = lambda: {'fleet.records': 2, 'fleet.pinned_bytes': 0}
    assert read('fleet.pinned_share') is None
