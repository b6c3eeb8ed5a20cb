"""The readers of the program's own spans and counters: their values on a
synthetic trace and counter snapshot, and nothing where the program keeps
neither (a program without ``supervillain_tpu_torch.tracing``)."""

import sys
import types

import pytest

from perfbench import run
from perfbench.lib import manifest
from perfbench.lib.counters import MODULE
from perfbench.lib.trace import Trace


def span(name, ts, dur, cat='user_annotation'):
    return {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur}


# A window of 1000 µs holding two records; a call's finish wholly inside it and
# another's cut by its start; a wait that the window's end cuts.
EVENTS = [span('perfbench.window', 100, 1000),
          span('fleet.finish', 0, 300), span('fleet.finish', 400, 200),
          span('fleet.wait', 150, 40), span('fleet.wait', 1080, 40),
          span('fleet.store', 200, 60), span('fleet.store', 700, 100),
          span('aten::copy_', 210, 10, 'cpu_op')]
COUNTERS = {'fleet.records': 4, 'fleet.host_bytes': 4 * 134_217_728, 'fleet.syncs': 26,
            'sweep.villain.barrier_cycles': 152, 'sweep.villain.cycles': 1000}


def read(metric, events=EVENTS, records=2):
    ctx = run.Context(Trace(events), [{'seconds': 0.5}] * records, {}, [0])
    return manifest.reader(metric).read(ctx)


@pytest.fixture
def program(monkeypatch):
    """The program's counters module, holding ``COUNTERS``."""
    module = types.ModuleType(MODULE)
    module.counters = lambda: dict(COUNTERS)
    monkeypatch.setitem(sys.modules, MODULE, module)
    return module


@pytest.mark.parametrize('metric, value', [
    ('fleet.wait_ms', 1e-3 * (40 + 20) / 2),        # the second wait clipped to 20 µs
    ('fleet.store_ms', 1e-3 * (60 + 100) / 2),
    ('fleet.finish_ms', 0.2),                       # the one wholly inside the window
])
def test_span_readers_sum_the_programs_spans_in_the_window(metric, value):
    assert read(metric) == pytest.approx(value)


@pytest.mark.parametrize('metric, value', [
    ('fleet.host_mb', 134.217728), ('fleet.syncs', 6.5), ('sweep.villain.barrier_wait', 15.2)])
def test_counter_readers_are_ratios_of_the_programs_counters(metric, value, program):
    assert read(metric) == pytest.approx(value)


@pytest.mark.parametrize('metric', ['fleet.wait_ms', 'fleet.store_ms', 'fleet.finish_ms',
                                    'fleet.host_mb', 'fleet.syncs', 'sweep.villain.barrier_wait'])
def test_a_program_without_spans_or_counters_reads_nothing(metric, monkeypatch):
    monkeypatch.delitem(sys.modules, MODULE, raising=False)
    assert read(metric, EVENTS[:1] + EVENTS[-1:]) is None


def test_nothing_is_read_where_nothing_was_counted_or_no_record_completed(program):
    assert read('fleet.wait_ms', records=0) is None
    assert read('fleet.finish_ms', [span('perfbench.window', 100, 100)] + EVENTS[1:2]) is None
    program.counters = lambda: dict(COUNTERS, **{'sweep.villain.cycles': 0})
    assert read('sweep.villain.barrier_wait') is None
    program.counters = lambda: {'fleet.records': 3}
    assert read('fleet.host_mb') is None and read('fleet.syncs') is None
