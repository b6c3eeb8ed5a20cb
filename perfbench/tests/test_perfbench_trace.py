"""The reduction of a profiler trace: busy time as a union, idle gaps named by
the host, operations by name."""

import pytest

from perfbench import run
from perfbench.lib import manifest, peaks
from perfbench.lib.trace import Trace, breakdown


def span(name, ts, dur, cat='user_annotation'):
    return {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur}


def op(name, ts, dur, card=0, cat='kernel'):
    return dict(span(name, ts, dur, cat), args={'device': card})


EVENTS = [span('perfbench.window', 0, 100), span('perfbench.window', 10, 20, 'gpu_user_annotation'),
          span('perfbench.record', 0, 60), span('aten::copy_', 40, 30, 'cpu_op'),
          op('void (anonymous namespace)::k<true>(int*)', 5, 10),
          op('void (anonymous namespace)::k<true>(int*)', 12, 10),
          op('Memcpy DtoH (Device -> Pageable)', 50, 10, cat='gpu_memcpy'),
          op('void (anonymous namespace)::k<true>(int*)', 0, 100, card=1),
          op('outside', 150, 10)]


def test_busy_time_is_a_union_and_the_window_is_the_hosts():
    t = Trace(EVENTS)
    assert t.window_s == pytest.approx(1e-4)
    assert t.busy_s(0) == pytest.approx(27e-6) and t.busy_s(1) == pytest.approx(1e-4)
    assert t.gaps(0) == [(0.0, 5.0), (22.0, 50.0), (60.0, 100.0)]
    assert t.copies_to_host_s() == pytest.approx(1e-5)


def test_idle_gaps_are_named_by_the_innermost_host_span():
    idle = Trace(EVENTS).idle_by_host()
    assert idle == pytest.approx({'perfbench.record': 33e-6, 'perfbench.window': 40e-6})
    b = breakdown(Trace(EVENTS))
    assert b['device_ops'][0] == ['k<true>', pytest.approx(1.2e-4)]
    assert len(b['device_ops']) <= 10 and len(b['idle_gaps']) <= 10


def test_the_shares_count_partings_and_early_partings():
    from perfbench.lib.verdict import shares
    assert shares([None, 0, 1, 2, None, 29, None, None]) == {'parted_share': 0.5,
                                                            'early_parted_share': 0.25}


NATIVE = 'void at::native::vectorized_elementwise_kernel<4, at::native::AddFunctor<float> >(int)'
DIST = ('void at::native::(anonymous namespace)::distribution_elementwise_grid_stride_kernel'
        '<float, 4>(long)')
K1 = 'void (anonymous namespace)::chunked_worm_kernel(float const*, int*, int const*)'
# A window of 1000 µs, two records: PyTorch's kernels 300 µs on card 0, K1
# twice after its copy of n on the card, four readbacks of 8 B and a column
# copy, and a copy to the card.
GENERAL = [span('perfbench.window', 0, 1000), op(NATIVE, 10, 100), op(DIST, 200, 200),
           op('Memcpy DtoD (Device -> Device)', 480, 15, cat='gpu_memcpy'),
           op(K1, 500, 40), op(K1, 600, 60), op('outside', 2000, 10),
           op('Memcpy DtoH (Device -> Pageable)', 450, 2, cat='gpu_memcpy'),
           op('Memcpy DtoH (Device -> Pageable)', 550, 2, cat='gpu_memcpy'),
           op('Memcpy DtoH (Device -> Pageable)', 650, 2, cat='gpu_memcpy'),
           op('Memcpy DtoH (Device -> Pageable)', 700, 2, cat='gpu_memcpy'),
           op('Memcpy DtoH (Device -> Pageable)', 800, 90, cat='gpu_memcpy'),
           op('Memcpy HtoD (Pageable -> Device)', 900, 5, cat='gpu_memcpy')]
FLEET = {'chains': 512, 'L': 256, 'thin': 4,
         'kernels': ['updates.villain', 'worm.villain_chunked']}


def general_read(metric, events=GENERAL, records=2):
    ctx = run.Context(Trace(events), [{'seconds': 0.5}] * records, FLEET, [0])
    return manifest.reader(metric).read(ctx)


def test_the_general_fleets_readers_on_a_synthetic_trace():
    assert general_read('updates.torch_ms') == pytest.approx(1e-3 * 300 / 2)
    assert general_read('fleet.readbacks') == 5 / 2
    least = peaks.least_seconds(*manifest.counts('worm.villain_chunked').count(FLEET))
    assert general_read('worm.villain_chunked_roofline') == pytest.approx(
        100 * 2 * least / 100e-6)
    least = peaks.least_seconds(*manifest.counts('updates.villain').count(FLEET))
    assert general_read('updates.villain_roofline') == pytest.approx(100 * 2 * least / 300e-6)
    # The whole record: both counts together, over the window's wall time.
    counted = [manifest.counts(k).count(FLEET) for k in FLEET['kernels']]
    least = peaks.least_seconds(sum(c[0] for c in counted), sum(c[1] for c in counted))
    assert general_read('record_mfu') == pytest.approx(100 * 2 * least / 1000e-6)


@pytest.mark.parametrize('metric', ['updates.torch_ms', 'fleet.readbacks',
                                    'worm.villain_chunked_roofline', 'updates.villain_roofline'])
def test_the_general_fleets_readers_read_nothing_where_nothing_ran(metric):
    assert general_read(metric, GENERAL[:1] + GENERAL[-1:]) is None
    assert general_read(metric, records=0) is None
