"""The reduction of a profiler trace: busy time as a union, idle gaps named by
the host, operations by name."""

import pytest

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
