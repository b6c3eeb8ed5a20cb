"""Where the fused fleet's copies from the cards land (``parallel/fused_fleet.py``,
``parallel/fleet.py`` :class:`Landing` and :func:`host_buffer`).

On a card every copy lands in page-locked host memory that is the fleet's own
column or final field.  On the CPU that branch runs with an ordinary allocator
standing in for the page-locked one and ``copy_`` for the asynchronous copy:
its columns, final fields, stats and byte counts equal the CPU path's bit for
bit.  The tests marked ``cuda`` need a card:

    python -m pytest --noconftest -o addopts='' -m cuda tests/test_torch_fleet_landing.py -q
"""

import copy
import gc
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import supervillain_tpu_torch as tsv
from supervillain_tpu_torch import tracing
from supervillain_tpu_torch.parallel import chain_mesh, fleet, fused_fleet

STEPS = 3


@pytest.fixture(autouse=True)
def fresh_counters():
    tracing.reset()
    yield
    tracing.reset()


@pytest.fixture
def cards_branch(monkeypatch):
    """Turns on the cards' branch for CPU shards, with ordinary buffers
    standing in for page-locked ones."""
    def engage():
        monkeypatch.setattr(fused_fleet, 'lands_pinned', lambda shards: True)
        monkeypatch.setattr(fleet, 'host_buffer',
                            lambda shape, dtype: (torch.empty(shape, dtype=dtype), True))
    return engage


def action(kind, N=8):
    if kind == 'villain':
        return tsv.Villain(tsv.Lattice2D(N), 0.5, W=1)
    return tsv.Worldline(tsv.Lattice2D(N), 0.5, W=2)


def tiny_fleet(kind, shards, keep_fields=False, device='cpu', seed=0, N=8, chains=4):
    mesh = None if shards == 1 else chain_mesh([device] * shards)
    return tsv.sample_fused_fleet(action(kind, N), chains=chains, steps=STEPS, thin=1, worms=1,
                                  seed=seed, keep_fields=keep_fields, mesh=mesh, device=device)


def contents(f):
    """A fleet's columns, final fields and stats, copied."""
    return ({k: np.array(v) for k, v in f.columns.items()},
            {k: np.array(v) for k, v in f.final.items()}, copy.deepcopy(f.stats))


def assert_same(a, b):
    """Two fleets' contents (:func:`contents`) equal bit for bit, dtypes too."""
    for x, y in zip(a[:2], b[:2]):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape, k
            assert np.array_equal(x[k], y[k]), k
    assert a[2] == b[2]


def byte_counts():
    counted = tracing.counters()
    return {k: counted.get(k) for k in ('fleet.records', 'fleet.host_bytes', 'fleet.final_bytes')}


@pytest.mark.parametrize('shards', [1, 2])
@pytest.mark.parametrize('kind, keep_fields', [('villain', False), ('worldline', False),
                                               ('villain', True)])
def test_the_cards_branch_lands_what_the_cpu_path_stores(shards, kind, keep_fields,
                                                         cards_branch):
    expected = contents(tiny_fleet(kind, shards, keep_fields))
    counted = byte_counts()
    tracing.reset()
    cards_branch()
    landed = tiny_fleet(kind, shards, keep_fields)
    assert_same(contents(landed), expected)
    assert byte_counts() == counted
    assert tracing.counters()['fleet.pinned_bytes'] == \
        counted['fleet.host_bytes'] + counted['fleet.final_bytes']
    assert 'fleet.syncs' not in tracing.counters()          # no card, no wait on one


def test_the_cards_branch_spans_a_store_a_record_and_a_wait_a_shard(cards_branch, tmp_path):
    cards_branch()
    shards = 2
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tiny_fleet('villain', shards)
    prof.export_chrome_trace(str(tmp_path / 'trace.json'))
    names = [e['name'] for e in json.loads((tmp_path / 'trace.json').read_text())['traceEvents']
             if e.get('ph') == 'X' and e.get('cat') == 'user_annotation']
    assert names.count('fleet.record') == names.count('fleet.store') == STEPS
    # A wait a shard a record, and a wait a shard for the final fields.
    assert names.count('fleet.wait') == (STEPS + 1) * shards
    # A copy a shard a record; the final fields' and the stats' a shard.
    assert names.count('fleet.copy') == (STEPS + 2) * shards
    assert names.count('fleet.final') == 1


def test_the_fleets_arrays_are_views_of_the_landing_buffers(cards_branch):
    cards_branch()
    like = {'a': torch.arange(6, dtype=torch.int32).reshape(2, 3)}
    landing = fleet.Landing(like, (4,))
    landing.land(like, 1, bytes_counter='fleet.host_bytes')
    arrays = landing.arrays()
    buffer, pinned = landing.buffers['a']
    assert pinned and arrays['a'].shape == (4, 3) and np.shares_memory(arrays['a'], buffer.numpy())
    assert np.array_equal(arrays['a'][1:3], like['a'].numpy())
    assert tracing.counters() == {'fleet.pinned_bytes': 24, 'fleet.host_bytes': 24}


@pytest.fixture
def no_pinning(monkeypatch):
    """``torch.empty`` refusing page-locked memory, as where it runs out."""
    empty = torch.empty

    def refuse(*shape, pin_memory=False, **kw):
        if pin_memory:
            raise RuntimeError('out of page-locked memory')
        return empty(*shape, **kw)

    monkeypatch.setattr(torch, 'empty', refuse)


def test_a_buffer_that_cannot_be_pinned_is_pageable_and_counted(no_pinning):
    buffer, pinned = fleet.host_buffer((2, 3), torch.float64)
    assert not pinned and buffer.shape == (2, 3) and buffer.dtype == torch.float64
    assert tracing.counters() == {'fleet.pinned_fallbacks': 1}
    landing = fleet.Landing({'x': torch.ones(2, 3)}, (5,))
    landing.land({'x': torch.ones(2, 3)}, 3, bytes_counter='fleet.final_bytes')
    assert tracing.counters() == {'fleet.pinned_fallbacks': 2, 'fleet.final_bytes': 24}


def test_a_fleet_whose_buffers_cannot_be_pinned_is_the_cpu_paths(no_pinning, monkeypatch):
    expected = contents(tiny_fleet('villain', 2))
    monkeypatch.setattr(fused_fleet, 'lands_pinned', lambda shards: True)
    assert_same(contents(tiny_fleet('villain', 2)), expected)
    assert tracing.counters()['fleet.pinned_fallbacks'] > 0
    assert 'fleet.pinned_bytes' not in tracing.counters()


def test_what_the_pinned_cache_pins_anew_is_counted(monkeypatch):
    owned = iter([100, 100 + 4096, 4196, 4196])
    monkeypatch.setattr(torch.cuda, 'host_memory_stats',
                        lambda: {'allocated_bytes.allocated': next(owned)})
    empty = torch.empty
    monkeypatch.setattr(torch, 'empty',
                        lambda *shape, pin_memory=False, **kw: empty(*shape, **kw))
    assert fleet.host_buffer((3,), torch.int32)[1]
    assert fleet.host_buffer((3,), torch.int32)[1]
    assert tracing.counters() == {'fleet.pinned_new_bytes': 4096}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    return torch.device('cuda')


def card_fleet(seed, shards=1):
    return tiny_fleet('villain', shards, device='cuda', seed=seed, N=16, chains=8)


@pytest.mark.cuda
def test_on_the_card_the_columns_and_final_fields_are_page_locked(cuda):
    f = card_fleet(1)
    for v in list(f.columns.values()) + list(f.final.values()):
        assert torch.from_numpy(v).is_pinned()
    counted = tracing.counters()
    assert counted['fleet.pinned_bytes'] == \
        counted['fleet.host_bytes'] + counted['fleet.final_bytes']
    assert 'fleet.pinned_fallbacks' not in counted


@pytest.mark.cuda
def test_on_the_card_a_kept_fleet_is_not_written_by_a_later_call(cuda):
    kept = card_fleet(1)
    saved = contents(kept)
    later = card_fleet(2)
    assert not np.array_equal(later.final['phi'], saved[1]['phi'])
    assert_same(contents(kept), saved)


@pytest.mark.cuda
def test_on_the_card_a_freed_fleets_memory_serves_the_next_call(cuda):
    f = card_fleet(1)
    saved = contents(f)
    del f
    gc.collect()
    pinned_new = tracing.counters()['fleet.pinned_new_bytes']
    again = card_fleet(1)
    assert tracing.counters()['fleet.pinned_new_bytes'] == pinned_new
    assert_same(contents(again), saved)


@pytest.mark.cuda
def test_on_the_card_two_shards_of_one_card_land_the_one_shard_fleet(cuda):
    assert_same(contents(card_fleet(3, shards=2)), contents(card_fleet(3)))
