"""The port's spans and counters (``supervillain_tpu_torch.tracing``).

On the CPU: a tiny fused fleet under a CPU-only ``torch.profiler`` leaves the
fleet driver's spans in the exported trace, nested as the fleet driver nests
them; with no profiler nothing is recorded and B1 is not asked for its
cycles; the counters count what the fleet driver copies and waits for.  The
tests marked ``cuda`` need a card:

    python -m pytest --noconftest -o addopts='' -m cuda tests/test_torch_tracing.py -q
"""

import contextlib
import ctypes
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import supervillain_tpu_torch as tsv
from supervillain_tpu_torch import tracing
from supervillain_tpu_torch.ops import kernels, sweep
from supervillain_tpu_torch.parallel import chain_mesh, fleet

#: Each span of the fleet driver and the spans it may lie in.
PARENTS = {'fleet.call': {None}, 'fleet.init': {'fleet.call'}, 'fleet.record': {'fleet.call'},
           'fleet.launch': {'fleet.record'}, 'fleet.wait': {'fleet.record'},
           'fleet.copy': {'fleet.record', 'fleet.final', 'fleet.finish'},
           'fleet.store': {'fleet.record'}, 'fleet.finish': {'fleet.call'},
           'fleet.final': {'fleet.finish'}, 'fleet.gather': {'fleet.finish'}}
STEPS = 2


@pytest.fixture(autouse=True)
def fresh_counters():
    tracing.reset()
    yield
    tracing.reset()


def tiny_fleet(mesh=None):
    S = tsv.Villain(tsv.Lattice2D(8), 0.5, W=1)
    return tsv.sample_fused_fleet(S, chains=4, steps=STEPS, thin=1, worms=1, mesh=mesh,
                                  device='cpu')


def spans_of(trace_file):
    """(name, start, end) of the program's spans in an exported trace."""
    events = json.loads(trace_file.read_text())['traceEvents']
    return [(e['name'], float(e['ts']), float(e['ts']) + float(e['dur'])) for e in events
            if e.get('ph') == 'X' and e.get('cat') == 'user_annotation'
            and e['name'].startswith('fleet.')]


def parent(span, spans):
    """The name of the shortest other span that holds ``span``, or None."""
    name, start, end = span
    holders = [s for s in spans if s is not span and s[1] <= start and end <= s[2]]
    return min(holders, key=lambda s: s[2] - s[1])[0] if holders else None


@pytest.mark.parametrize('shards', [1, 2])
def test_the_fleet_drivers_spans_land_in_the_trace_nested(shards, tmp_path):
    mesh = None if shards == 1 else chain_mesh(['cpu'] * shards)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tiny_fleet(mesh)
    prof.export_chrome_trace(str(tmp_path / 'trace.json'))
    spans = spans_of(tmp_path / 'trace.json')
    names = [s[0] for s in spans]
    assert set(names) == set(PARENTS)
    for s in spans:
        assert parent(s, spans) in PARENTS[s[0]], s
    assert names.count('fleet.call') == 1 and names.count('fleet.record') == STEPS
    assert names.count('fleet.launch') == names.count('fleet.wait') == STEPS * shards
    # A copy a shard a record, then the stats' and the final fields' a shard.
    assert names.count('fleet.copy') == (STEPS + 2) * shards


def test_without_a_profiler_no_span_is_made(monkeypatch):
    made = []
    monkeypatch.setattr(torch.profiler, 'record_function',
                        lambda name: made.append(name) or contextlib.nullcontext())
    assert not tracing.recording()
    tiny_fleet(chain_mesh(['cpu'] * 2))
    assert made == []
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.recording()
        tiny_fleet()
    assert made.count('fleet.record') == STEPS


class FakeLibrary:
    """B1's C entry point in the CPU's memory: notes the ``cycles`` pointer it
    is given and writes 1 waited and 10 cycles in all for every block."""

    def __init__(self):
        self.pointers = []

    def sv_sweeps_resident(self, *args):
        pointer, blocks = args[6], args[7] * args[-5]
        self.pointers.append(pointer)
        if pointer is not None:
            (ctypes.c_int64 * (2 * blocks)).from_address(pointer)[:] = [1, 10] * blocks
        return 0


def test_b1_is_asked_for_its_cycles_only_while_a_profiler_records(monkeypatch):
    lib = FakeLibrary()
    monkeypatch.setattr(kernels, 'library', lambda: lib)
    monkeypatch.setattr(kernels, 'require_fields', lambda phi, n: (phi.shape[0], phi.shape[-1]))
    monkeypatch.setattr(kernels, 'stream_handle', lambda device: 0)
    monkeypatch.setattr(torch.cuda, 'device', lambda device: contextlib.nullcontext())
    plan = sweep.SweepPlan('resident', 2, 4, 32, 0)
    B, N = 3, 8

    def call():
        phi, n = torch.zeros((B, 1, N, N)), torch.zeros((B, 2, N, N), dtype=torch.int32)
        return sweep.kernel_sweeps(phi, n, plan, kappa=0.5, W=1, interval_phi=1.0,
                                   interval_n=1, sweeps=1,
                                   generator=torch.Generator().manual_seed(0))

    call()
    assert lib.pointers == [None] and tracing.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        call()
        call()
    assert lib.pointers[1] is not None and lib.pointers[2] is not None
    assert tracing.counters() == {'sweep.villain.barrier_cycles': 2 * B * plan.cluster,
                                  'sweep.villain.cycles': 20 * B * plan.cluster}


def test_the_host_bytes_are_the_records_columns():
    f = tiny_fleet(chain_mesh(['cpu'] * 2))
    counted = tracing.counters()
    assert counted['fleet.records'] == STEPS
    assert counted['fleet.host_bytes'] == sum(v.nbytes for v in f.columns.values())
    assert counted['fleet.final_bytes'] == sum(v.nbytes for v in f.final.values())
    assert 'fleet.syncs' not in counted             # no card, no wait on one


class CardTensor:
    """A tensor on a card, as far as :func:`fleet.host` looks."""
    is_cuda = True

    def __init__(self, values):
        self.values = values

    def cpu(self):
        return self.values


class Stream:
    """A card's stream, as far as :func:`fleet.wait` looks: notes its waits."""

    def __init__(self, device, waited):
        self.device, self.waited = device, waited

    def synchronize(self):
        self.waited.append(self.device)


def test_each_copy_from_a_card_and_each_wait_on_one_is_a_sync(monkeypatch):
    waited = []
    monkeypatch.setattr(torch.cuda, 'current_stream', lambda device: Stream(device, waited))
    out = fleet.host({'a': CardTensor(torch.ones(3)), 'b': torch.ones(2, dtype=torch.int64)},
                     'fleet.host_bytes')
    assert np.array_equal(out['a'], np.ones(3, dtype=np.float32))
    fleet.wait(torch.device('cuda', 1))
    fleet.wait(torch.device('cpu'))
    assert waited == [torch.device('cuda', 1)]
    assert tracing.counters() == {'fleet.syncs': 2, 'fleet.host_bytes': 12 + 16}


def test_the_logger_sends_the_step_time_and_inline_values_in_a_span():
    S = tsv.Villain(tsv.Lattice2D(4), 0.5, W=1)
    got = []
    logged = tsv.Logger(tsv.FusedHammer(S), channel=got.append)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tsv.Ensemble(S).generate(2, logged, device='cpu')
    times = [m for m in got if isinstance(m, str)]
    inline = [m for m in got if isinstance(m, dict)]
    assert len(times) == len(inline) == 2 and all('seconds]' in m for m in times)
    assert all(set(m) == set(logged.inline_shapes()) for m in inline)
    assert sum(e.name == 'Logger.step' for e in prof.events()) == 2
    silent = tsv.Logger(tsv.FusedHammer(S), channel=None, timer=False)
    tsv.Ensemble(S).generate(1, silent, device='cpu')


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    return torch.device('cuda')


@pytest.mark.cuda
def test_on_the_card_b1s_barrier_share_is_read_and_the_fields_are_unchanged(cuda):
    B, N = 512, 256
    phi = torch.zeros((B, 1, N, N), dtype=torch.float32, device=cuda)
    n = torch.zeros((B, 2, N, N), dtype=torch.int32, device=cuda)

    def call():
        return sweep.neighborhood_sweeps(phi, n, kappa=0.5, W=1, interval_phi=np.pi,
                                         interval_n=1, sweeps=5,
                                         generator=torch.Generator().manual_seed(7))

    untraced = call()
    assert 'sweep.villain.cycles' not in tracing.counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        traced = call()
    for a, b in zip(untraced[:3], traced[:3]):
        assert torch.equal(a, b)
    counted = tracing.counters()
    share = 100 * counted['sweep.villain.barrier_cycles'] / counted['sweep.villain.cycles']
    assert 0 < share < 100


@pytest.mark.cuda
def test_on_the_card_a_record_waits_once_a_shard_and_once_a_column(cuda):
    S = tsv.Villain(tsv.Lattice2D(8), 0.5, W=1)
    f = tsv.sample_fused_fleet(S, chains=8, steps=STEPS, thin=1, worms=1,
                               mesh=chain_mesh(['cuda:0'] * 2))
    shards = 2
    # The copies land in page-locked columns and wait on nothing: a wait a
    # shard a record, and a wait a shard for the final fields and the stats.
    assert len(f.columns) > 1
    assert tracing.counters()['fleet.syncs'] == STEPS * shards + shards
