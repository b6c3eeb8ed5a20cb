"""The D=4 Worldline fleet cell (``worldline-fleet-d4-n8-w1``) on the CPU.

At D=4, N=4, 8 chains, 2 records of 2 Hammer steps the program's timed path
comes out ``correct`` against ``reference/worldline_hammer.py``, bit for bit;
it comes out not correct when the coexact update is left out, K2's seed is a
step late, one block's chains are shifted, a worm length is altered, or the
program caps its worms at a few moves (so that worms the reference closes are
rolled back).  The same replay at D=2 matches ``sample_fleet``'s Worldline
Hammer.  The new counts and readers read what the program counts.
"""

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import supervillain_tpu_torch as sv
from perfbench import readings, run
from perfbench.lib import manifest, peaks, program
from perfbench.reference import worldline_hammer
from supervillain_tpu_torch import tracing
from supervillain_tpu_torch.generators import worldline as gworldline
from supervillain_tpu_torch.ops import kernels
from supervillain_tpu_torch.parallel import fleet as fleet_module

CELL = 'worldline-fleet-d4-n8-w1'
#: The cell at a size a test holds.
SHAPE = dict(L=4, chains=8, thin=2, records_per_call=2, check_chains=4)
#: A window that a call of that size completes in on the CPU (about 3 s a call).
SECONDS = 8.0


@pytest.fixture
def d4_on_cpu(card_on_cpu, monkeypatch):
    """The Worldline fields in the card's int32, as ``sample_fleet`` starts them there."""
    from supervillain_tpu_torch.models import worldline

    monkeypatch.setattr(worldline, 'field_dtypes', lambda device: (torch.float32, torch.int32))
    tracing.reset()
    yield
    tracing.reset()


def judged(seed=2 ** 31 + 99):
    """A run of the cell at :data:`SHAPE`; a completed call was checked."""
    result = run.run(CELL, seed, SECONDS, False, device='cpu', overrides=SHAPE)
    assert set(result['checked']) == {'parted_share', 'early_parted_share'}, result['checked']
    return result


def program_call(traffic, seed):
    """One call of the program on the CPU, kept as a run keeps it."""
    _, _, config, _ = manifest.cell(CELL)
    config = dict(config, D=traffic['D'])
    S = program.action(sv, config, traffic)
    window = run.Window(math.inf)
    window.open()
    fleet = program.fleet(sv, S, traffic, seed=seed, steps=traffic['records_per_call'],
                          progress=window.progress, mesh=program.mesh(sv, traffic, 'cpu', 1),
                          device='cpu')
    kept = run.retain(fleet, 0, 11, traffic, window)
    kept['seed'] = seed
    return config, fleet, kept


@pytest.mark.parametrize('D, L', [(4, 4), (2, 8)])
def test_the_reference_replays_the_program_bit_for_bit(d4_on_cpu, D, L):
    _, _, _, traffic = manifest.cell(CELL)
    traffic = dict(traffic, **dict(SHAPE, D=D, L=L))
    config, fleet, kept = program_call(traffic, 2 ** 62 + 5)
    columns, final = run.replay(config, traffic, kept, 'cpu', torch.float32)
    assert set(columns) == set(fleet.columns) == {'Spin_Spin', 'Worm_Length'}
    assert set(final) == set(fleet.final) == {'m', 'v'}
    for k, v in columns.items():
        assert np.array_equal(v, kept['columns'][k]), k
    for k, v in final.items():
        assert np.array_equal(v, kept['final'][k]), k
    assert kept['columns']['Worm_Length'].sum() > 0
    assert columns['Spin_Spin'].shape == (2, 4) + (L,) * D


def test_a_sound_d4_run_is_correct(d4_on_cpu):
    result = judged()
    assert result['correct'] is True, result['checked']
    assert {k: c['value'] for k, c in result['checked'].items()} == {
        'parted_share': 0.0, 'early_parted_share': 0.0}


def coexact_left_out(monkeypatch):
    """The Hammer without its coexact update (nor its draws)."""
    monkeypatch.setattr(gworldline.CoexactUpdate, 'step',
                        lambda self, g, cfg, stats: (cfg, stats, {}))


def worm_seed_a_step_late(monkeypatch):
    """K2's kernel seed is the one drawn for the step before."""
    seed_from, drawn = kernels.seed_from, []

    def late(generator):
        drawn.append(seed_from(generator))
        return drawn[-2] if len(drawn) > 1 else drawn[-1]
    monkeypatch.setattr(kernels, 'seed_from', late)


def last_block_shifted(monkeypatch):
    """The host copies of the fleet's last block of chains each take the next
    chain's rows."""
    host = fleet_module.host
    chains, blocks = SHAPE['chains'], SHAPE['check_chains']
    block = range(chains - chains // blocks, chains)

    def shifted(tensors, bytes_counter=None):
        out = {k: np.array(v) for k, v in host(tensors, bytes_counter).items()}
        for v in out.values():
            if v.ndim and v.shape[0] == chains:
                v[list(block)] = v[list(block[1:]) + [block[0]]]
        return out
    monkeypatch.setattr(fleet_module, 'host', shifted)


def worm_length_altered(monkeypatch):
    """Each step's worm length off by one where it is produced."""
    step = gworldline.ClassicWorm.step

    def altered(self, generator, cfg, stats):
        cfg, stats, inline = step(self, generator, cfg, stats)
        return cfg, stats, inline | {'Worm_Length': inline['Worm_Length'] + 1}
    monkeypatch.setattr(gworldline.ClassicWorm, 'step', altered)


def capped_at_a_few_moves(monkeypatch):
    """The program's fleet cap cut to a few moves, so that it rolls back worms
    that the reference's cap lets close."""
    monkeypatch.setattr(gworldline, 'fleet_worm_cap', lambda lattice: 3)


@pytest.mark.parametrize('fault', [coexact_left_out, worm_seed_a_step_late, last_block_shifted,
                                   worm_length_altered, capped_at_a_few_moves],
                         ids=lambda f: f.__name__)
def test_a_broken_d4_fleet_is_not_correct(fault, d4_on_cpu, monkeypatch):
    fault(monkeypatch)
    result = judged()
    assert result['correct'] is False, result['checked']


def test_the_bfloat16_control_parts_from_the_reference():
    _, _, config, traffic = manifest.cell(CELL)
    traffic = dict(traffic, **SHAPE)
    reading = readings.control_reading(torch, config, traffic, 2 ** 31 + 77, 'cpu')
    for name, limit in traffic['limits'].items():
        assert reading[name] > limit, reading


def test_a_sound_program_reading_parts_no_chain(d4_on_cpu):
    out = readings.main(['--workload', CELL, '--seeds', str(2 ** 31 + 5), '1'], device='cpu',
                        overrides=SHAPE)
    assert out[0]['parted_share'] == out[0]['early_parted_share'] == 0.0, out


def test_the_program_caps_the_worms_as_the_configuration_does():
    for D, N in ((2, 8), (3, 4), (4, 8)):
        lattice = sv.Lattice2D(N) if D == 2 else sv.Lattice(D, N)
        assert gworldline.fleet_worm_cap(lattice) == worldline_hammer.worm_cap(D, N)


def test_the_cell_keeps_its_shape_and_the_traffic_names_its_d():
    entry, config_entry, config, traffic = manifest.cell(CELL)
    assert (entry['config'], entry['chips'], config['D'], traffic['D']) \
        == ('worldline-d4-n8', 1, 4, 4)
    assert (traffic['L'], traffic['kappa'], traffic['W'], traffic['chains'], traffic['thin'],
            traffic['records_per_call'], traffic['check_chains']) == (8, 0.3, 1, 8192, 2, 10, 8)
    assert program.general(traffic) and 'worms' not in traffic
    assert config_entry['reduced'] == config['reduced'] == ['N'] and config['N'] == traffic['L']
    assert config['reference'] == 'worldline_hammer'
    names = {m['name'] for m in manifest.metrics_of(CELL, 'per_layer')}
    assert {'worm.worldline_general_roofline', 'worm.worldline_general.ns_per_move',
            'worm.worldline.truncated_share', 'updates.worldline_roofline', 'fleet.copy_ms',
            'fleet.record_s_p95', 'fleet.readbacks', 'updates.torch_ms', 'record_mfu',
            'device_idle'} == names


def test_k2_and_the_updates_are_counted_from_the_program(d4_on_cpu):
    _, _, _, traffic = manifest.cell(CELL)
    k2, updates = manifest.counts('worm.worldline_general'), manifest.counts('updates.worldline')
    assert k2.count(traffic) is None            # nothing counted yet
    tiny = dict(traffic, **SHAPE)
    with profile(activities=[ProfilerActivity.CPU]):        # the counters count while it records
        _, fleet, _ = program_call(tiny, 7)
    s = fleet.stats['ClassicWorm']
    calls = SHAPE['records_per_call'] * SHAPE['thin']
    nbytes, ops = k2.per_call(tiny)
    assert nbytes == pytest.approx(20 * s['accepted'] / calls + 8 * SHAPE['chains'])
    assert ops == pytest.approx((peaks.PHILOX_OPS + 25 + 3 + 10) * s['accepted'] / calls
                                + (2 * peaks.PHILOX_OPS + 8) * SHAPE['chains'])
    assert k2.count(tiny) == pytest.approx((2 * nbytes, 2 * ops))
    assert k2.matches('void (anonymous namespace)::general_worm_kernel(int*, float const*)')
    assert not k2.matches('void (anonymous namespace)::worm_kernel<true>(int2*)')
    site_steps = 8192 * 8 ** 4 * 2
    assert updates.count(traffic) == (80 * site_steps,
                                      (12 * (peaks.PHILOX_OPS // 2 + 26) + 24) * site_steps)
    assert peaks.bound_by(*updates.count(traffic)) == 'bytes'


class Trace:
    """Stands in for a window's trace: K2's launches, 2 ms each."""

    def __init__(self, launches):
        self._ops = [(0, 'general_worm_kernel', 1000.0 * i, 1000.0 * i + 2000.0)
                     for i in range(launches)]

    def ops(self, match):
        return [op for op in self._ops if match(op[1])]


def test_the_k2_readers_take_per_call_ratios_of_the_counters(d4_on_cpu):
    _, _, _, traffic = manifest.cell(CELL)
    tiny = dict(traffic, **SHAPE)
    ctx = run.Context(Trace(6), [], tiny, [0])
    readers = {name: manifest.reader(name) for name in (
        'worm.worldline_general_roofline', 'worm.worldline_general.ns_per_move',
        'worm.worldline.truncated_share')}
    assert all(r.read(ctx) is None for r in readers.values())     # a program that counts none
    program_call(tiny, 8)
    assert all(r.read(ctx) is None for r in readers.values())     # nor without a profiler
    with profile(activities=[ProfilerActivity.CPU]):
        _, fleet, _ = program_call(tiny, 9)
    counted = tracing.counters()
    calls = counted['worm.worldline.calls']
    longest = counted['worm.worldline.longest'] / calls
    assert readers['worm.worldline_general.ns_per_move'].read(ctx) == pytest.approx(
        1e9 * 6 * 2e-3 / (6 * longest))
    s = fleet.stats['ClassicWorm']
    assert readers['worm.worldline.truncated_share'].read(ctx) == pytest.approx(
        100 * (s['sweeps'] - s['acceptance']) / s['sweeps'])
    least = peaks.least_seconds(*manifest.counts('worm.worldline_general').per_call(tiny))
    assert readers['worm.worldline_general_roofline'].read(ctx) == pytest.approx(
        100 * 6 * least / (6 * 2e-3))
