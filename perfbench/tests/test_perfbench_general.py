"""The harness on ``sample_fleet``: the general-fleet cell's timed path broken
underneath comes out not correct; a one-card cell keeps to one card; a D=4
configuration goes through the harness without an edit; and the fused cells'
calls are what they were."""

import math

import numpy as np
import pytest
import torch

import supervillain_tpu_torch as sv
from perfbench import run
from perfbench.lib import manifest, program
from perfbench.tests.conftest import TINY
from supervillain_tpu_torch.generators import combining
from supervillain_tpu_torch.generators import villain as gvillain
from supervillain_tpu_torch.ops import kernels
from supervillain_tpu_torch.parallel import fleet as fleet_module

CELL = 'villain-fleet-l256-w1'


def judged(seed=2 ** 31 + 99):
    return run.run(CELL, seed, 3.0, False, device='cpu', overrides=TINY[CELL])


def exact_left_out(monkeypatch):
    """The Hammer without its exact update (nor its draws)."""
    monkeypatch.setattr(gvillain.ExactUpdate, 'step', lambda self, g, cfg, stats: (cfg, stats, {}))


def returns_its_input(monkeypatch):
    """Every Hammer step returns the state it was given (its inline columns as computed)."""
    step = combining.Sequentially.step

    def unchanged(self, generator, cfg, stats):
        _, stats, inline = step(self, generator, cfg, stats)
        return cfg, stats, inline
    monkeypatch.setattr(combining.Sequentially, 'step', unchanged)


def last_block_shifted(monkeypatch):
    """The host copies of the fleet's last block of chains (one of the blocks
    the checked chains are drawn from) each take the next chain's rows."""
    host = fleet_module.host
    chains, blocks = TINY[CELL]['chains'], TINY[CELL]['check_chains']
    block = range(chains - chains // blocks, chains)

    def shifted(tensors, bytes_counter=None):
        out = {k: np.array(v) for k, v in host(tensors, bytes_counter).items()}
        for v in out.values():
            if v.ndim and v.shape[0] == chains:
                v[list(block)] = v[list(block[1:]) + [block[0]]]
        return out
    monkeypatch.setattr(fleet_module, 'host', shifted)


def worm_seed_out_of_order(monkeypatch):
    """K1's kernel seed is the one drawn for the step before."""
    seed_from, drawn = kernels.seed_from, []

    def late(generator):
        drawn.append(seed_from(generator))
        return drawn[-2] if len(drawn) > 1 else drawn[-1]
    monkeypatch.setattr(kernels, 'seed_from', late)


def worm_length_altered(monkeypatch):
    """An answer altered where it is produced: each step's worm length off by one."""
    step = gvillain.ChunkedWorm.step

    def altered(self, generator, cfg, stats):
        cfg, stats, inline = step(self, generator, cfg, stats)
        return cfg, stats, inline | {'Worm_Length': inline['Worm_Length'] + 1}
    monkeypatch.setattr(gvillain.ChunkedWorm, 'step', altered)


@pytest.mark.parametrize('fault', [exact_left_out, returns_its_input, last_block_shifted,
                                   worm_seed_out_of_order, worm_length_altered],
                         ids=lambda f: f.__name__)
def test_a_broken_general_fleet_is_not_correct(fault, card_on_cpu, monkeypatch):
    fault(monkeypatch)
    result = judged()
    assert result['correct'] is False, result['checked']


def test_one_blocks_chains_shifted_part_that_blocks_share_at_once(card_on_cpu, monkeypatch):
    last_block_shifted(monkeypatch)
    checked = judged()['checked']
    assert checked['early_parted_share']['value'] == 1 / TINY[CELL]['check_chains'], checked


def test_a_one_card_cell_gets_one_device_where_several_cards_are_visible(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 4)
    entry, _, _, traffic = manifest.cell(CELL)
    mesh = program.mesh(sv, traffic, 'cuda', entry['chips'])
    assert entry['chips'] == 1
    assert mesh.devices == (torch.device('cuda', 0),) and mesh.size == 1
    # What sample_fleet would have taken without it: every visible card.
    assert fleet_module.default_mesh(torch.device('cuda')).size == 4
    # A cell that asked for four cards would get them.
    assert program.mesh(sv, traffic, 'cuda', 4).devices == tuple(
        torch.device('cuda', c) for c in range(4))


def worldline_d4():
    config = {'name': 'worldline-d4', 'action': 'Worldline', 'reference': 'worldline', 'D': 4}
    traffic = {'driver': 'sample_fleet', 'L': 4, 'kappa': 0.3, 'W': 1, 'chains': 4, 'thin': 1,
               'records_per_call': 2, 'check_chains': 2}
    return config, traffic


def test_a_d4_worldline_hammer_goes_through_the_harness_unedited():
    config, traffic = worldline_d4()
    assert config['name'] not in {c['name'] for c in manifest.manifest()['configs']}
    S = program.action(sv, config, traffic)
    assert isinstance(S, sv.Worldline) and S.Lattice.D == 4 and S.Lattice.N == 4
    window = run.Window(math.inf)
    window.open()
    fleet = program.fleet(sv, S, traffic, seed=2 ** 31 + 3, steps=2, progress=window.progress,
                          mesh=program.mesh(sv, traffic, 'cpu', 1), device='cpu')
    assert fleet.mesh['size'] == 1 and fleet.chains == 4 and len(window.records) == 2
    assert fleet.columns['Spin_Spin'].shape == (2, 4) + (4,) * 4
    kept = run.retain(fleet, 0, 7, traffic, window)
    assert len(kept['chains']) == 2 and 'moves' not in window.records[0]
    metrics = run.end_to_end(window.records, 2.0, 1.0, config, traffic, CELL)
    assert metrics['site_updates_per_s']['value'] == 4 * 4 ** 4 * 1 * 2 / 2.0
    assert metrics['setup_s']['value'] == 1.0


class Recorder:
    """Stands in for the program: records what the fused fleet is called with."""

    Lattice, Lattice2D, Villain, Worldline = sv.Lattice, sv.Lattice2D, sv.Villain, sv.Worldline

    def sample_fused_fleet(self, S, **kwargs):
        self.call = (S, kwargs)


#: The fused cells' calls as the harness made them before ``sample_fleet`` cells:
#: (worms, cap, the proposal widths that the traffic passes).
FUSED = {
    'villain-l256-w1': (1, 64 * 256 ** 2, {'interval_phi': math.pi, 'interval_n': 1, 'p_n': None}),
    'worldline-l256-w2': (1, 64 * 256 ** 2, {}),
    'villain-l1024-w2': (1, 64 * 1024 ** 2, {'interval_phi': math.pi, 'interval_n': 1,
                                             'p_n': None}),
    'villain-pod-l64-4card': (0, None, {'interval_phi': 0.7, 'interval_n': 1, 'p_n': 0.05}),
}


@pytest.mark.parametrize('cell', sorted(FUSED))
def test_the_fused_cells_calls_are_unchanged(cell):
    _, _, config, traffic = manifest.cell(cell)
    S = program.action(sv, config, traffic)
    assert type(S.Lattice) is sv.Lattice2D and S.Lattice.N == traffic['L']
    assert (S.kappa, S.W) == (traffic['kappa'], traffic['W'])
    if traffic.get('mesh') is None:
        assert program.mesh(sv, traffic, 'cuda', 1) is None
    fake = Recorder()
    hook = object()
    program.fleet(fake, S, traffic, seed=2 ** 40 + 1, steps=3, progress=hook, mesh='mesh',
                  device='cuda')
    worms, cap, extra = FUSED[cell]
    assert fake.call == (S, dict(chains=traffic['chains'], steps=3, thin=traffic['thin'],
                                 seed=2 ** 40 + 1, worms=worms, max_worm_moves=cap,
                                 keep_fields=False, progress=hook, mesh='mesh', device='cuda',
                                 **extra))
    line = run.end_to_end([{'seconds': 0.5}] * 3, 1.5, 2.0, config, traffic, cell)
    su = traffic['chains'] * traffic['L'] ** 2 * traffic['thin'] * 3 / 1.5
    assert line['site_updates_per_s']['value'] == su


def test_the_general_cell_leaves_the_fused_keys_out():
    """Under a harness that knows only the fused fleet, the cell stops at once."""
    _, _, _, traffic = manifest.cell(CELL)
    assert 'worms' not in traffic and program.general(traffic)


def test_the_reference_replays_the_program_bit_for_bit(card_on_cpu):
    """A sound program and the reference agree on every column and field."""
    _, _, config, traffic = manifest.cell(CELL)
    traffic = dict(traffic, **TINY[CELL])
    S = program.action(sv, config, traffic)
    window = run.Window(math.inf)
    window.open()
    fleet = program.fleet(sv, S, traffic, seed=2 ** 62 + 5, steps=3, progress=window.progress,
                          mesh=program.mesh(sv, traffic, 'cpu', 1), device='cpu')
    kept = run.retain(fleet, 0, 11, traffic, window)
    kept['seed'] = 2 ** 62 + 5
    columns, final = run.replay(config, traffic, kept, 'cpu', torch.float32)
    assert set(columns) == set(fleet.columns) and set(final) == set(fleet.final)
    for k, v in columns.items():
        assert np.array_equal(v, kept['columns'][k]), k
    for k, v in final.items():
        assert np.array_equal(v, kept['final'][k]), k
