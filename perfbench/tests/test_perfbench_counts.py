"""The kernels' counts: the sweeps' bounds of the card's smoke run, and worms
counted by the moves their walks take."""

import pytest

from perfbench.lib import manifest, peaks

MAIN = {'L': 256, 'chains': 512, 'thin': 50, 'worms': 1}


@pytest.mark.parametrize('kernel, ms', [('sweep.villain', 6.059830256716418),
                                        ('sweep.worldline', 6.61072391641791)])
def test_the_sweeps_reproduce_the_smoke_runs_bounds(kernel, ms):
    nbytes, ops = manifest.counts(kernel).count(MAIN)
    assert peaks.least_seconds(nbytes, ops) * 1e3 == pytest.approx(ms, rel=1e-12)
    assert peaks.bound_by(nbytes, ops) == 'operations'


@pytest.mark.parametrize('kernel', ['worm.villain', 'worm.worldline'])
def test_a_worm_is_counted_by_its_moves_not_by_its_lattice(kernel):
    count = manifest.counts(kernel).count
    small = count(dict(MAIN, L=64), {'moves': 1e6})
    large = count(dict(MAIN, L=1024), {'moves': 1e6})
    assert small == large                       # no copy of the field, no memset
    more = count(MAIN, {'moves': 2e6})
    assert more[0] - small[0] == pytest.approx(24e6) and more[1] > small[1]
    assert count(MAIN, {'seconds': 1.0}) is None     # moves unknown: nothing counted


def test_the_chunked_worm_counts_64_moves_a_chain_a_step_whatever_the_lattice():
    count = manifest.counts('worm.villain_chunked').count
    fleet = dict(MAIN, thin=4)
    moves = 64 * 512 * 4
    assert count(fleet) == (24 * moves + 48 * 512 * 4, (peaks.PHILOX_OPS + 25) * moves)
    assert count(dict(fleet, L=1024)) == count(fleet) == count(fleet, {'seconds': 1.0})
    assert count(dict(fleet, thin=8))[0] == 2 * count(fleet)[0]
    assert peaks.bound_by(*count(fleet)) == 'bytes'


def test_the_generic_updates_count_a_pass_over_phi_and_n_a_site_a_step():
    count = manifest.counts('updates.villain').count
    fleet = dict(MAIN, thin=4)
    site_steps = 512 * 256 ** 2 * 4
    assert count(fleet) == (24 * site_steps, (2 * peaks.PHILOX_OPS + 42) * site_steps)
    assert count(dict(fleet, L=512))[0] == 4 * count(fleet)[0]
    assert count(fleet, {'seconds': 1.0}) == count(fleet)
    assert peaks.bound_by(*count(fleet)) == 'bytes'


@pytest.mark.parametrize('kernel, name, hit', [
    ('sweep.villain', '(anonymous namespace)::resident_sweeps(float const*, int)', True),
    ('sweep.villain', 'void (anonymous namespace)::color_pass_slab(float*)', False),
    ('worm.villain', '(anonymous namespace)::worm_kernel(float const*, int*)', True),
    ('worm.villain', 'void (anonymous namespace)::worm_kernel<true>(int2*)', False),
    ('worm.worldline', 'void (anonymous namespace)::worm_kernel<true>(int2*)', True),
    ('sweep.worldline', 'void (anonymous namespace)::plaquette_pass<true, int>(int*)', True),
    ('sweep.worldline', 'Memcpy DtoH (Device -> Pageable)', False),
    ('worm.villain_chunked',
     'void (anonymous namespace)::chunked_worm_kernel(float const*, int*, int const*)', True),
    ('worm.villain_chunked', '(anonymous namespace)::worm_kernel(float const*, int*)', False),
    ('worm.villain', 'void (anonymous namespace)::chunked_worm_kernel(float const*, int*)', False),
    ('updates.villain',
     'void at::native::vectorized_elementwise_kernel<4, at::native::AddFunctor<float> >(int)',
     True),
    ('updates.villain', 'void at::native::roll_cuda_kernel<float>(float const*, float*)', True),
    ('updates.villain',
     'void (anonymous namespace)::chunked_worm_kernel(float const*, int*, int const*)', False),
    ('updates.villain', 'Memcpy DtoD (Device -> Device)', False),
])
def test_kernels_are_found_by_name(kernel, name, hit):
    assert manifest.counts(kernel).matches(name) is hit
