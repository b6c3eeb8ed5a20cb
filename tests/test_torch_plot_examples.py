"""The port's ``examples/plot/`` scripts on the CPU (matplotlib's Agg backend).

Each of the twelve scripts runs as ``python script`` with its figure under the
test's temporary directory (the sampling ones with ``--device cpu`` and few
configurations) and writes it.  ``w2-analysis.py`` and ``w3-analysis.py`` read
the committed results/bkt-scan-W{2,3}-*.h5 through the port's ``io.read`` and
print what the JAX scripts print, and their κ_c crossings and bands, and the
physics figure's, equal the JAX scripts' functions' to 1e-12.  The committed
results/physics-summary.png is the same afterwards."""

import hashlib
import pathlib
import runpy
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / 'supervillain_tpu_torch' / 'examples' / 'plot'
JAX = ROOT / 'examples' / 'plot'
SUMMARY = ROOT / 'results' / 'physics-summary.png'
SAMPLING = ['--device', 'cpu']
SCRIPTS = {
    'checkerboarding.py': [],
    'comparison.py': SAMPLING + ['--configurations', '200'],
    'forms.py': SAMPLING + ['--configurations', '20'],
    'symmetrize.py': SAMPLING + ['--configurations', '20'],
    'lattice/d0.py': [],
    'lattice/d1.py': [],
    'lattice/delta1.py': [],
    'lattice/delta2.py': [],
    'lattice/layout.py': [],
    'physics-figure.py': [],
}


def digest(path):
    return hashlib.sha256(path.read_bytes()).hexdigest()


SUMMARY_DIGEST = digest(SUMMARY)


def run(script, args, cwd):
    done = subprocess.run([sys.executable, str(script), *args], cwd=cwd, capture_output=True,
                          text=True, timeout=600)
    assert done.returncode == 0, done.stderr
    return done.stdout


@pytest.mark.parametrize('name', sorted(SCRIPTS))
def test_script_writes_its_figure(name, tmp_path):
    figure = tmp_path / (pathlib.Path(name).stem + '.png')
    out = run(PORT / name, SCRIPTS[name] + ['--figure', str(figure)], tmp_path)
    assert f'wrote {figure}' in out
    assert figure.stat().st_size > 1000
    assert digest(SUMMARY) == SUMMARY_DIGEST


def test_physics_figure_needs_its_output_path(tmp_path):
    done = subprocess.run([sys.executable, str(PORT / 'physics-figure.py')], cwd=tmp_path,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode != 0 and '--figure' in done.stderr
    assert digest(SUMMARY) == SUMMARY_DIGEST


@pytest.mark.parametrize('name', ['w2-analysis.py', 'w3-analysis.py'])
def test_analysis_prints_what_the_jax_script_prints(name, tmp_path):
    ours = run(PORT / name, [], tmp_path)
    theirs = run(JAX / name, [], tmp_path)
    assert ours == theirs
    assert 'crossing(' in ours


def _module(path):
    return runpy.run_path(str(path), run_name='module')


def test_w2_crossings_match_jax():
    ours, theirs = _module(PORT / 'w2-analysis.py'), _module(JAX / 'w2-analysis.py')
    assert ours['LS'] == theirs['LS']
    for La, Lb in zip(ours['LS'][:-1], ours['LS'][1:]):
        got, want = [], []
        for g, out in ((ours, got), (theirs, want)):
            data = {L: g['load'](L) for L in (La, Lb)}
            ks = [k for k in sorted(set(data[La]) & set(data[Lb]))]
            out.append(g['crossing_estimate'](np.array(ks), {
                L: np.array([data[L][k]['chi_scaled'][0] for k in ks]) for L in (La, Lb)}))
        assert (got[0] is None) == (want[0] is None)
        if got[0] is not None:
            assert abs(got[0] - want[0]) <= 1e-12


def test_w3_bands_match_jax():
    ours, theirs = _module(PORT / 'w3-analysis.py'), _module(JAX / 'w3-analysis.py')
    a, b = ours['load'](), theirs['load']()
    assert sorted(a) == sorted(b)
    LS = sorted(a)
    for La, Lb in zip(LS[:-1], LS[1:]):
        ks = [k for k in sorted(set(a[La]) | set(a[Lb]))
              if 'chiV_scaled' in a[La].get(k, {}) and 'chiV_scaled' in a[Lb].get(k, {})]
        if len(ks) < 2:
            continue
        bands = []
        for g, data in ((ours, a), (theirs, b)):
            scaled = {L: np.array([data[L][k]['chiV_scaled'][0] for k in ks]) for L in (La, Lb)}
            errs = {L: np.array([data[L][k]['chiV_scaled'][1] for k in ks]) for L in (La, Lb)}
            bands.append(g['crossing_estimate_error'](ks, scaled, errs, draws=4000, pair=(La, Lb)))
        for x, y in zip(*bands):
            assert (x is None) == (y is None)
            if x is not None:
                assert abs(x - y) <= 1e-12, (La, Lb, bands)


def test_physics_figure_bands_match_jax():
    ours, theirs = _module(PORT / 'physics-figure.py'), _module(JAX / 'physics-figure.py')
    for pattern, channel in (('bkt-scan-W2-L*.h5', 'chi_scaled'),
                             ('bkt-scan-W3-L*.h5', 'chiV_scaled')):
        a, b = ours['load_channel'](pattern, channel), theirs['load_channel'](pattern, channel)
        assert a == b
        for pair in ((128, 256), (256, 512)):
            if pair[0] in a and pair[1] in a:
                x, y = ours['kc_band'](a, pair), theirs['kc_band'](b, pair)
                assert (x is None) == (y is None)
                if x is not None:
                    assert np.max(np.abs(np.subtract(x, y))) <= 1e-12
    assert digest(SUMMARY) == SUMMARY_DIGEST
