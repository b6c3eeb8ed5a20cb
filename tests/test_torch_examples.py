"""The port's example scripts (``supervillain_tpu_torch/examples/``) run end to
end on the CPU with ``--device cpu``, through the plain PyTorch versions of the
kernels: each at the arguments of ``tests/test_examples_smoke.py``, and the
three scripts that return early on a CPU in the JAX package (``winf-line.py``,
``pod-fleet.py``, ``self-dual-fused.py``) at toy sizes.  Without a card and
without ``--device`` each script raises; none falls back to the CPU.  The
figures (matplotlib) and h5 files (h5py) are written only when asked for, and
the κ-scan refuses to append to a file written with another configuration."""

import pathlib
import runpy
import sys

import numpy as np
import pytest
import torch

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / 'supervillain_tpu_torch' / 'examples'

#: Toy arguments of the three scripts that are card workloads in the JAX package.
TOY = {
    'winf-line.py': ['--Ls', '8', '16', '--kappas', '0.3183098861837907', '--chains', '4',
                     '--records', '4', '--therm-factor', '1'],
    'pod-fleet.py': ['--L', '8', '--chains', '4', '--therm', '32', '--steps', '8', '--thin', '4'],
    'self-dual-fused.py': ['--L', '8', '--chains', '4', '--therm-factor', '1', '--records', '4'],
}

#: (script, argv) at the arguments of tests/test_examples_smoke.py, and TOY.
SMOKE = [
    ('end-to-end.py', ['--N', '4', '--configurations', '200']),
    ('end-to-end.py', ['--action', 'worldline', '--N', '4', '--W', '2', '--configurations', '200']),
    ('end-to-end.py', ['--N', '4', '--W', 'inf', '--configurations', '150']),
    ('action-comparison.py', ['--N', '4', '--configurations', '300']),
    ('villain-algorithm-comparison.py', ['--N', '4', '--configurations', '200']),
    ('worldline-algorithm-comparison.py', ['--N', '4', '--configurations', '200']),
    ('no-vortices.py', ['--N', '5', '--configurations', '300', '--h5', '{tmp}/nv.h5']),
    ('why-measure-inline.py', ['--N', '4', '--configurations', '200']),
    ('fleet-scan.py', ['--N', '4', '--chains', '8', '--steps', '10', '--cut', '2',
                       '--kappas', '0.5', '--h5', '{tmp}/fleet.h5']),
    ('bkt-scan.py', ['--L', '8', '--chains', '4', '--therm-sweeps', '20', '--records', '3',
                     '--thin', '4', '--kappas', '0.6', '--W', '2']),
    ('d4-topology.py', ['--N', '3', '--chains', '4', '--steps', '6', '--cut', '2',
                        '--kappas', '0.4', '--h5', '{tmp}/d4.h5']),
] + list(TOY.items())

SCRIPTS = sorted({script for script, _ in SMOKE})


def run_script(name, argv, monkeypatch):
    monkeypatch.setattr(sys, 'argv', [name] + [str(a) for a in argv])
    return runpy.run_path(str(EXAMPLES / name), run_name='__main__')


def test_every_script_is_ported():
    assert len(SCRIPTS) == 12
    assert sorted(p.name for p in EXAMPLES.glob('*.py')) == SCRIPTS


@pytest.mark.parametrize('script,argv', SMOKE, ids=[f'{s}-{i}' for i, (s, _) in enumerate(SMOKE)])
def test_script_runs_on_the_cpu(script, argv, tmp_path, monkeypatch, capsys):
    argv = [a.format(tmp=tmp_path) for a in argv]
    g = run_script(script, argv + ['--device', 'cpu'], monkeypatch)
    out = capsys.readouterr().out
    assert out.strip()
    if '--h5' in argv:
        assert pathlib.Path(argv[argv.index('--h5') + 1]).stat().st_size > 0
    pulls = list(g.get('pulls', {}).values()) + list(g.get('correlator_pulls', []))
    assert np.isfinite(pulls).all()


@pytest.mark.parametrize('script', SCRIPTS)
def test_script_without_a_card_raises(script, monkeypatch):
    """The default device is the card: without one, the first call that needs
    it raises and names the CPU way out; nothing runs on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default runs there')
    argv = dict((s, a) for s, a in SMOKE)[script]
    argv = [a for a in argv if '{tmp}' not in a and a != '--h5']
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_script(script, argv, monkeypatch)


@pytest.mark.parametrize('script,flag,suffix', [
    ('end-to-end.py', '--figure', 'png'), ('action-comparison.py', '--figure', 'pdf'),
    ('worldline-algorithm-comparison.py', '--figure', 'png'),
    ('why-measure-inline.py', '--figure', 'png'), ('no-vortices.py', '--pdf', 'pdf')])
def test_figure_is_drawn_when_asked_for(script, flag, suffix, tmp_path, monkeypatch):
    import matplotlib
    matplotlib.use('Agg')
    path = tmp_path / f'figure.{suffix}'
    # A Worldline chain: at N=4 a short Villain chain's WindingSquared does not
    # fluctuate, and the figure's autocorrelation time needs it to.
    action = ['--action', 'worldline', '--W', '2'] if script == 'end-to-end.py' else []
    run_script(script, action + ['--N', '4', '--configurations', '120', flag, path,
                                 '--device', 'cpu'], monkeypatch)
    assert path.stat().st_size > 1000


def test_no_h5_means_no_cache(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    run_script('no-vortices.py', ['--N', '4', '--configurations', '120', '--device', 'cpu'],
               monkeypatch)
    assert 'no --h5 given' in capsys.readouterr().out
    assert list(tmp_path.iterdir()) == []


def test_h5_without_h5py_raises(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, 'h5py', None)       # as on a machine without h5py
    with pytest.raises(RuntimeError, match='h5py'):
        run_script('bkt-scan.py', ['--L', '8', '--chains', '4', '--therm-sweeps', '4',
                                   '--records', '2', '--thin', '2', '--kappas', '0.6',
                                   '--h5', tmp_path / 's.h5', '--device', 'cpu'], monkeypatch)


def scan(path, monkeypatch, chains=4, thin=4, kappa=0.6):
    return run_script('bkt-scan.py', ['--L', '8', '--chains', chains, '--therm-sweeps', '8',
                                      '--records', '2', '--thin', thin, '--kappas', kappa,
                                      '--W', '2', '--h5', path, '--device', 'cpu'], monkeypatch)


def test_scan_stores_its_config_and_refuses_another(tmp_path, monkeypatch):
    import h5py
    path = tmp_path / 'scan.h5'
    scan(path, monkeypatch)
    with h5py.File(path, 'r') as f:
        assert dict(f.attrs) == {'L': 8, 'chains': 4, 'W': 2, 'worms': 1, 'therm_sweeps': 8,
                                 'thin': 4, 'records': 2, 'p_n': 0.05, 'bootstraps': 100}
        assert list(f) == ['kappa_0.6']
    for other in ({'chains': 8}, {'thin': 2}):
        with pytest.raises(ValueError, match='another file'):
            scan(path, monkeypatch, **other)
    scan(path, monkeypatch, kappa=0.7)       # the same configuration appends
    with h5py.File(path, 'r') as f:
        assert list(f) == ['kappa_0.6', 'kappa_0.7'] and f.attrs['chains'] == 4
        assert np.isfinite(f['kappa_0.7/S'][()]).all()


def test_scan_refuses_a_file_without_config(tmp_path, monkeypatch):
    import h5py
    path = tmp_path / 'old.h5'
    with h5py.File(path, 'w') as f:
        f.create_group('kappa_0.5')['S'] = [0.5, 0.01]
    with pytest.raises(ValueError, match='unknown'):
        scan(path, monkeypatch)
