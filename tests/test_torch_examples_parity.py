"""The port's example scripts against the JAX package's, on the CPU, on the same
arguments: ``end-to-end.py`` (Villain at W=1, and Worldline at W=2) and the
κ-scan ``bkt-scan.py`` (the JAX package's CPU fallback) give estimates within
|pull| < 4 of each other.  Also: ``chip_smoke.py``'s parser of the committed
``results/*.log`` tables reads what the matching ``results/*.h5`` groups hold,
to the printed digits, and importing ``chip_smoke`` does not run it."""

import importlib.util
import math
import pathlib
import runpy
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PULL_BOUND = 4.0


def run(package, script, argv, monkeypatch, run_name='__main__'):
    """Globals of ``script`` of the JAX package (``examples/``) or of the port
    (``supervillain_tpu_torch/examples/``, on the CPU) after a run on ``argv``."""
    where = ROOT / 'examples' if package == 'jax' else ROOT / 'supervillain_tpu_torch' / 'examples'
    argv = [str(a) for a in argv] + (['--device', 'cpu'] if package == 'port' else [])
    monkeypatch.setattr(sys, 'argv', [script] + argv)
    return runpy.run_path(str(where / script), run_name=run_name)


def pull(a, b):
    """(a − b)/√(σ_a² + σ_b²) of two (mean, error) pairs; 0 where both are
    exact and equal."""
    (ma, ea), (mb, eb) = a, b
    if ea == eb == 0:
        return 0.0 if ma == mb else math.inf
    return (float(ma) - float(mb)) / math.hypot(ea, eb)


@pytest.mark.parametrize('argv', [
    ['--N', '4', '--configurations', '1000'],
    ['--action', 'worldline', '--N', '4', '--W', '2', '--configurations', '1000']],
    ids=['villain-W1', 'worldline-W2'])
def test_end_to_end_matches_jax(argv, monkeypatch):
    ours = run('port', 'end-to-end.py', argv, monkeypatch)['b'].estimate('ActionDensity')
    theirs = run('jax', 'end-to-end.py', argv, monkeypatch)['b'].estimate('ActionDensity')
    assert abs(pull(ours, theirs)) < PULL_BOUND, (ours, theirs)


def test_bkt_scan_matches_jax_cpu_fallback(monkeypatch):
    argv = ['--L', '8', '--chains', '16', '--W', '2', '--kappas', '0.6',
            '--therm-sweeps', '100', '--records', '6', '--thin', '8']
    ours = run('port', 'bkt-scan.py', argv, monkeypatch)['results'][0.6]
    # The JAX script discards main()'s value when run as __main__: call it.
    theirs = run('jax', 'bkt-scan.py', argv, monkeypatch, run_name='jax_bkt_scan')['main']()[0.6]
    for name in ('S', 'W2'):
        assert abs(pull(ours[name], theirs[name])) < PULL_BOUND, (name, ours[name], theirs[name])


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location('chip_smoke', ROOT / 'chip_smoke.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_importing_chip_smoke_does_not_run_it(capsys):
    module = load_chip_smoke()
    assert callable(module.main) and callable(module.read_scan_log)
    assert capsys.readouterr() == ('', '')


@pytest.mark.parametrize('log,rows,only', [
    ('bkt-scan-L64', 9, None), ('bkt-scan-W2-L64', 8, None), ('bkt-scan-L256', 9, 0.74)])
def test_log_parser_reads_the_h5_values(log, rows, only):
    """Each parsed (mean, error) equals the h5 group's value printed the way the
    JAX script printed it (Uncertain) and parsed back: the printed digits."""
    h5py = pytest.importorskip('h5py')
    from supervillain_tpu_torch.analysis import Uncertain
    cs = load_chip_smoke()
    table = cs.read_scan_log(ROOT / 'results' / f'{log}.log')
    assert len(table) == rows
    kappas = [only] if only is not None else list(table)
    with h5py.File(ROOT / 'results' / f'{log}.h5', 'r') as f:
        for kappa in kappas:
            group = f[f'kappa_{kappa}']
            for name in cs.SCAN_GATED:
                text = str(Uncertain(*group[name][()]))
                printed = cs.parse_uncertain(cs._UNCERTAIN.fullmatch(text))
                assert table[kappa][name] == printed, (log, kappa, name)


def test_uncertain_parser_forms():
    cs = load_chip_smoke()
    cases = {'+7.1357(23) × 10^-1': (0.71357, 0.00023), '+8.5(3.1)': (8.5, 3.1),
             '+5.2(2.1) × 10^+1': (52.0, 21.0), '+1.0843(38)': (1.0843, 0.0038),
             '(+1.00 ± 10.00) × 10^-1': (0.1, 1.0), '+1.25 × 10^-1': (0.125, 0.0),
             '+2.409(100) × 10^-2': (0.02409, 0.001)}
    for text, expect in cases.items():
        np.testing.assert_allclose(cs.parse_uncertain(cs._UNCERTAIN.fullmatch(text)), expect,
                                   rtol=1e-12)
    fleet = cs.read_fleet_log(ROOT / 'results' / 'pod-fleet.log')
    np.testing.assert_allclose(fleet['ActionDensity'], (0.528097, 0.000020), rtol=1e-12)
    np.testing.assert_allclose(fleet['WindingSquared'], (0.0072371, 0.0000036), rtol=1e-12)


@pytest.mark.parametrize('value', [(8.5, 3.1), (52.0, 21.0), (0.022, 0.011), (0.71357, 0.00023),
                                   (1.0843, 0.0038)])
def test_uncertain_reads_back_what_it_prints(value):
    """The port's Uncertain.from_string reads every form its format writes,
    the one-digit '+8.5(3.1)' included, as chip_smoke's parser does."""
    from supervillain_tpu_torch.analysis import Uncertain
    cs = load_chip_smoke()
    text = str(Uncertain(*value))
    back = Uncertain.from_string(text)
    np.testing.assert_allclose((back.mean, back.uncertainty), value, rtol=1e-12)
    np.testing.assert_allclose(cs.parse_uncertain(cs._UNCERTAIN.fullmatch(text)), value,
                               rtol=1e-12)
