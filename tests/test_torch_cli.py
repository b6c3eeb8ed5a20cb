"""The port's command-line tier against the JAX package's, on the CPU: the ``W``
type, ``ArgumentParser`` with its metadata and logging flags, the log format
presets, ``input_file`` and ``python -m supervillain_tpu_torch``.  Also: no
module of the port and nothing of ``chip_smoke.py`` imports JAX or the JAX
package."""

import argparse
import logging
import pathlib
import re
import subprocess
import sys

import pytest

from supervillain_tpu import cli as jcli
from supervillain_tpu_torch import cli as tcli
from supervillain_tpu_torch import license as tlicense
from supervillain_tpu_torch import meta as tmeta

ROOT = pathlib.Path(__file__).resolve().parents[1]


def outcome(call):
    """('value', v) of a call, or ('error', type, message) of what it raised."""
    try:
        return ('value', call())
    except Exception as e:       # the comparison is the point: any error, both sides
        return ('error', type(e), str(e))


@pytest.mark.parametrize('text', ['1', '2', '3', 'inf', 'Inf', 'infinity', '∞', '0', '-2', 'x',
                                  'banana'])
def test_W_matches_jax(text):
    assert outcome(lambda: tcli.W(text)) == outcome(lambda: jcli.W(text))


def parse(cli, argv, capsys):
    """(namespace or exit code, stdout) of parsing ``argv`` with a fresh parser."""
    parser = cli.ArgumentParser(description='test')
    parser.add_argument('--N', type=int, default=5)
    parser.add_argument('--W', type=cli.W, default=1)
    try:
        result = vars(parser.parse_args(argv))
    except SystemExit as e:
        result = ('exit', e.code)
    return result, capsys.readouterr()


ARGV = [[], ['--N', '7'], ['--W', '2'], ['--W', 'inf'], ['--W', '∞'], ['--W', '0'], ['--W', 'x'],
        ['--log-level', 'INFO'], ['--log-level', 'DEBUG', '--log-format', 'plain'],
        ['--log-format', 'json'], ['--log-format', '%(levelname)s|%(message)s'],
        ['--log-level', 'LOUD'], ['--version'], ['--license'], ['--bogus']]


@pytest.mark.parametrize('argv', ARGV, ids=lambda a: ' '.join(a) or 'none')
def test_argument_parser_matches_jax(argv, capsys):
    root = logging.getLogger()
    saved = root.level, list(root.handlers)
    try:
        theirs, theirs_out = parse(jcli, argv, capsys)
        ours, ours_out = parse(tcli, argv, capsys)
    finally:
        root.setLevel(saved[0])
        root.handlers = saved[1]
    assert ours == theirs
    assert ours_out.out == theirs_out.out
    # argparse's usage line names the program; the message after it must agree.
    assert ours_out.err.splitlines()[-1:] == theirs_out.err.splitlines()[-1:]


def test_copyright_names_the_port(capsys):
    for cli, name in ((jcli, 'supervillain-tpu '), (tcli, 'supervillain-tpu-torch ')):
        with pytest.raises(SystemExit) as e:
            cli.ArgumentParser(description='t').parse_args(['--copyright'])
        assert e.value.code == 0
        text = capsys.readouterr().out
        assert text.startswith(name) and 'MIT License' in text
    assert tlicense.license().strip() == (ROOT / 'LICENSE').read_text().strip()
    assert tlicense._MIT.strip() == (ROOT / 'LICENSE').read_text().strip()


def test_log_format_presets_match_jax():
    record = logging.LogRecord('test', logging.INFO, __file__, 1, 'hello %s', ('x',), None)
    assert sorted(tcli.log.FORMATS) == sorted(jcli.log.FORMATS)
    for preset in list(tcli.log.FORMATS) + ['%(levelname)s|%(message)s']:
        if preset in ('detailed', 'timed', 'json'):
            record.created = 0.0          # the same time stamp on both sides
        ours, theirs = tcli.log.formatter(preset), jcli.log.formatter(preset)
        assert ours.format(record) == theirs.format(record)


def test_input_file_loads_module(tmp_path):
    path = tmp_path / 'config.py'
    path.write_text('import supervillain_tpu_torch as sv\n'
                    'L = sv.Lattice2D(4)\n'
                    'S = sv.Villain(L, 0.5, W=1)\n')
    module = tcli.input_file(str(path))
    assert module.L.N == 4 and module.S.kappa == 0.5


@pytest.mark.parametrize('flag,expect', [
    ('--version', tmeta.version), ('--license', 'MIT License'), ('', 'NVIDIA GPU')])
def test_module_entry_point(flag, expect):
    argv = [sys.executable, '-m', 'supervillain_tpu_torch'] + ([flag] if flag else [])
    out = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert expect in out.stdout
    if flag == '--license':
        assert out.stdout.strip() == tlicense.license().strip()
    if not flag:
        assert 'supervillain-tpu-torch' in out.stdout and 'TPU' not in out.stdout.replace(
            'supervillain-tpu-torch', '').replace('supervillain_tpu', '')


def test_progress_and_h5py_helpers(monkeypatch):
    assert list(tcli.progress(range(3), desc='x')) == [0, 1, 2]
    monkeypatch.setitem(sys.modules, 'tqdm', None)       # as on a machine without tqdm
    assert tcli.progress(range(3), desc='x') == range(3)
    monkeypatch.setitem(sys.modules, 'h5py', None)
    with pytest.raises(RuntimeError, match='h5py'):
        tcli.h5py()


def test_port_imports_neither_jax_nor_the_jax_package():
    """A grep of the port's sources and chip_smoke.py for imports of jax or
    supervillain_tpu finds only supervillain_tpu_torch."""
    importing = re.compile(r'^\s*(import|from)\s+(jax|supervillain_tpu)\b(?!_torch)', re.M)
    files = sorted((ROOT / 'supervillain_tpu_torch').rglob('*.py')) + [ROOT / 'chip_smoke.py']
    assert len(files) > 50
    found = [f'{f}: {m.group(0)}' for f in files for m in importing.finditer(f.read_text())]
    assert found == []
    code = ('import sys, supervillain_tpu_torch, supervillain_tpu_torch.cli, '
            'supervillain_tpu_torch.analysis.comparison_plot, supervillain_tpu_torch.__main__\n'
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'supervillain_tpu', "
            "'matplotlib', 'h5py')]\n"
            'assert not bad, bad')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
