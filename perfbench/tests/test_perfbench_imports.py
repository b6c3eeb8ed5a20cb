"""No file of the benchmark imports JAX or the JAX package; the plain
reference imports nothing of the program either."""

import ast
import pathlib

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted(BENCH.rglob('*.py'))
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'supervillain_tpu'}


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split('.')[0])
    return names


@pytest.mark.parametrize('path', FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize('path', sorted((BENCH / 'reference').glob('*.py')), ids=lambda p: p.name)
def test_the_reference_imports_only_torch_numpy_and_itself(path):
    assert top_level_imports(path) <= {'__future__', 'math', 'numpy', 'torch'}


def test_the_name_rule_compares_whole_top_level_names():
    from perfbench import run
    assert 'supervillain_tpu_torch'.split('.')[0] not in run.FORBIDDEN
    assert {'supervillain_tpu', 'jax'} <= set(run.FORBIDDEN)
