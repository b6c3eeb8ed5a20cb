"""The benchmark's files, found by name.

``BENCHMARK.json`` at the root names the cells, the configurations and the
metrics; each has files of its own under ``perfbench/``, which this module
finds by those names:

- ``configs/<config>.json``: the configuration (the action, its D and its
  precision), with its plain reference ``reference/<reference>.py``, which a
  traffic may replace by its own ``"reference"``;
- ``workloads/<traffic>.json``: the traffic mix, the parameters of the fleet
  calls that the window drives;
- ``metrics/<metric>.py``: the reader of one per-layer metric;
- ``counts/<kernel>.py``: the operations and bytes of one kernel's call.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / 'perfbench'


def manifest():
    return json.loads((ROOT / 'BENCHMARK.json').read_text())


def cell(name):
    """The cell ``name`` of BENCHMARK.json with its configuration and traffic
    loaded: (workload entry, config entry, config dict, traffic dict)."""
    m = manifest()
    work = {w['name']: w for w in m['workloads']}
    if name not in work:
        raise KeyError(f'no workload {name!r} in BENCHMARK.json; it has {sorted(work)}')
    entry = work[name]
    config_entry = {c['name']: c for c in m['configs']}[entry['config']]
    config = json.loads((ROOT / config_entry['file']).read_text())
    traffic = json.loads((BENCH / 'workloads' / f"{entry['traffic']}.json").read_text())
    return entry, config_entry, config, traffic


def metrics_of(name, kind):
    """The ``kind`` ('end_to_end' or 'per_layer') metrics that cell ``name`` reports."""
    return [x for x in manifest()[kind] if name in x.get('workloads', [name])]


def _load(path, module_name):
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric):
    """The reader module of per-layer metric ``metric``."""
    return _load(BENCH / 'metrics' / f'{metric}.py', f'perfbench_metric_{metric}')


def counts(kernel):
    """The count module of ``kernel``."""
    return _load(BENCH / 'counts' / f'{kernel}.py', f'perfbench_count_{kernel}')


def reference(config, traffic=None):
    """The plain reference module that the traffic names, or else the
    configuration (a traffic of another driver than the configuration's
    reference replays names its own)."""
    name = (traffic or {}).get('reference', config['reference'])
    return importlib.import_module(f'perfbench.reference.{name}')
