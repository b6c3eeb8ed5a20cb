"""One run of one cell of the benchmark of ``supervillain_tpu_torch`` on NVIDIA cards.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration and a traffic mix in ``BENCHMARK.json``; their
files, the readers of the per-layer metrics and the kernels' counts are found
by name (:mod:`perfbench.lib.manifest`).  A run

1. loads the program and builds its kernels, or loads them from the build
   directory inside the checkout (set-up);
2. warms the cell's one shape with a call of two records (set-up);
3. measures for ``--seconds``: calls of the fleet back to back, each the
   traffic's records from the cold start with a seed drawn from ``--seed``.
   A record's time runs from the completion of the one before it (or the
   window's start) to its own completion, which the fleet's ``progress`` hook
   marks: its host copy is synchronous, so the record times tile the window.
   The window closes at the first record that completes after ``--seconds``;
4. with ``--trace 1``, runs the window under ``torch.profiler`` and reads the
   per-layer metrics from the trace; without, the end-to-end metrics;
5. replays a sample of one call's chains, drawn from the seed, with the plain
   reference after the window and compares (:mod:`perfbench.lib.verdict`);
6. prints the compared numbers with their limits as the last lines of
   standard error, and one JSON line as the last line of standard output.

Without a card, or with fewer cards than the cell asks for, it prints no
result and exits with 2; with JAX or the JAX package loaded, with 3.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
os.environ.setdefault('USE_FLAX', '0')

import numpy as np  # noqa: E402

from perfbench.lib import manifest, peaks, program, verdict  # noqa: E402
from perfbench.lib import trace as tracelib  # noqa: E402

#: Top-level module names that no run may hold: JAX and the JAX package.
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'supervillain_tpu')
TRACE_FILE = ROOT / 'build' / 'perfbench' / 'trace.json'
SEED_MASK = 2 ** 64 - 1
#: The fleet seed of the warm-up call, the same in every run, so that set-up
#: does the same work whatever ``--seed`` is.
WARM_SEED = 12345


def forbidden_modules():
    return sorted({name.split('.')[0] for name in list(sys.modules)} & set(FORBIDDEN))


def call_seed(seed, call):
    """The fleet seed of call ``call`` of a run with ``--seed`` ``seed``."""
    state = np.random.SeedSequence([int(seed) & SEED_MASK, 1, call]).generate_state(2, np.uint32)
    return int(state[0]) << 31 ^ int(state[1])


def sample(seed, call, chains, size):
    """The chains of call ``call`` that the reference replays: one drawn from
    the seed in each of ``size`` equal blocks of the fleet."""
    rng = np.random.default_rng([int(seed) & SEED_MASK, 2, call])
    edges = np.linspace(0, chains, size + 1).astype(int)
    return [int(rng.integers(lo, hi)) for lo, hi in zip(edges[:-1], edges[1:])]


class WindowClosed(Exception):
    """Raised from the progress hook to end the fleet call running at the close."""


class Window:
    """Marks record completions through the fleet's ``progress`` hook."""

    def __init__(self, seconds, span=None):
        self.seconds, self.span = seconds, span
        self.records = []           # {'seconds', 'call', 'index'} in window order
        self.call = 0

    def open(self):
        self.start = self.last = time.perf_counter()
        self.deadline = self.start + self.seconds

    def progress(self, iterable):
        for i in iterable:
            if self.span is None:
                yield i
            else:
                with self.span('perfbench.record'):
                    yield i
            now = time.perf_counter()
            self.records.append({'seconds': now - self.last, 'call': self.call, 'index': i})
            self.last = now
            if now >= self.deadline:
                self.end = now
                raise WindowClosed


def retain(fleet, call, seed, traffic, window):
    """What the check and the counts keep of a completed call: its sampled
    chains' columns and final fields, and each record's worm moves."""
    columns = fleet.columns
    lengths = columns.get('Worm_Length')
    chains = sample(seed, call, traffic['chains'], traffic['check_chains'])
    if lengths is not None:
        truncated = columns['Worm_Truncated']
        moves = lengths.sum(axis=1) + traffic['worms'] * lengths.shape[1] - truncated.sum(axis=1)
        for rec in window.records:
            if rec['call'] == call:
                rec['moves'] = float(moves[rec['index']])
                rec['longest'] = float(lengths[rec['index']].max())
    return {'call': call, 'seed': call_seed(seed, call), 'chains': chains,
            'columns': {k: np.array(v[:, chains]) for k, v in columns.items()},
            'final': {k: np.array(v[chains]) for k, v in fleet.final.items()}}


def replay(torch, config, traffic, kept, device, dtype):
    """The plain reference's columns and final fields of a kept call's chains."""
    ref = manifest.reference(config)
    chains = torch.tensor(kept['chains'], dtype=torch.int64, device=device)
    host = torch.Generator().manual_seed(kept['seed'])

    def seeds():        # the program's kernel seeds, drawn as its fleet draws them
        while True:
            yield int(torch.randint(0, 2 ** 63 - 1, (), generator=host))

    t = dict(traffic, max_worm_moves=program.max_worm_moves(traffic))
    state = ref.cold(len(kept['chains']), traffic['L'], device, dtype)
    stream, columns = seeds(), {}
    for _ in range(traffic['records_per_call']):
        state, inline = ref.record(state, stream, chains, t, dtype)
        for k, v in inline.items():
            columns.setdefault(k, []).append(v.float().cpu().numpy())
    columns = {k: np.stack(v) for k, v in columns.items()}
    final = {name: (f.float() if f.is_floating_point() else f).cpu().numpy()
             for name, f in zip(ref.FIELDS, state)}
    return columns, final


def check(torch, config, traffic, kept, device, seed):
    """``(correct, compared)``: the program's kept call against the reference."""
    limits = traffic['limits']
    if not kept:
        return False, {'calls_checked': {'value': 0, 'limit': 1}}
    call = kept[int(seed) % len(kept)]
    t0 = time.perf_counter()
    columns, final = replay(torch, config, traffic, call, device, torch.float32)
    seconds = time.perf_counter() - t0
    parted, observed = verdict.partings(call['columns'], columns, call['final'], final)
    print(f'check: call {call["call"]}, chains {call["chains"]}, parted at {parted}, '
          f'{observed} chain-records, reference {seconds:.1f} s', file=sys.stderr)
    compared = {name: {'value': value, 'limit': limits[name]}
                for name, value in verdict.shares(parted).items()}
    return all(c['value'] <= c['limit'] for c in compared.values()), compared


class Context:
    """What a per-layer metric's reader reads: the trace of the window, its
    records (with their worm moves where the call completed), the cell."""

    def __init__(self, trace, records, traffic, cards):
        self.trace, self.records, self.traffic, self.cards = trace, records, traffic, cards

    def counts(self, kernel):
        return manifest.counts(kernel)

    def least_seconds(self, kernel, record):
        """The least time of ``kernel``'s calls in ``record`` on one card's
        peaks (they are set against device time summed over the cards), or
        None where the record's counts are not known."""
        counted = self.counts(kernel).count(self.traffic, record)
        return None if counted is None else peaks.least_seconds(*counted)


def per_layer(trace, records, traffic, cards, cell):
    ctx = Context(trace, records, traffic, cards)
    out = {}
    for metric in manifest.metrics_of(cell, 'per_layer'):
        value = manifest.reader(metric['name']).read(ctx)
        if value is not None:
            out[metric['name']] = {'value': float(value), 'unit': metric['unit']}
    return out


def end_to_end(records, window_s, setup_s, traffic, cell):
    su = traffic['chains'] * traffic['L'] ** 2 * traffic['thin'] * len(records)
    values = {'site_updates_per_s': su / window_s, 'setup_s': setup_s,
              'record_s_p95': float(np.percentile([r['seconds'] for r in records], 95))}
    return {m['name']: {'value': values[m['name']], 'unit': m['unit']}
            for m in manifest.metrics_of(cell, 'end_to_end')}


def run(cell, seed, seconds, traced, device='cuda', overrides=None):
    """One run of ``cell``; returns the result's dict (the JSON line).  On
    the CPU (tests) no device metric is written."""
    entry, _, config, traffic = manifest.cell(cell)
    traffic = dict(traffic, **(overrides or {}))
    import torch
    if device == 'cuda':
        if not torch.cuda.is_available():
            raise SystemExit('no CUDA card is available: the benchmark measures a card')
        if torch.cuda.device_count() < entry['chips']:
            raise SystemExit(f'cell {cell} needs {entry["chips"]} cards, '
                             f'{torch.cuda.device_count()} are visible')
    sv = program.load(device)
    S = program.action(sv, config, traffic)
    mesh = program.mesh(sv, traffic, device)
    cards = list(range(entry['chips'])) if device == 'cuda' else []

    def sync():
        for c in cards:
            torch.cuda.synchronize(c)

    program.fleet(sv, S, traffic, seed=WARM_SEED, steps=2, progress=None,
                  mesh=mesh, device=device)
    sync()

    profiler = None
    span = None
    if traced and device == 'cuda':
        from torch.profiler import ProfilerActivity, profile, record_function
        profiler = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        profiler.__enter__()
        span = record_function
    window = Window(seconds, span)
    kept = []
    whole = span('perfbench.window') if span else None
    if whole:
        whole.__enter__()
    window.open()
    setup_s = window.start - T0
    call = 0
    while True:
        window.call = call
        try:
            fleet = program.fleet(sv, S, traffic, seed=call_seed(seed, call),
                                  steps=traffic['records_per_call'], progress=window.progress,
                                  mesh=mesh, device=device)
        except WindowClosed:
            break
        kept.append(retain(fleet, call, seed, traffic, window))
        del fleet
        call += 1
    window_s = window.end - window.start
    times = np.array([r['seconds'] for r in window.records])
    first = np.array([r['seconds'] for r in window.records if r['index'] == 0])
    print(f'window: {len(times)} records in {window_s!r} s, {call} calls completed; record s '
          f'median {np.median(times)!r}, p95 {np.percentile(times, 95)!r}, max {times.max()!r}; '
          f'first of a call median {np.median(first)!r}', file=sys.stderr)
    if whole:
        whole.__exit__(None, None, None)
    sync()
    peak = max((torch.cuda.max_memory_allocated(c) for c in cards), default=0)
    found = forbidden_modules()
    if found:
        print(f'the run holds {found}: the benchmark measures supervillain_tpu_torch alone',
              file=sys.stderr)
        raise SystemExit(3)

    device_info = {'platform': 'gpu' if cards else 'cpu',
                   'kind': torch.cuda.get_device_name(0) if cards else 'cpu',
                   'count': len(cards), 'memory_peak_bytes': int(peak)}
    metrics, breakdown = {}, None
    if profiler is not None:
        profiler.__exit__(None, None, None)
        TRACE_FILE.parent.mkdir(parents=True, exist_ok=True)
        profiler.export_chrome_trace(str(TRACE_FILE))
        del profiler
        trace = tracelib.Trace.from_file(TRACE_FILE)
        TRACE_FILE.unlink()
        metrics = per_layer(trace, window.records, traffic, cards, cell)
        device_info['busy_s'] = statistics.mean(trace.busy_s(c) for c in cards)
        device_info['window_s'] = trace.window_s
        breakdown = tracelib.breakdown(trace)
    elif cards:
        metrics = end_to_end(window.records, window_s, setup_s, traffic, cell)

    if cards:
        torch.cuda.empty_cache()
    check_device = 'cuda:0' if cards else 'cpu'
    correct, compared = check(torch, config, traffic, kept, check_device, seed)
    for name, c in compared.items():
        print(f'{name} {c["value"]!r} limit {c["limit"]!r}', file=sys.stderr)
    result = {'correct': bool(correct), 'attempted': len(window.records), 'failed': 0,
              'metrics': metrics, 'device': device_info}
    if breakdown is not None:
        result['breakdown'] = breakdown
    result['checked'] = compared
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    except SystemExit as stop:
        if isinstance(stop.code, str):
            print(stop.code, file=sys.stderr)
            raise SystemExit(2)
        raise
    found = forbidden_modules()
    if found:
        print(f'the run holds {found}: the benchmark measures supervillain_tpu_torch alone',
              file=sys.stderr)
        raise SystemExit(3)
    print(json.dumps(result), flush=True)


if __name__ == '__main__':
    main()
