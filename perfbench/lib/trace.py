"""The reduction of a ``torch.profiler`` trace of the measured window.

The profiler's Chrome trace holds the device's operations (kernels, copies,
memsets: their card, name, start and length) and the host's (PyTorch
operators, CUDA runtime calls, and the benchmark's own spans
``perfbench.window`` and ``perfbench.record``), on one clock in microseconds.
From it: each card's busy time as the union of its operations' intervals
(overlapping operations count once), its idle gaps inside the window, each
labelled by the innermost host span that was open at its middle, and the
device time of operations by name.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

from .kernels import signature

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATS = ('cpu_op', 'user_annotation', 'cuda_runtime', 'cuda_driver')
WINDOW_SPAN = 'perfbench.window'
RECORD_SPAN = 'perfbench.record'


def short_name(name):
    """A device operation's name without its namespaces and argument list."""
    return signature(name) or name


def union(intervals):
    """Merged, sorted (start, end) intervals."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


class Trace:
    """The operations of one traced window.  Times are in seconds."""

    def __init__(self, events):
        # The host's span; the trace also mirrors it on the device's timeline
        # ('gpu_user_annotation'), over the device operations it launched.
        windows = [e for e in events if e.get('name') == WINDOW_SPAN and e.get('ph') == 'X'
                   and e.get('cat') == 'user_annotation']
        if not windows:
            raise ValueError(f'the trace holds no {WINDOW_SPAN} span')
        w = max(windows, key=lambda e: float(e['dur']))
        self.t0, self.t1 = float(w['ts']), float(w['ts']) + float(w['dur'])
        self.device_ops = []            # (card, name, cat, start, end) in µs, inside the window
        self.host_spans = []            # (start, end, name)
        for e in events:
            if e.get('ph') != 'X' or 'dur' not in e:
                continue
            start = float(e['ts'])
            end = start + float(e['dur'])
            cat = e.get('cat', '')
            if cat in DEVICE_CATS:
                if end <= self.t0 or start >= self.t1:
                    continue
                card = int(e.get('args', {}).get('device', e.get('pid', 0)))
                self.device_ops.append((card, e['name'], cat, max(start, self.t0),
                                        min(end, self.t1)))
            elif cat in HOST_CATS:
                self.host_spans.append((start, end, e['name']))
        # By start, and of spans that start together the outer first, so that a
        # backward scan meets the innermost open span first.
        self.host_spans.sort(key=lambda x: (x[0], -x[1]))
        self._starts = [s for s, _, _ in self.host_spans]
        self._records = [(s, e) for s, e, name in self.host_spans if name == RECORD_SPAN]
        self._record_starts = [s for s, _ in self._records]

    @classmethod
    def from_file(cls, path):
        with open(path) as f:
            data = json.load(f)
        return cls(data['traceEvents'] if isinstance(data, dict) else data)

    @property
    def window_s(self):
        return (self.t1 - self.t0) / 1e6

    def cards(self):
        return sorted({op[0] for op in self.device_ops})

    def busy_s(self, card):
        ivs = union((s, e) for c, _, _, s, e in self.device_ops if c == card)
        return sum(e - s for s, e in ivs) / 1e6

    def gaps(self, card):
        """The idle intervals of ``card`` inside the window, in µs."""
        ivs = union((s, e) for c, _, _, s, e in self.device_ops if c == card)
        out, at = [], self.t0
        for s, e in ivs:
            if s > at:
                out.append((at, s))
            at = max(at, e)
        if at < self.t1:
            out.append((at, self.t1))
        return out

    def host_label(self, t):
        """The innermost host span open at time ``t`` (the latest to start)."""
        i = bisect.bisect_right(self._starts, t) - 1
        for j in range(i, max(-1, i - 4000), -1):
            start, end, name = self.host_spans[j]
            if end >= t:
                return name
        # Past the nearest few thousand spans only the long ones are open.
        k = bisect.bisect_right(self._record_starts, t) - 1
        if k >= 0 and self._records[k][1] >= t:
            return RECORD_SPAN
        return WINDOW_SPAN if self.t0 <= t <= self.t1 else 'untraced'

    def idle_by_host(self):
        """Idle seconds of every card, summed by what the host was doing."""
        totals = defaultdict(float)
        for card in self.cards():
            for s, e in self.gaps(card):
                totals[self.host_label(0.5 * (s + e))] += (e - s) / 1e6
        return dict(totals)

    def time_by_name(self):
        """Device seconds of every operation, summed by name over the cards."""
        totals = defaultdict(float)
        for _, name, _, s, e in self.device_ops:
            totals[short_name(name)] += (e - s) / 1e6
        return dict(totals)

    def ops(self, match):
        """(card, name, start µs, end µs) of the device operations whose name
        ``match(name)`` accepts, in order of start."""
        return sorted(((c, n, s, e) for c, n, _, s, e in self.device_ops if match(n)),
                      key=lambda x: x[2])

    def seconds(self, match):
        return sum(e - s for _, _, s, e in self.ops(match)) / 1e6

    def copies_to_host_s(self):
        return sum(e - s for _, n, cat, s, e in self.device_ops
                   if cat == 'gpu_memcpy' and 'DtoH' in n) / 1e6


def breakdown(trace, top=10):
    """The device operations that took most time and the idle time by host
    activity, each the ``top`` largest, as [name, seconds] lists."""
    ops = sorted(trace.time_by_name().items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(trace.idle_by_host().items(), key=lambda kv: -kv[1])[:top]
    return {'device_ops': [[k, v] for k, v in ops], 'idle_gaps': [[k, v] for k, v in idle]}
