#!/usr/bin/env python3
"""Build and run the PyTorch/CUDA port (``supervillain_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit when it fails:

1. toolchain: torch, CUDA, nvcc, triton and the card's name and power limit;
2. build: compile the CUDA kernels from ``supervillain_tpu_torch/csrc``;
3. sweep kernel against its plain PyTorch version on the card (N=16, 1024
   chains): per-chain means of ActionDensity, WindingSquared and acceptance
   within 5 combined standard errors, and the inline ActionDensity of a
   one-sweep call equal to (κ/2)Σ(dφ−2πn)²/Λ of its output to 1e-5 relative;
4. worm kernel (and its plain version) against the enumerated Boltzmann
   distribution of n on a 2×2 lattice with φ frozen: χ²/dof < 3.5 at W=1
   unbounded and at W=2 with a move cap of 8; Worm_Length equal to the
   histogram's sum and, after rollback, dn ≡ 0 (mod 2) on every chain;
5. invariants of the Hammer: dn ≡ 0 (mod 2) at W=2 with truncating worms and
   dn = 0 at W=∞, bit for bit; the Hammer kernel against its plain version;
6. the main path: ``sample_fused_fleet`` at L=256, 512 chains, κ=0.5, W=1,
   thin=50, one worm per record, then ``pooled_ensemble``,
   ``autocorrelation_time`` and ``Bootstrap.estimate('ActionDensity')``; the
   kernels' launch counts in that run, and the kernels' and plain versions'
   times at that shape (the sweep and the Hammer as min/median/max over 7
   calls); the sweep kernel's plan (regime, cluster, rows per band, shared
   bytes, clusters the card runs at once), its device time by kind of launch
   in both regimes, and one Villain record's (Hammer call and host copy)
   device time by kind against its wall time (torch.profiler);
7. each kernel at the main path's shape against its plain version fed the
   kernel's own Philox draws, from the main path's final state: fields that
   differ on at most 1e-4 of the sites (a flipped Metropolis decision where
   float rounding of ΔS differs), worms that differ on at most 1% of the
   chains, and inline ActionDensity and WindingSquared within 1e-3; and the
   sweep kernel's resident and streaming regimes on one seed: the same φ, n
   and accepted counts bit for bit;

and for the Worldline kernels (B4 sweeps, B5 worms, B6 Hammer):

W1. the sweep kernel against its plain version (N=16, 1024 chains, κ=0.5, W=2
    and W=∞): per-chain means of inline ActionDensity and acceptance within 5
    combined standard errors, a one-sweep call's inline ActionDensity equal to
    (1/2κ)Σ(m − δv/_W)²/Λ of its output to 1e-5 relative, δm = 0 bit for bit;
W2. the worm kernel and the Hammer against the enumerated distribution of the
    closed integer forms u = m − δv on a 2×2 lattice (κ=0.4, W=1): χ²/dof < 3.5;
    at W=2 with a move cap of 8, truncated worms, δm = 0 after rollback and
    Worm_Length equal to the sum of Spin_Spin;
W3. duality: the Villain Hammer's ActionDensity against 1 minus the Worldline
    Hammer's inline ActionDensity (N=8, W=2, κ=0.5, 1024 chains), within 5σ;
W4. the Worldline main path: ``sample_fused_fleet`` at L=256, 512 chains, κ=0.5,
    W=2, thin=50, one worm per record (capped at 64·N²), then
    ``pooled_ensemble``, ``autocorrelation_time`` and ``Bootstrap``; the
    kernels' launch counts in that run and the kernels' and plain versions'
    times at that shape; the sweep kernel's device time by kind of launch
    and one record's (Hammer call and host copy) device time by kind against
    its wall time (torch.profiler), and the worm kernel's nanoseconds per move
    of the longest worm and moves per second;
W5. each Worldline kernel at the main path's shape against its plain version
    fed the kernel's own draws, from W4's final state: m and v differ on at
    most 1e-4 of the links and plaquettes (wrapping-cycle flips counted apart),
    inline ActionDensity within 1e-3, worms differing on at most 1% of the
    chains.  The plain worm replays a move per step, so the worms of W5 (and
    the plain worm's time) run under a cap of WORM_REPLAY_CAP moves, which
    truncates and rolls back the long ones.

The next-to-last line is a JSON object describing each kernel (its
``max_abs_err`` from the same-draws phases, its launches on its main path, its
time, its plain version's time and the least time the card could take for the
same work); the last line is ``{"ok": true, "device": {...}}``.  Nothing of
JAX is imported.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time

import numpy as np

VKAPPA = 0.06           # 2π²κ ≈ 1.18: n = ±1 links carry real mass on a 2×2 lattice
SE_BOUND = 5.0          # statistical agreement: combined standard errors
CHI2_BOUND = 3.5        # χ²/dof bound of the exact-distribution checks
INLINE_RTOL = 1e-5      # one-sweep inline ActionDensity against the recomputed one
# Kernel against plain version on the same draws.  Where float rounding of ΔS
# (summation order, exp2f against exp) flips a Metropolis decision the two
# part locally: about 1e-7 of the site updates at 1% acceptance, so a few
# flips per call; a wrong kernel differs on every accepted update (~1e-2).
SAME_DRAWS_SITES = 1e-4     # fraction of φ sites or n links that may differ
SAME_DRAWS_CHAINS = 1e-2    # fraction of chains whose worm may differ
SAME_DRAWS_INLINE = 1e-3    # |Δ| of a chain's inline ActionDensity or WindingSquared
WKAPPA = 0.4            # the worldline exact-distribution check (tests/test_exact_distribution.py)
WORM_REPLAY_CAP = 4096  # worm moves the plain replay and its timing run at L=256

# The least time the card could take for a call (PERF.md): the larger of the
# bytes it must move (each input read once, each output written once) over the
# memory rate and the operations it does over the peak rate.  The table of the
# H100 has no integer rate outside the tensor cores, so integer and float
# operations are both counted at the float32 CUDA-core rate, which only lowers
# the bound.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
PHILOX_OPS = 100        # 10 rounds of 4 multiplies, 4 XORs and 2 key adds
# Operations per unit of work, read off the kernels' sources: a Villain
# site-update (2 Philox calls, ΔS over 4 links, the draw conversions, the
# per-sweep inline sums); a Worldline sweep per site (2 plaquette proposals of
# 1 Philox call and ΔS over 4 links each, the wrapping terms of 2 links and the
# Σu² of the inline sum); a worm move (1 Philox call, the crossed link's
# residual and ΔS, the histogram tally).
OPS_VILLAIN_SITE = 2 * PHILOX_OPS + 42
OPS_WORLDLINE_SITE = 2 * (PHILOX_OPS + 26) + 12
OPS_WORM_MOVE = PHILOX_OPS + 25


class SmokeFailure(RuntimeError):
    pass


def require(condition, message):
    if not condition:
        raise SmokeFailure(message)


def say(*parts):
    print(*parts, flush=True)


# -- exact distributions of n on the 2×2 lattice (φ frozen at 0) -------------

def enumerate_villain_n(N, cutoff):
    vals = np.arange(-cutoff, cutoff + 1)
    grids = np.meshgrid(*([vals] * (2 * N * N)), indexing='ij')
    n = np.stack([g.ravel() for g in grids], axis=-1).reshape(-1, 2, N, N)
    weights = np.exp(-(VKAPPA / 2) * ((2 * np.pi * n) ** 2).sum(axis=(1, 2, 3)))
    return n, weights


def curl(n):
    """dn of a batch of 1-forms (..., 2, N, N)."""
    return (np.roll(n[..., 1, :, :], -1, axis=-2) - n[..., 1, :, :]
            - np.roll(n[..., 0, :, :], -1, axis=-1) + n[..., 0, :, :])


def chi2_against(prob_of, counts, n_draws):
    chi2, dof, pooled_obs, pooled_exp = 0.0, 0, 0, 0.0
    for k, p in prob_of.items():
        exp = p * n_draws
        obs = counts.get(k, 0)
        if exp >= 5:
            chi2 += (obs - exp) ** 2 / exp
            dof += 1
        else:
            pooled_obs += obs
            pooled_exp += exp
    if pooled_exp > 0:
        chi2 += (pooled_obs - pooled_exp) ** 2 / pooled_exp
        dof += 1
    return chi2, dof - 1


def exact_distribution(W):
    forms, weights = enumerate_villain_n(2, cutoff=2)
    if W != 1:
        closed = np.abs(curl(forms)).max(axis=(1, 2)) == 0
        forms, weights = forms[closed], weights[closed]
    prob_of = dict(zip((f.tobytes() for f in forms.astype(np.int8)), weights / weights.sum()))
    # |n| = 3 excursions fall outside the enumeration: one pooled sentinel bin.
    if W == 1:
        prob_of[b'overflow'] = 16 * np.exp(-(VKAPPA / 2) * (2 * np.pi * 3) ** 2)
    else:
        prob_of[b'overflow'] = 4 * np.exp(-(VKAPPA / 2) * 2 * (2 * np.pi * 3) ** 2)
    return prob_of


def chi2_of_samples(samples, W):
    """χ²/dof of sampled n (draws, 2, 2, 2) against the exact distribution."""
    prob_of = exact_distribution(W)
    counts = {}
    for x in samples.astype(np.int8):
        k = x.tobytes() if np.abs(x).max() <= 2 else b'overflow'
        require(k in prob_of, f'sampled n outside the sector of W={W} (dn != 0)')
        counts[k] = counts.get(k, 0) + 1
    chi2, dof = chi2_against(prob_of, counts, len(samples))
    require(dof >= 5, f'too few populated bins ({dof})')
    return chi2 / dof


# -- statistics ----------------------------------------------------------------

def per_chain_agreement(name, a, b):
    """Means over chains of per-chain means (records, chains) of two samplers."""
    ma, mb = a.mean(axis=0), b.mean(axis=0)
    m1, m2 = float(ma.mean()), float(mb.mean())
    se = math.hypot(ma.std(ddof=1) / math.sqrt(ma.size), mb.std(ddof=1) / math.sqrt(mb.size))
    z = abs(m1 - m2) / se if se > 0 else (0.0 if m1 == m2 else math.inf)
    say(f'  {name}: kernel {m1!r}  plain {m2!r}  |Δ|/σ = {z:.3f} (bound {SE_BOUND})')
    require(z < SE_BOUND, f'{name}: kernel and plain version disagree ({z:.2f} σ)')


def time_ms(torch, fn, reps):
    """Mean milliseconds per call on the card (CUDA events), after one warm-up,
    and the last call's result."""
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def profiled(torch, fn, reps):
    """Device time of each kind of launch that ``fn`` makes over ``reps``
    calls, from torch.profiler: ({kind: (launches per call, ms per call)},
    host-clock ms per call).  The dict is empty when the profiler records no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    kinds = {}
    for e in prof.key_averages():
        us = e.self_device_time_total
        if us <= 0:
            continue
        found = re.search(r'(\w+(?:<[^()]*>)?)\(', e.key)
        kind = found.group(1) if found else e.key
        count, total = kinds.get(kind, (0, 0.0))
        kinds[kind] = (count + e.count / reps, total + us / 1e3 / reps)
    return kinds, wall_ms


def launch_breakdown(torch, fn, reps):
    """The kinds of :func:`profiled` after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    return profiled(torch, fn, reps)[0]


def say_breakdown(card, what, kinds, call_ms, clock='CUDA events'):
    """Print a launch breakdown with each kind's share of the call's device
    time, beside the call's time on ``clock`` (the rest is time the device
    waits: gaps between launches, or the host)."""
    if not kinds:
        say(f'  [{card}] {what}: the profiler recorded no device time (not measured)')
        return
    total = sum(ms for _, ms in kinds.values())
    say(f'  [{card}] {what}: {total!r} ms of device time per call, against {call_ms!r} ms per '
        f'call on {clock} (device idle {1 - total / call_ms!r} of it)')
    for kind, (count, ms) in sorted(kinds.items(), key=lambda kv: -kv[1][1]):
        say(f'    {kind}: {count!r} launches, {ms!r} ms per call, {ms / total!r} of the call')


def timed_call(torch, fn):
    """Milliseconds of one call on the card (CUDA events) and its result."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop), out


def call_spread(torch, fn, reps):
    """Milliseconds of each of ``reps`` calls on the card (CUDA events, one
    call at a time, after one warm-up), and the last call's result."""
    fn()
    times = []
    for _ in range(reps):
        ms, out = timed_call(torch, fn)
        times.append(ms)
    return times, out


def spread(times):
    """'min / median / max' of per-call milliseconds."""
    return f'{min(times)!r} / {float(np.median(times))!r} / {max(times)!r}'


def bound(nbytes, ops):
    """(bound_ms, bound_by) of a call that moves ``nbytes`` and does ``ops``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, 'bytes' if t_bytes >= t_ops else 'operations'


def worm_moves(length, truncated, worms):
    """Moves a worm call made: its tallied moves plus one close move per closed worm."""
    return float(length.double().sum()) + worms * length.numel() - float(truncated.double().sum())


# -- phases --------------------------------------------------------------------

def phase_toolchain(torch, kernels):
    say('== phase 1: toolchain')
    say(f'python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}')
    nvcc = subprocess.run([kernels._nvcc(), '--version'], capture_output=True, text=True)
    say('nvcc:', nvcc.stdout.strip().splitlines()[-1] if nvcc.stdout else nvcc.stderr.strip())
    try:
        import triton
        say(f'triton {triton.__version__} imports')
    except ImportError as e:
        say(f'triton does not import ({e})')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f'nvidia-smi failed: {smi.stderr}')
    card = smi.stdout.strip().splitlines()[0]
    say(f'card: {card}  (torch: {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} visible)')
    return card


def phase_build(kernels):
    say('== phase 2: build')
    t0 = time.perf_counter()
    path = kernels.build()
    kernels.library()
    say(f'built {path} in {time.perf_counter() - t0:.2f} s')
    for line in kernels.build_log.splitlines():
        if 'registers' in line or 'spill' in line or 'Compiling entry' in line:
            say('  ptxas:', line.split('ptxas info    :')[-1].strip())


def phase_sweep(torch):
    from supervillain_tpu_torch.ops import calculus
    from supervillain_tpu_torch.ops.sweep import SweepDraws, neighborhood_sweeps, plain_sweeps, lattice

    say('== phase 3: sweep kernel against its plain version (N=16, 1024 chains, κ=0.5, W=1)')
    N, B, kappa, W = 16, 1024, 0.5, 1
    dev = torch.device('cuda')
    host = torch.Generator().manual_seed(3)
    gdev = torch.Generator(device=dev).manual_seed(4)
    draws = SweepDraws(gdev, B=B, N=N, interval_phi=math.pi, interval_n=1, p_n=None,
                       zmode=False, fdt=torch.float32, idt=torch.int32, device=dev)

    def kernel(phi, n, sweeps):
        return neighborhood_sweeps(phi, n, kappa=kappa, W=W, interval_phi=math.pi,
                                   interval_n=1, sweeps=sweeps, generator=host)

    def plain(phi, n, sweeps):
        return plain_sweeps(phi, n, kappa=kappa, W=W, sweeps=sweeps, draws=draws)

    records = {}
    for label, fn in (('kernel', kernel), ('plain', plain)):
        phi = torch.zeros((B, 1, N, N), dtype=torch.float32, device=dev)
        n = torch.zeros((B, 2, N, N), dtype=torch.int32, device=dev)
        for _ in range(20):                      # 2000 thermalization sweeps
            phi, n, _, _ = fn(phi, n, 100)
        ad, w2, acc = [], [], []
        for _ in range(40):
            phi, n, a, inline = fn(phi, n, 25)
            ad.append(inline['ActionDensity'].double().cpu().numpy())
            w2.append(inline['WindingSquared'].double().cpu().numpy())
            acc.append((a / (N * N * 25)).double().cpu().numpy())
        records[label] = {'ActionDensity': np.array(ad), 'WindingSquared': np.array(w2),
                          'acceptance': np.array(acc)}
        if label == 'kernel':
            final = (phi, n)
    for k in records['kernel']:
        per_chain_agreement(k, records['kernel'][k], records['plain'][k])

    # The inline ActionDensity of a single sweep against the output fields.
    phi, n = final
    phi1, n1, _, inline = kernel(phi, n, 1)
    L = lattice(N)
    r = calculus.d(L, 0, phi1.double()) - 2 * math.pi * n1.double()
    recomputed = (kappa / 2) * (r * r).sum(dim=(1, 2, 3)) / (N * N)
    rel = ((inline['ActionDensity'].double() - recomputed).abs() / recomputed.abs()).max().item()
    say(f'  one-sweep inline ActionDensity vs recomputed: max relative error {rel!r} '
        f'(bound {INLINE_RTOL})')
    require(rel < INLINE_RTOL, 'inline ActionDensity disagrees with the output fields')


def phase_worm(torch):
    from supervillain_tpu_torch.ops.worm import WormDraws, classic_worms, plain_worms

    say('== phase 4: worm kernel against the exact distribution (N=2, φ frozen, κ=0.06)')
    dev = torch.device('cuda')
    N, B = 2, 256
    host = torch.Generator().manual_seed(5)
    phi = torch.zeros((B, 1, N, N), dtype=torch.float32, device=dev)
    lengths = {}
    for W, cap, thin, records in ((1, None, 8, 120), (2, 8, 32, 120)):
        n = torch.zeros((B, 2, N, N), dtype=torch.int32, device=dev)
        samples, truncations, wl = [], 0.0, []
        for i in range(records):
            n, hist, length, truncated = classic_worms(phi, n, kappa=VKAPPA, W=W, worms=thin,
                                                       max_worm_moves=cap, generator=host)
            require(torch.equal(length, hist.sum(dim=(1, 2))),
                    'Worm_Length differs from the sum of Vortex_Vortex')
            if W != 1:
                require(bool((torch.remainder(torch.as_tensor(curl(n.cpu().numpy())), W) == 0).all()),
                        'a worm left dn != 0 (mod W) after rollback')
            truncations += float(truncated.sum())
            wl.append(length.double().cpu().numpy() / thin)
            if i >= 20:
                samples.append(n.cpu().numpy())
        ratio = chi2_of_samples(np.concatenate(samples), W)
        say(f'  W={W} cap={cap}: kernel χ²/dof = {ratio:.3f} over {len(samples) * B} draws, '
            f'{truncations:.0f} truncated worms (bound {CHI2_BOUND})')
        require(ratio < CHI2_BOUND, f'worm kernel misses the exact distribution at W={W}')
        if cap is not None:
            require(truncations > 0, 'no worm was truncated: the rollback went untested')
        lengths[W] = np.array(wl)

    # The plain version on the card, same ensemble at W=1.
    gdev = torch.Generator(device=dev).manual_seed(6)
    draws = WormDraws(gdev, B=B, N=N, fdt=torch.float32, device=dev)
    n = torch.zeros((B, 2, N, N), dtype=torch.int32, device=dev)
    samples, wl = [], []
    for i in range(60):
        n, hist, length, _ = plain_worms(phi, n, kappa=VKAPPA, W=1, worms=8,
                                         max_worm_moves=None, draws=draws)
        wl.append(length.double().cpu().numpy() / 8)
        if i >= 20:
            samples.append(n.cpu().numpy())
    ratio = chi2_of_samples(np.concatenate(samples), 1)
    say(f'  W=1: plain χ²/dof = {ratio:.3f} over {len(samples) * B} draws')
    require(ratio < CHI2_BOUND, 'plain worm misses the exact distribution')
    per_chain_agreement('Worm_Length per worm (W=1)', lengths[1][20:], np.array(wl)[20:])


def phase_invariants(torch):
    from supervillain_tpu_torch.ops.hammer import hammer_sweeps
    from supervillain_tpu_torch.ops.sweep import SweepDraws, plain_sweeps
    from supervillain_tpu_torch.ops.worm import WormDraws, plain_worms

    say('== phase 5: Hammer invariants (L=64, 64 chains) and Hammer kernel against plain')
    dev = torch.device('cuda')
    host = torch.Generator().manual_seed(7)
    N, B = 64, 64
    for W, cap in ((2, 4), (float('inf'), 4096)):
        phi = torch.zeros((B, 1, N, N), dtype=torch.float32, device=dev)
        n = torch.zeros((B, 2, N, N), dtype=torch.int32, device=dev)
        truncated = 0.0
        for _ in range(5):
            phi, n, _, inline = hammer_sweeps(phi, n, kappa=0.5, W=W, interval_phi=math.pi,
                                              interval_n=1, sweeps=10, worms=4,
                                              max_worm_moves=cap, generator=host)
            truncated += float(inline['Worm_Truncated'].sum())
        dn = torch.as_tensor(curl(n.cpu().numpy()))
        if W == 2:
            require(truncated > 0, 'no worm was truncated at W=2')
            require(bool((torch.remainder(dn, 2) == 0).all()), 'dn != 0 (mod 2) at W=2')
        else:
            require(bool((dn == 0).all()), 'dn != 0 at W=inf')
        say(f'  W={W}: cap {cap}, {truncated:.0f} truncated worms, constraint holds bit for bit')

    say('  Hammer kernel against plain (L=16, 512 chains, κ=0.5, W=1, 10 sweeps + 1 worm per call)')
    N, B = 16, 512
    gdev = torch.Generator(device=dev).manual_seed(8)
    sdraws = SweepDraws(gdev, B=B, N=N, interval_phi=math.pi, interval_n=1, p_n=None,
                        zmode=False, fdt=torch.float32, idt=torch.int32, device=dev)
    wdraws = WormDraws(gdev, B=B, N=N, fdt=torch.float32, device=dev)

    def kernel(phi, n):
        phi, n, _, inline = hammer_sweeps(phi, n, kappa=0.5, W=1, interval_phi=math.pi,
                                          interval_n=1, sweeps=10, worms=1,
                                          max_worm_moves=64 * N * N, generator=host)
        return phi, n, inline['ActionDensity'], inline['Worm_Length']

    def plain(phi, n):
        phi, n, _, inline = plain_sweeps(phi, n, kappa=0.5, W=1, sweeps=10, draws=sdraws)
        n, _, length, _ = plain_worms(phi, n, kappa=0.5, W=1, worms=1,
                                      max_worm_moves=64 * N * N, draws=wdraws)
        return phi, n, inline['ActionDensity'], length

    out = {}
    for label, fn in (('kernel', kernel), ('plain', plain)):
        phi = torch.zeros((B, 1, N, N), dtype=torch.float32, device=dev)
        n = torch.zeros((B, 2, N, N), dtype=torch.int32, device=dev)
        ad, wl = [], []
        for i in range(160):
            phi, n, a, w = fn(phi, n)
            if i >= 100:
                ad.append(a.double().cpu().numpy())
                wl.append(w.double().cpu().numpy())
        out[label] = (np.array(ad), np.array(wl))
    per_chain_agreement('ActionDensity', out['kernel'][0], out['plain'][0])
    per_chain_agreement('Worm_Length', out['kernel'][1], out['plain'][1])


def phase_main_path(torch, card):
    import supervillain_tpu_torch as sv
    from supervillain_tpu_torch.ops.hammer import hammer_sweeps
    from supervillain_tpu_torch.ops.sweep import (STREAMING_PLAN, SweepDraws, kernel_sweeps,
                                                  neighborhood_sweeps, plain_sweeps,
                                                  resident_clusters, sweep_plan)
    from supervillain_tpu_torch.ops.worm import WormDraws, classic_worms, plain_worms
    from supervillain_tpu_torch.parallel import TRUNCATION_BUDGET

    N, B, thin, steps, cut = 256, 512, 50, 30, 10
    say(f'== phase 6: main path (L={N}, {B} chains, κ=0.5, W=1, thin={thin}, worms=1, '
        f'{steps} records, cut {cut})')
    S = sv.Villain(sv.Lattice2D(N), 0.5, W=1)
    counters = {'sweep': neighborhood_sweeps, 'worm': classic_worms, 'hammer': hammer_sweeps}
    for f in counters.values():
        f.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fleet = sv.sample_fused_fleet(S, chains=B, steps=steps, thin=thin, worms=1, seed=0,
                                  device='cuda')
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items()}
    say(f'  sample_fused_fleet: {elapsed!r} s, {elapsed / steps!r} s per launch; '
        f'launches {launches}')
    require(all(v > 0 for v in launches.values()), f'a kernel of the path never launched: {launches}')

    for k in ('ActionDensity', 'WindingSquared', 'Worm_Length', 'Vortex_Vortex'):
        col = fleet.columns[k]
        require(col.shape[:2] == (steps, B) and np.isfinite(col).all(), f'bad column {k}')
    require(np.array_equal(fleet.columns['Worm_Length'], fleet.columns['Vortex_Vortex'].sum(axis=(2, 3))),
            'Worm_Length differs from the sum of Vortex_Vortex')
    e = fleet.pooled_ensemble(cut)
    tau = e.autocorrelation_time()
    estimate = sv.Bootstrap(e.every(tau), draws=200, seed=0).estimate('ActionDensity')
    require(all(np.isfinite(estimate)), f'non-finite estimate {estimate}')
    truncated = float(fleet.columns['Worm_Truncated'].sum())
    frac = truncated / (steps * B)
    say(f'  ActionDensity = {float(estimate[0])!r} ± {float(estimate[1])!r} (τ = {tau}); '
        f'WindingSquared mean {float(fleet.columns["WindingSquared"][cut:].mean())!r}; '
        f'Worm_Length mean {float(fleet.columns["Worm_Length"][cut:].mean())!r}; '
        f'truncated worms {frac!r} (budget {TRUNCATION_BUDGET})')
    if frac > TRUNCATION_BUDGET:
        say('  WARNING: truncated-worm fraction above the budget')

    # Times at the main path's shape, from its final state.
    host = torch.Generator().manual_seed(9)
    gdev = torch.Generator(device='cuda').manual_seed(10)
    phi = torch.as_tensor(fleet.final['phi'], device='cuda')
    n = torch.as_tensor(fleet.final['n'], device='cuda')
    sdraws = SweepDraws(gdev, B=B, N=N, interval_phi=math.pi, interval_n=1, p_n=None,
                        zmode=False, fdt=torch.float32, idt=torch.int32, device='cuda')
    wdraws = WormDraws(gdev, B=B, N=N, fdt=torch.float32, device='cuda')
    common = dict(kappa=0.5, W=1)
    cap = 64 * N * N

    def sweep():
        return neighborhood_sweeps(phi, n, interval_phi=math.pi, interval_n=1, sweeps=thin,
                                   generator=host, **common)

    def hammer():
        return hammer_sweeps(phi, n, interval_phi=math.pi, interval_n=1, sweeps=thin, worms=1,
                             max_worm_moves=cap, generator=host, **common)

    plan = sweep_plan(N)
    say(f'  [{card}] sweep plan at N={N}: {plan}; bands (first row, rows) {plan.bands(N)}; '
        f'{resident_clusters(plan) if plan.regime == "resident" else 0} clusters run at once')
    spreads = {'sweep': call_spread(torch, sweep, 7), 'hammer': call_spread(torch, hammer, 7)}
    timed = {k: (float(np.median(t)), out) for k, (t, out) in spreads.items()}
    timed['worm'] = time_ms(torch, lambda: classic_worms(
        phi, n, worms=1, max_worm_moves=cap, generator=host, **common), 5)
    ms = {k: t for k, (t, _) in timed.items()}
    for k, (t, _) in spreads.items():
        say(f'  [{card}] {k} ms per call, min / median / max over {len(t)} calls: {spread(t)}')
    # The sweep kernel by kind of launch in its plan's regime, and in the
    # streaming regime (one launch per color pass) at the same shape for comparison.
    streaming = STREAMING_PLAN
    streaming_times, _ = call_spread(torch, lambda: kernel_sweeps(
        phi, n, streaming, interval_phi=math.pi, interval_n=1, sweeps=thin, generator=host,
        **common), 5)
    say(f'  [{card}] sweep kernel in the streaming regime at N={N}, ms per call, min / median / '
        f'max over 5 calls: {spread(streaming_times)}')
    say_breakdown(card, f'sweep kernel by launch kind ({plan.regime}, torch.profiler, 3 '
                  f'{thin}-sweep calls)', launch_breakdown(torch, sweep, 3), ms['sweep'])
    if plan.regime == 'resident':
        cycles = torch.zeros((B * plan.cluster, 2), dtype=torch.int64, device='cuda')
        kernel_sweeps(phi, n, plan, interval_phi=math.pi, interval_n=1, sweeps=thin,
                      generator=host, cycles=cycles, **common)
        waited, total = (float(c) for c in cycles.double().sum(dim=0))
        say(f'  [{card}] resident sweep: thread 0 of each block waits {waited / total!r} of its '
            f'clock cycles at the {3 * thin + 2} cluster barriers of a call (mean over '
            f'{cycles.shape[0]} blocks)')
    say_breakdown(card, f'sweep kernel by launch kind (streaming, torch.profiler, 3 {thin}-sweep '
                  f'calls)', launch_breakdown(torch, lambda: kernel_sweeps(
                      phi, n, streaming, interval_phi=math.pi, interval_n=1, sweeps=thin,
                      generator=host, **common), 3), float(np.median(streaming_times)))
    # One record as sample_fused_fleet makes it (the Hammer, then the copy of
    # its inline observables to the host), from the final state.
    kinds, record_ms = profiled(torch, lambda: {k: x.cpu().numpy() for k, x in hammer()[3].items()},
                                3)
    say_breakdown(card, 'one Villain record (Hammer call and host copy of its inline '
                  'observables, torch.profiler, 3 records)', kinds, record_ms, 'the host clock')
    plain_sweep_ms, _ = time_ms(torch, lambda: plain_sweeps(phi, n, sweeps=thin, draws=sdraws,
                                                             **common), 1)
    plain_worm_ms, _ = time_ms(torch, lambda: plain_worms(phi, n, worms=1, max_worm_moves=cap,
                                                          draws=wdraws, **common), 3)
    plain_ms = {'sweep': plain_sweep_ms, 'worm': plain_worm_ms, 'hammer': plain_sweep_ms + plain_worm_ms}
    # Bounds from this run's inputs: φ f32 and n 2×i32 in and out (24 B a site);
    # the worm reads φ and n and writes n and its histogram (24 B a site).
    sites = B * N * N
    _, _, worm_length, worm_truncated = timed['worm'][1]
    moves = worm_moves(worm_length, worm_truncated, 1)
    _, _, _, hammer_inline = timed['hammer'][1]
    hammer_moves = worm_moves(hammer_inline['Worm_Length'], hammer_inline['Worm_Truncated'], 1)
    bounds = {
        'sweep': bound(24 * sites + 12 * B, OPS_VILLAIN_SITE * sites * thin),
        'worm': bound(24 * sites + 8 * B, OPS_WORM_MOVE * moves),
        'hammer': bound(28 * sites + 20 * B,
                        OPS_VILLAIN_SITE * sites * thin + OPS_WORM_MOVE * hammer_moves),
    }
    su = B * N * N * thin
    say(f'  [{card}] sweep kernel {ms["sweep"]!r} ms per {thin}-sweep call = '
        f'{su / ms["sweep"] * 1e3!r} site-updates/s; plain {plain_ms["sweep"]!r} ms = '
        f'{su / plain_ms["sweep"] * 1e3!r} site-updates/s; bound {bounds["sweep"]}')
    say(f'  [{card}] worm kernel {ms["worm"]!r} ms per call (1 worm/chain, {moves!r} moves); '
        f'plain {plain_ms["worm"]!r} ms; bound {bounds["worm"]}')
    say(f'  [{card}] hammer {ms["hammer"]!r} ms per call; plain sweep + plain worm '
        f'{plain_ms["hammer"]!r} ms; bound {bounds["hammer"]}')
    return launches, ms, plain_ms, bounds, (phi, n)


def differ(a, b):
    """Per-chain mask of chains where ``a`` and ``b`` differ anywhere."""
    return (a != b).reshape(a.shape[0], -1).any(dim=1)


def compare_sweeps(name, got, want):
    """Sweep outputs (φ, n, accepted, inline) of a kernel and its plain twin."""
    sites = float((got[0] != want[0]).double().mean())
    links = float((got[1] != want[1]).double().mean())
    inline = max(float((got[3][k] - want[3][k]).abs().max())
                 for k in ('ActionDensity', 'WindingSquared'))
    say(f'  {name}: φ differs at {sites!r} of the sites, n at {links!r} of the links '
        f'(bound {SAME_DRAWS_SITES}); max |Δ inline| {inline!r} (bound {SAME_DRAWS_INLINE})')
    require(sites <= SAME_DRAWS_SITES and links <= SAME_DRAWS_SITES,
            f'{name}: kernel and plain version part on the same draws')
    require(inline <= SAME_DRAWS_INLINE, f'{name}: inline observables disagree')
    return float((got[3]['ActionDensity'] - want[3]['ActionDensity']).abs().max())


def compare_worms(name, got, want):
    """Worm outputs (n, hist, length, truncated) of a kernel and its plain twin."""
    parted = differ(got[0], want[0]) | differ(got[1], want[1]) | differ(got[2], want[2])
    frac = float(parted.double().mean())
    err = float((got[2] - want[2]).abs().max())
    say(f'  {name}: worms differ on {frac!r} of the chains (bound {SAME_DRAWS_CHAINS}); '
        f'max |Δ Worm_Length| {err!r}')
    require(frac <= SAME_DRAWS_CHAINS, f'{name}: kernel and plain worms part on the same draws')
    return err


def phase_same_draws(torch, final):
    from supervillain_tpu_torch.ops import kernels
    from supervillain_tpu_torch.ops.hammer import hammer_sweeps
    from supervillain_tpu_torch.ops.sweep import (STREAMING_PLAN, KernelSweepDraws, kernel_sweeps,
                                                  neighborhood_sweeps, plain_sweeps, sweep_plan)
    from supervillain_tpu_torch.ops.worm import KernelWormDraws, classic_worms, plain_worms

    phi, n = final
    B, N, thin = phi.shape[0], phi.shape[-1], 50
    say(f'== phase 7: kernels against their plain versions on the kernels\' draws '
        f'(L={N}, {B} chains, {thin} sweeps, 1 worm, from the main path\'s final state)')
    sweep_args = dict(kappa=0.5, W=1, interval_phi=math.pi, interval_n=1, sweeps=thin)
    worm_args = dict(kappa=0.5, W=1, worms=1, max_worm_moves=64 * N * N)

    def seeds(seed, count):
        g = torch.Generator().manual_seed(seed)
        return [kernels.seed_from(g) for _ in range(count)]

    def sweep_draws(seed):
        return KernelSweepDraws(seed, B=B, N=N, interval_phi=math.pi, interval_n=1, p_n=None,
                                zmode=False, fdt=torch.float32, idt=torch.int32, device=phi.device)

    def plain_sweep(seed):
        return plain_sweeps(phi, n, kappa=0.5, W=1, sweeps=thin, draws=sweep_draws(seed))

    def plain_worm(phi, n, seed):
        return plain_worms(phi, n, draws=KernelWormDraws(seed, B=B, N=N, device=phi.device),
                           **worm_args)

    err = {}
    got = neighborhood_sweeps(phi, n, generator=torch.Generator().manual_seed(11), **sweep_args)
    err['sweep'] = compare_sweeps('sweep', got, plain_sweep(*seeds(11, 1)))

    got = classic_worms(phi, n, generator=torch.Generator().manual_seed(12), **worm_args)
    err['worm'] = compare_worms('worm', got, plain_worm(phi, n, *seeds(12, 1)))

    got = hammer_sweeps(phi, n, generator=torch.Generator().manual_seed(13), **sweep_args,
                        worms=1, max_worm_moves=64 * N * N)
    s_sweep, s_worm = seeds(13, 2)
    phi1, n1, accepted, inline = plain_sweep(s_sweep)
    worm = plain_worm(phi1, n1, s_worm)
    err_sweep = compare_sweeps('hammer', got, (phi1, worm[0], accepted, inline))
    err_worm = compare_worms('hammer', (got[1], got[3]['Vortex_Vortex'], got[3]['Worm_Length']),
                             worm)
    err['hammer'] = max(err_sweep, err_worm)

    # Both regimes of the sweep kernel on one seed at the main path's shape.
    plans = {'resident': sweep_plan(N), 'streaming': STREAMING_PLAN}
    outs = {k: kernel_sweeps(phi, n, plan, generator=torch.Generator().manual_seed(14),
                             **sweep_args) for k, plan in plans.items()}
    same = [torch.equal(a, b) for a, b in zip(outs['resident'][:3], outs['streaming'][:3])]
    inline = max(float((outs['resident'][3][k] - outs['streaming'][3][k]).abs().max())
                 for k in ('ActionDensity', 'WindingSquared'))
    say(f'  sweep regimes {plans["resident"].regime} and streaming on one seed: φ, n, accepted '
        f'equal {same}; max |Δ inline| {inline!r}')
    require(all(same), 'the resident and streaming sweep regimes differ on one seed')
    torch.cuda.synchronize()
    return err


# -- the Worldline kernels -------------------------------------------------------

def enumerate_closed_forms(N, cutoff):
    """All integer 1-forms u with δu = 0 and |u_ℓ| ≤ cutoff on the N×N lattice,
    with their Boltzmann weights exp(−Σu²/2κ) (tests/test_exact_distribution.py)."""
    vals = np.arange(-cutoff, cutoff + 1, dtype=np.int8)
    grids = np.meshgrid(*([vals] * (2 * N * N)), indexing='ij')
    forms = np.stack([g.ravel() for g in grids], axis=-1).reshape(-1, 2, N, N)
    div = np.zeros((forms.shape[0], N, N), dtype=np.int16)
    for mu in range(2):
        div += forms[:, mu] - np.roll(forms[:, mu], +1, axis=mu + 1)
    forms = forms[np.abs(div).max(axis=(1, 2)) == 0]
    weights = np.exp(-(forms.astype(np.float64) ** 2).sum(axis=(1, 2, 3)) / (2 * WKAPPA))
    return forms, weights


def chi2_of_closed_forms(samples):
    """χ²/dof of sampled u (draws, 2, 2, 2) against the exact W=1 distribution."""
    forms, weights = enumerate_closed_forms(2, cutoff=3)
    prob_of = dict(zip((f.tobytes() for f in forms), weights / weights.sum()))
    counts = {}
    for x in samples.astype(np.int8):
        require(np.abs(x).max() <= 3, 'sampled state outside the enumeration cutoff')
        k = x.tobytes()
        require(k in prob_of, 'sampled a state with δu != 0')
        counts[k] = counts.get(k, 0) + 1
    chi2, dof = chi2_against(prob_of, counts, len(samples))
    require(dof >= 5, f'too few populated bins ({dof})')
    return chi2 / dof


def cold_worldline(torch, B, N, W):
    vdt = torch.float32 if W == float('inf') else torch.int32
    return (torch.zeros((B, 2, N, N), dtype=torch.int32, device='cuda'),
            torch.zeros((B, 1, N, N), dtype=vdt, device='cuda'))


def divergence_free(torch, m):
    from supervillain_tpu_torch.ops import calculus
    from supervillain_tpu_torch.ops.sweep import lattice
    return bool((calculus.delta(lattice(m.shape[-1]), 1, m) == 0).all())


def phase_worldline_sweep(torch):
    from supervillain_tpu_torch.ops.worldline import (WorldlineSweepDraws, action_density,
                                                      plain_worldline_sweeps, worldline_sweeps)

    N, B, kappa = 16, 1024, 0.5
    for W in (2, float('inf')):
        say(f'== phase W1: worldline sweep kernel against its plain version (N={N}, {B} chains, '
            f'κ={kappa}, W={W})')
        winf = W == float('inf')
        host = torch.Generator().manual_seed(21)
        draws = WorldlineSweepDraws(torch.Generator(device='cuda').manual_seed(22), B=B, N=N,
                                    interval_v=1.0 if winf else 1, interval_t=1, interval_w=1,
                                    winf=winf, fdt=torch.float32, idt=torch.int32, device='cuda')

        def kernel(m, v, sweeps):
            return worldline_sweeps(m, v, kappa=kappa, W=W, sweeps=sweeps, generator=host)

        def plain(m, v, sweeps):
            return plain_worldline_sweeps(m, v, kappa=kappa, W=W, sweeps=sweeps, draws=draws)

        records = {}
        for label, fn in (('kernel', kernel), ('plain', plain)):
            m, v = cold_worldline(torch, B, N, W)
            for _ in range(10):                  # 1000 thermalization sweeps
                m, v, _, _ = fn(m, v, 100)
            ad, acc = [], []
            for _ in range(40):
                m, v, a, inline = fn(m, v, 25)
                ad.append(inline['ActionDensity'].double().cpu().numpy())
                acc.append((a / ((2 * N * N + 2 * N) * 25)).double().cpu().numpy())
            records[label] = {'ActionDensity': np.array(ad), 'acceptance': np.array(acc)}
            require(divergence_free(torch, m), f'{label}: δm != 0')
            if label == 'kernel':
                final = (m, v)
        for k in records['kernel']:
            per_chain_agreement(k, records['kernel'][k], records['plain'][k])

        m1, v1, _, inline = kernel(*final, 1)
        require(divergence_free(torch, m1), 'the sweep kernel broke δm = 0')
        recomputed = action_density(m1.long(), v1.double() if winf else v1.long(), kappa, W)
        rel = ((inline['ActionDensity'].double() - recomputed).abs() / recomputed.abs()).max().item()
        say(f'  δm = 0 bit for bit; one-sweep inline ActionDensity vs (1/2κ)Σu²/Λ of the output: '
            f'max relative error {rel!r} (bound {INLINE_RTOL})')
        require(rel < INLINE_RTOL, 'inline ActionDensity disagrees with the output fields')


def phase_worldline_exact(torch):
    from supervillain_tpu_torch.ops import calculus
    from supervillain_tpu_torch.ops.sweep import lattice
    from supervillain_tpu_torch.ops.worldline_hammer import worldline_hammer_sweeps
    from supervillain_tpu_torch.ops.worldline_worm import worldline_worms

    say(f'== phase W2: worldline worm and Hammer kernels against the exact distribution '
        f'(N=2, κ={WKAPPA})')
    N, B = 2, 256
    host = torch.Generator().manual_seed(23)
    L = lattice(N)

    def closed_u(m, v):
        return (m.long() - calculus.delta(L, 2, v.long())).cpu().numpy()

    for name in ('worm', 'hammer'):
        m, v = cold_worldline(torch, B, N, 1)
        samples = []
        for i in range(120):
            if name == 'worm':              # v stays 0: u = m, and the worm is ergodic at W=1
                m, hist, length, _ = worldline_worms(m, v, kappa=WKAPPA, W=1, worms=8,
                                                     generator=host)
            else:
                m, v, _, inline = worldline_hammer_sweeps(m, v, kappa=WKAPPA, W=1, sweeps=2,
                                                          worms=1, generator=host)
                hist, length = inline['Spin_Spin'], inline['Worm_Length']
            require(torch.equal(length, hist.sum(dim=(1, 2))),
                    'Worm_Length differs from the sum of Spin_Spin')
            if i >= 20:
                samples.append(closed_u(m, v))
        ratio = chi2_of_closed_forms(np.concatenate(samples))
        say(f'  W=1 {name}: χ²/dof = {ratio:.3f} over {len(samples) * B} draws (bound {CHI2_BOUND})')
        require(ratio < CHI2_BOUND, f'the worldline {name} misses the exact distribution')

    m, v = cold_worldline(torch, B, N, 2)
    truncated = 0.0
    for _ in range(40):
        m, v, _, inline = worldline_hammer_sweeps(m, v, kappa=WKAPPA, W=2, sweeps=1, worms=4,
                                                  max_worm_moves=8, generator=host)
        truncated += float(inline['Worm_Truncated'].sum())
        require(torch.equal(inline['Worm_Length'], inline['Spin_Spin'].sum(dim=(1, 2))),
                'Worm_Length differs from the sum of Spin_Spin')
        require(divergence_free(torch, m), 'a truncated worm left δm != 0')
    say(f'  W=2 cap 8: {truncated:.0f} truncated worms, δm = 0 bit for bit after rollback')
    require(truncated > 0, 'no worm was truncated: the rollback went untested')


def phase_duality(torch):
    from supervillain_tpu_torch.ops.hammer import hammer_sweeps
    from supervillain_tpu_torch.ops.worldline_hammer import worldline_hammer_sweeps

    N, B, kappa, W = 8, 1024, 0.5, 2
    say(f'== phase W3: duality, Villain Hammer against Worldline Hammer (N={N}, {B} chains, '
        f'κ={kappa}, W={W})')
    # The Villain sweep draws Δn on all 4 links of a site; zero-inflated (p_n)
    # they leave most proposals pure Δφ, which thermalizes it in ~100 sweeps
    # instead of thousands, with the same equilibrium.
    host = torch.Generator().manual_seed(25)
    cap = 64 * N * N
    phi = torch.zeros((B, 1, N, N), dtype=torch.float32, device='cuda')
    n = torch.zeros((B, 2, N, N), dtype=torch.int32, device='cuda')
    m, v = cold_worldline(torch, B, N, W)
    villain, worldline = [], []
    for i in range(80):
        phi, n, _, vi = hammer_sweeps(phi, n, kappa=kappa, W=W, interval_phi=math.pi,
                                      interval_n=1, p_n=0.1, sweeps=20, worms=1,
                                      max_worm_moves=cap, generator=host)
        m, v, _, wi = worldline_hammer_sweeps(m, v, kappa=kappa, W=W, sweeps=20, worms=1,
                                              max_worm_moves=cap, generator=host)
        if i >= 20:
            villain.append(vi['ActionDensity'].double().cpu().numpy())
            worldline.append(1 - wi['ActionDensity'].double().cpu().numpy())
    per_chain_agreement('ActionDensity: Villain against 1 − Worldline inline',
                        np.array(villain), np.array(worldline))


def phase_worldline_main_path(torch, card):
    import supervillain_tpu_torch as sv
    from supervillain_tpu_torch.ops.worldline import (WorldlineSweepDraws, plain_worldline_sweeps,
                                                      worldline_sweeps)
    from supervillain_tpu_torch.ops.worldline_hammer import worldline_hammer_sweeps
    from supervillain_tpu_torch.ops.worldline_worm import (WorldlineWormDraws,
                                                           plain_worldline_worms, worldline_worms)
    from supervillain_tpu_torch.parallel import TRUNCATION_BUDGET

    N, B, thin, steps, cut, kappa, W = 256, 512, 50, 30, 10, 0.5, 2
    cap = 64 * N * N
    say(f'== phase W4: worldline main path (L={N}, {B} chains, κ={kappa}, W={W}, thin={thin}, '
        f'worms=1 capped at {cap}, {steps} records, cut {cut})')
    S = sv.Worldline(sv.Lattice2D(N), kappa, W=W)
    counters = {'worldline_sweep': worldline_sweeps, 'worldline_worm': worldline_worms,
                'worldline_hammer': worldline_hammer_sweeps}
    for f in counters.values():
        f.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fleet = sv.sample_fused_fleet(S, chains=B, steps=steps, thin=thin, worms=1, seed=0)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items()}
    say(f'  sample_fused_fleet: {elapsed!r} s, {elapsed / steps!r} s per record; '
        f'launches {launches}')
    require(all(v > 0 for v in launches.values()), f'a kernel of the path never launched: {launches}')

    for k in ('ActionDensity', 'Worm_Length', 'Spin_Spin', 'Worm_Truncated'):
        col = fleet.columns[k]
        require(col.shape[:2] == (steps, B) and np.isfinite(col).all(), f'bad column {k}')
    require(np.array_equal(fleet.columns['Worm_Length'], fleet.columns['Spin_Spin'].sum(axis=(2, 3))),
            'Worm_Length differs from the sum of Spin_Spin')
    final = {k: torch.as_tensor(x, device='cuda') for k, x in fleet.final.items()}
    require(divergence_free(torch, final['m']), 'δm != 0 at the end of the main path')
    e = fleet.pooled_ensemble(cut)
    tau = e.autocorrelation_time()
    estimate = sv.Bootstrap(e.every(tau), draws=200, seed=0).estimate('ActionDensity')
    require(all(np.isfinite(estimate)), f'non-finite estimate {estimate}')
    lengths = fleet.columns['Worm_Length'][cut:]
    frac = float(fleet.columns['Worm_Truncated'].sum()) / (steps * B)
    say(f'  inline ActionDensity = {float(estimate[0])!r} ± {float(estimate[1])!r} (τ = {tau}), '
        f'so the registry ActionDensity = {1 - float(estimate[0])!r}; Worm_Length mean '
        f'{float(lengths.mean())!r}, largest {float(lengths.max())!r}; truncated worms {frac!r} '
        f'(budget {TRUNCATION_BUDGET})')
    if frac > TRUNCATION_BUDGET:
        say('  WARNING: truncated-worm fraction above the budget')
    del fleet, e

    # Times at the main path's shape, from its final state.
    m, v = final['m'], final['v']
    host = torch.Generator().manual_seed(27)
    gdev = torch.Generator(device='cuda').manual_seed(28)
    common = dict(kappa=kappa, W=W)
    timed = {
        'worldline_sweep': time_ms(torch, lambda: worldline_sweeps(
            m, v, sweeps=thin, generator=host, **common), 5),
        'worldline_worm': time_ms(torch, lambda: worldline_worms(
            m, v, worms=1, max_worm_moves=cap, generator=host, **common), 5),
        'worldline_hammer': time_ms(torch, lambda: worldline_hammer_sweeps(
            m, v, sweeps=thin, worms=1, max_worm_moves=cap, generator=host, **common), 5),
    }
    ms = {k: t for k, (t, _) in timed.items()}
    sdraws = WorldlineSweepDraws(gdev, B=B, N=N, interval_v=1, interval_t=1, interval_w=1,
                                 winf=False, fdt=torch.float32, idt=torch.int32, device='cuda')
    wdraws = WorldlineWormDraws(gdev, B=B, N=N, fdt=torch.float32, device='cuda')
    plain_sweep_ms, _ = time_ms(torch, lambda: plain_worldline_sweeps(
        m, v, sweeps=thin, draws=sdraws, **common), 1)
    plain_worm_ms, (_, _, plain_length, plain_truncated) = time_ms(torch, lambda: plain_worldline_worms(
        m, v, worms=1, max_worm_moves=WORM_REPLAY_CAP, draws=wdraws, **common), 1)
    capped_ms, _ = time_ms(torch, lambda: worldline_worms(
        m, v, worms=1, max_worm_moves=WORM_REPLAY_CAP, generator=host, **common), 5)
    plain_ms = {'worldline_sweep': plain_sweep_ms, 'worldline_worm': plain_worm_ms,
                'worldline_hammer': plain_sweep_ms + plain_worm_ms}

    # Bounds from this run's inputs: m 2×i32 and v i32 in and out (24 B a site);
    # the worm reads m and v and writes m and its histogram (24 B a site).
    sites = B * N * N
    _, _, worm_length, worm_truncated = timed['worldline_worm'][1]
    moves = worm_moves(worm_length, worm_truncated, 1)
    hammer_inline = timed['worldline_hammer'][1][3]
    hammer_moves = worm_moves(hammer_inline['Worm_Length'], hammer_inline['Worm_Truncated'], 1)
    bounds = {
        'worldline_sweep': bound(24 * sites + 12 * B, OPS_WORLDLINE_SITE * sites * thin),
        'worldline_worm': bound(24 * sites + 8 * B, OPS_WORM_MOVE * moves),
        'worldline_hammer': bound(28 * sites + 20 * B,
                                  OPS_WORLDLINE_SITE * sites * thin + OPS_WORM_MOVE * hammer_moves),
    }
    # B4 by kind of launch, and B5 per move of the longest worm, call by call:
    # a worm is a serial walk, so a call lasts as long as its longest worm.
    kinds = launch_breakdown(torch, lambda: worldline_sweeps(
        m, v, sweeps=thin, generator=host, **common), 3)
    say_breakdown(card, f'worldline sweep kernel by launch kind (torch.profiler, 3 {thin}-sweep '
                  f'calls)', kinds, ms['worldline_sweep'])
    # One record as sample_fused_fleet makes it (the Hammer, then the copy of
    # its inline observables to the host), from the final state.
    kinds, record_ms = profiled(torch, lambda: {k: x.cpu().numpy() for k, x in worldline_hammer_sweeps(
        m, v, sweeps=thin, worms=1, max_worm_moves=cap, generator=host, **common)[3].items()}, 3)
    say_breakdown(card, 'one worldline record (Hammer call and host copy of its inline '
                  'observables, torch.profiler, 3 records)', kinds, record_ms, 'the host clock')
    worm_calls = [timed_call(torch, lambda: worldline_worms(
        m, v, worms=1, max_worm_moves=cap, generator=host, **common)) for _ in range(5)]
    worm_ms = sum(t for t, _ in worm_calls)
    longest = sum(float(out[2].max()) for _, out in worm_calls)
    all_moves = sum(worm_moves(out[2], out[3], 1) for _, out in worm_calls)
    say(f'  [{card}] worldline worm kernel: {worm_ms * 1e6 / longest!r} ns per move of the longest '
        f'worm ({worm_ms!r} ms over 5 calls whose longest worms make {longest!r} moves); '
        f'{all_moves / worm_ms * 1e3!r} moves/s over all {B} chains')

    su = sites * thin
    say(f'  [{card}] worldline sweep kernel {ms["worldline_sweep"]!r} ms per {thin}-sweep call = '
        f'{su / ms["worldline_sweep"] * 1e3!r} site-updates/s; plain {plain_sweep_ms!r} ms; '
        f'bound {bounds["worldline_sweep"]}')
    say(f'  [{card}] worldline worm kernel {ms["worldline_worm"]!r} ms per call (1 worm/chain, '
        f'{moves!r} moves, longest worm {float(worm_length.max())!r}); bound '
        f'{bounds["worldline_worm"]}')
    plain_moves = worm_moves(plain_length, plain_truncated, 1)
    say(f'  [{card}] with worms capped at {WORM_REPLAY_CAP} moves: worm kernel {capped_ms!r} ms, '
        f'plain worm {plain_worm_ms!r} ms ({plain_moves!r} moves, '
        f'{float(plain_truncated.sum())!r} of {B} worms truncated)')
    say(f'  [{card}] worldline hammer {ms["worldline_hammer"]!r} ms per call; plain sweep + plain '
        f'capped worm {plain_ms["worldline_hammer"]!r} ms; bound {bounds["worldline_hammer"]}')
    return launches, ms, plain_ms, bounds, (m, v)


def compare_worldline_sweeps(name, got, want):
    """Sweep outputs (m, v, accepted, inline) of a kernel and its plain twin."""
    diff = got[0] != want[0]
    N = diff.shape[-1]
    cycles = int(diff[:, 0].all(dim=1).sum()) + int(diff[:, 1].all(dim=2).sum())
    links = float(diff.double().mean())
    plaquettes = float((got[1] != want[1]).double().mean())
    inline = float((got[3]['ActionDensity'] - want[3]['ActionDensity']).abs().max())
    say(f'  {name}: m differs at {links!r} of the links ({cycles} whole wrapping cycles, '
        f'{int(diff.sum()) - cycles * N} other links), v at {plaquettes!r} of the plaquettes '
        f'(bound {SAME_DRAWS_SITES}); max |Δ inline ActionDensity| {inline!r} '
        f'(bound {SAME_DRAWS_INLINE})')
    require(links <= SAME_DRAWS_SITES and plaquettes <= SAME_DRAWS_SITES,
            f'{name}: kernel and plain version part on the same draws')
    require(inline <= SAME_DRAWS_INLINE, f'{name}: inline ActionDensity disagrees')
    return inline


def phase_worldline_same_draws(torch, final):
    from supervillain_tpu_torch.ops import kernels
    from supervillain_tpu_torch.ops.worldline import (KernelWorldlineSweepDraws,
                                                      plain_worldline_sweeps, worldline_sweeps)
    from supervillain_tpu_torch.ops.worldline_hammer import worldline_hammer_sweeps
    from supervillain_tpu_torch.ops.worldline_worm import (KernelWorldlineWormDraws,
                                                           plain_worldline_worms, worldline_worms)

    m, v = final
    B, N, thin, kappa, W = m.shape[0], m.shape[-1], 50, 0.5, 2
    say(f'== phase W5: worldline kernels against their plain versions on the kernels\' draws '
        f'(L={N}, {B} chains, {thin} sweeps, 1 worm capped at {WORM_REPLAY_CAP} moves, from '
        f'W4\'s final state)')
    worm_args = dict(kappa=kappa, W=W, worms=1, max_worm_moves=WORM_REPLAY_CAP)

    def seeds(seed, count):
        g = torch.Generator().manual_seed(seed)
        return [kernels.seed_from(g) for _ in range(count)]

    def plain_worm(m, v, seed):
        return plain_worldline_worms(m, v, draws=KernelWorldlineWormDraws(seed, B=B, N=N,
                                                                          device='cuda'),
                                     **worm_args)

    # The Hammer's sweep section draws the first seed of its generator, as the
    # sweep kernel does, so its output is the sweep kernel's: one plain sweep
    # replay serves both, and the Hammer's worm is replayed from the state the
    # kernels' sweep section left (which keeps the sweep's own partings out of
    # the worm's comparison).
    err = {}
    got_sweep = worldline_sweeps(m, v, kappa=kappa, W=W, sweeps=thin,
                                 generator=torch.Generator().manual_seed(31))
    s_sweep, s_worm = seeds(31, 2)
    draws = KernelWorldlineSweepDraws(s_sweep, B=B, N=N, interval_v=1, interval_t=1,
                                      interval_w=1, winf=False, fdt=torch.float32,
                                      idt=torch.int32, device='cuda')
    want = plain_worldline_sweeps(m, v, kappa=kappa, W=W, sweeps=thin, draws=draws)
    err['worldline_sweep'] = compare_worldline_sweeps('worldline sweep', got_sweep, want)

    got_worm = worldline_worms(m, v, generator=torch.Generator().manual_seed(32), **worm_args)
    err['worldline_worm'] = compare_worms('worldline worm', got_worm,
                                          plain_worm(m, v, *seeds(32, 1)))

    got = worldline_hammer_sweeps(m, v, kappa=kappa, W=W, sweeps=thin, worms=1,
                                  max_worm_moves=WORM_REPLAY_CAP,
                                  generator=torch.Generator().manual_seed(31))
    require(torch.equal(got[1], got_sweep[1]) and torch.equal(got[2], got_sweep[2]),
            'the Hammer\'s sweep section differs from the sweep kernel on the same seed')
    worm = plain_worm(got_sweep[0], got_sweep[1], s_worm)
    err_sweep = compare_worldline_sweeps('worldline hammer', (got_sweep[0], *got[1:]), want)
    err_worm = compare_worms('worldline hammer',
                             (got[0], got[3]['Spin_Spin'], got[3]['Worm_Length']), worm)
    err['worldline_hammer'] = max(err_sweep, err_worm)
    torch.cuda.synchronize()
    return err


def main():
    import torch

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device is available', file=sys.stderr)
        return 1
    from supervillain_tpu_torch.ops import kernels

    card = phase_toolchain(torch, kernels)
    phase_build(kernels)
    phase_sweep(torch)
    phase_worm(torch)
    phase_invariants(torch)
    launches, ms, plain_ms, bounds, final = phase_main_path(torch, card)
    err = phase_same_draws(torch, final)
    del final
    phase_worldline_sweep(torch)
    phase_worldline_exact(torch)
    phase_duality(torch)
    w_launches, w_ms, w_plain_ms, w_bounds, w_final = phase_worldline_main_path(torch, card)
    err |= phase_worldline_same_draws(torch, w_final)
    launches |= w_launches
    ms |= w_ms
    plain_ms |= w_plain_ms
    bounds |= w_bounds

    sources = {
        'sweep': ('supervillain_tpu_torch/csrc/sweep.cu', 'supervillain_tpu/ops/pallas_sweep.py:424'),
        'worm': ('supervillain_tpu_torch/csrc/worm.cu', 'supervillain_tpu/ops/pallas_worm.py:215'),
        'hammer': ('supervillain_tpu_torch/ops/hammer.py', 'supervillain_tpu/ops/pallas_hammer.py:420'),
        'worldline_sweep': ('supervillain_tpu_torch/csrc/worldline.cu',
                            'supervillain_tpu/ops/pallas_worldline.py:427'),
        'worldline_worm': ('supervillain_tpu_torch/csrc/worldline_worm.cu',
                           'supervillain_tpu/ops/pallas_worldline_hammer.py:241'),
        'worldline_hammer': ('supervillain_tpu_torch/ops/worldline_hammer.py',
                             'supervillain_tpu/ops/pallas_worldline_hammer.py:412'),
    }
    report = {'kernels': [
        {'name': name, 'route': 'cuda', 'source': src, 'replaces': replaces,
         'launches': launches[name], 'max_abs_err': err[name], 'ms': ms[name],
         'plain_ms': plain_ms[name], 'bound_ms': bounds[name][0], 'bound_by': bounds[name][1],
         'library_ms': None}
        for name, (src, replaces) in sources.items()]}
    say(f'card: {card}')
    say(json.dumps(report))
    say(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                                           'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
