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
   times at that shape;
7. each kernel at the main path's shape against its plain version fed the
   kernel's own Philox draws, from the main path's final state: fields that
   differ on at most 1e-4 of the sites (a flipped Metropolis decision where
   float rounding of ΔS differs), worms that differ on at most 1% of the
   chains, and inline ActionDensity and WindingSquared within 1e-3.

The next-to-last line is a JSON object describing each kernel (its
``max_abs_err`` from phase 7); the last line is ``{"ok": true, "device": {...}}``.
Nothing of JAX is imported.
"""

from __future__ import annotations

import json
import math
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
    """Mean milliseconds per call on the card (CUDA events), after one warm-up."""
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


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
    from supervillain_tpu_torch.ops.sweep import SweepDraws, neighborhood_sweeps, plain_sweeps
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
    say(f'  ActionDensity = {estimate[0]!r} ± {estimate[1]!r} (τ = {tau}); '
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
    ms = {
        'sweep': time_ms(torch, lambda: neighborhood_sweeps(
            phi, n, interval_phi=math.pi, interval_n=1, sweeps=thin, generator=host, **common), 5),
        'worm': time_ms(torch, lambda: classic_worms(
            phi, n, worms=1, max_worm_moves=cap, generator=host, **common), 5),
        'hammer': time_ms(torch, lambda: hammer_sweeps(
            phi, n, interval_phi=math.pi, interval_n=1, sweeps=thin, worms=1,
            max_worm_moves=cap, generator=host, **common), 5),
    }
    plain_sweep_ms = time_ms(torch, lambda: plain_sweeps(phi, n, sweeps=thin, draws=sdraws, **common), 1)
    plain_worm_ms = time_ms(torch, lambda: plain_worms(phi, n, worms=1, max_worm_moves=cap,
                                                       draws=wdraws, **common), 3)
    plain_ms = {'sweep': plain_sweep_ms, 'worm': plain_worm_ms, 'hammer': plain_sweep_ms + plain_worm_ms}
    su = B * N * N * thin
    say(f'  [{card}] sweep kernel {ms["sweep"]!r} ms per {thin}-sweep call = '
        f'{su / ms["sweep"] * 1e3!r} site-updates/s; plain {plain_ms["sweep"]!r} ms = '
        f'{su / plain_ms["sweep"] * 1e3!r} site-updates/s')
    say(f'  [{card}] worm kernel {ms["worm"]!r} ms per call (1 worm/chain); plain {plain_ms["worm"]!r} ms')
    say(f'  [{card}] hammer {ms["hammer"]!r} ms per call; plain sweep + plain worm {plain_ms["hammer"]!r} ms')
    return launches, ms, plain_ms, (phi, n)


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
    from supervillain_tpu_torch.ops.sweep import KernelSweepDraws, neighborhood_sweeps, plain_sweeps
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
    launches, ms, plain_ms, final = phase_main_path(torch, card)
    err = phase_same_draws(torch, final)

    sources = {
        'sweep': ('supervillain_tpu_torch/csrc/sweep.cu', 'supervillain_tpu/ops/pallas_sweep.py:424'),
        'worm': ('supervillain_tpu_torch/csrc/worm.cu', 'supervillain_tpu/ops/pallas_worm.py:215'),
        'hammer': ('supervillain_tpu_torch/ops/hammer.py', 'supervillain_tpu/ops/pallas_hammer.py:420'),
    }
    report = {'kernels': [
        {'name': name, 'route': 'cuda', 'source': src, 'replaces': replaces,
         'launches': launches[name], 'max_abs_err': err[name], 'ms': ms[name],
         'plain_ms': plain_ms[name]}
        for name, (src, replaces) in sources.items()]}
    say(f'card: {card}')
    say(json.dumps(report))
    say(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                                           'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
