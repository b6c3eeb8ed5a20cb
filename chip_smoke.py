#!/usr/bin/env python3
"""Build and run the PyTorch/CUDA port (``supervillain_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit when it fails:

1. toolchain: torch, CUDA, nvcc, triton and the card's name and power limit;
2. build: compile the CUDA kernels from ``supervillain_tpu_torch/csrc``;
3. sweep kernel against its plain PyTorch version on the card (N=16, 1024
   chains): per-chain means of ActionDensity, WindingSquared and acceptance
   within 5 combined standard errors, and, in the plan's regime and in the
   streaming one, the inline ActionDensity of a one-sweep call equal to
   (κ/2)Σ(dφ−2πn)²/Λ of its output to 1e-5 relative and its WindingSquared
   to Σ(dn)²/Λ exactly; the same in the streaming regime at the L=1024
   cell's shape (64 chains, N=1024, 64 bands of rows a chain's sums);
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
   and accepted counts bit for bit, and inline observables within 1e-3;

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

and for the measurement half, downstream of both fleets, on the card:

M1. every observable and derived quantity (and every resampled observable) of
    a short N=8 Hammer fleet of each action (256 chains, W=2), fields and
    inline histograms, measured and bootstrapped on the card and by the same
    code on the CPU in float64 from the same configurations and bootstrap
    seed: relative agreement within 1e-4, the largest difference of each
    printed;
M2. estimators of one correlator against each other at N=8, κ=0.5, W=1 and
    W=2, per-chain means of 512 chains as independent samples: the Worldline
    worm's Spin_Spin_Normalized against its taxicab one and against the
    Villain field's (FFT), the Villain worm's Vortex_Vortex_Normalized against
    its taxicab one, the Villain Winding_Winding against the Worldline one; a
    pull under 5 at Δx (0,1), (1,1), (2,0), (4,4), where a taxicab probe is
    held only if its Kish effective sample size is at least ESS_FRACTION of
    the samples;
M3. the main path's published quantities: the vortex (Villain) and spin
    (Worldline) susceptibilities and critical moments from the per-chain sums
    of phase 6's and W4's inline histograms, and the Villain spin
    susceptibilities from phase 6's final φ, bootstrapped on the card with 100
    draws and printed as Uncertain values, with the seconds each measurement
    and bootstrap took (host clock around a synchronised run), the NumPy
    per-chain sum and a float64 host bootstrap beside them; and the taxicab
    Spin_Spin.Worldline at N=32 over 64 configurations, timed;

and for the general generator path (every eager update, the combinators, both
Hammers and ``sample_fleet``), with the plain twins of B1, B2, B5 and K1 made
to raise if handed a CUDA tensor:

G1. ``sample_fleet`` on the card against the exact N=2 distributions, the cases
    of tests/test_exact_distribution.py (the Worldline Hammer at W=1 and, worm
    capped at 6, at W=2; the Villain ClassicWorm and ChunkedWorm(12) at W=1;
    the W=2 worm unbounded and capped at 8; the z-only ExactNeighborhoodUpdate
    at W=∞): χ²/dof < 3.5 each, and B1, B2, B5 and K1 launched;
G2. ``sample_fleet(S, Hammer(S, fleet=True))``: (a) at L=64, 1024 chains, κ=0.5,
    thin=4 (Villain W=2 on B2, Villain W=1 with the ChunkedWorm on K1, Worldline
    W=2 on B5) against ``sample_fused_fleet`` of the same action and shape,
    per-chain means of the registry ActionDensity after a cut within a pull of
    5, each worm kernel launched once a step; (b) at L=256, 512 chains, thin=4,
    10 records, both actions at W=2 and the Villain action at W=1 (the slice's
    path: the ChunkedWorm on K1), timed: seconds per record, site-updates/s,
    each kernel's launches (the worm's once a step), one record's device time
    by kind against its wall time, and K1's ms per step;
G3. ``Ensemble.generate`` with the generic Villain Hammer on the card (N=8,
    W=2), ``every(2)`` → ``continue_from``, and, where ``h5py`` imports, the h5
    round trip of its generator tree;

and for the general path's last host-driven loops, now kernels of their own
(no Pallas kernel exists for either), after one device-memory round trip is
measured (a thread chasing dependent loads through 256 MiB, ``csrc/probe.cu``):

K1. the ChunkedWorm kernel (``csrc/worm.cu``) against its plain twin fed K1's
    own Philox draws, T=64, κ=0.5, W=1, at L=256 with 512 chains and at N = 5,
    32 and 255 with 256 chains: n differing on at most 1e-4 of the links and
    the worm state or histogram on at most 1% of the chains (phase 7's bounds:
    flips where float rounding of ΔS differs), the closes, lengths and the
    histograms of the chains that agree within 1e-6; the shards [0, 128) and
    [128, 512) with chain0 = 0 and 128 equal to the whole call bit for bit;
    its ms per step (median of 7, CUDA events) beside the plain twin's, the
    bound (n read and written, the histogram zeroed, φ at the two sites each
    move that does not close reads) and the latency floor (T rounds of one
    device-memory round trip);
K2. the D-general Worldline worm kernel (``csrc/worldline_worm_general.cu``)
    against its plain twin on the stream of ``KernelWorldlineWormDraws`` with
    D, both capped at ODD_REPLAY_CAP: D=3 at N = 8 and 16 and D=4 at N=8, W =
    1, 2 and ∞, κ = 0.2 and 0.3, 64 chains, worms differing on at most 1% of
    the chains, δm = 0 bit for bit after every call and every truncated worm
    rolled back exactly; its ms per call at D=4, N=8, κ=0.3, W=1 at the fleet
    cap on a state 20 generic Hammer steps have moved, at 32 and 512 chains,
    and ns per move of the longest worm, beside the bound, the latency floor
    (the longest worm's moves at one round trip of a dependent load through a
    buffer the size of its working set, read whole first: in the L2 cache at
    32 chains) and (capped) the plain twin's ms;

and for the user entry points, the port's scripts run in this process through
``runpy`` with their argv set (``supervillain_tpu_torch/examples/``), every
count at 0 before a phase and read after it, the plain twins of B1, B2, B4 and
B5 made to raise if handed a CUDA tensor, each phase's seconds printed, each
gate |pull| < 4 with the JAX values parsed from the committed logs' text:

E1. ``python -m supervillain_tpu_torch --version`` and ``--license`` as
    subprocesses: exit 0, printing the port's ``meta.version`` and license;
E2. ``bkt-scan.py --L 64 --chains 256 --W 1`` (therm 8·L²) at the 9 κ of
    ``results/bkt-scan-L64.log``: ActionDensity, WindingSq and χ_S/L^(D−2Δ) at
    every κ; B1 launched;
E3. the same at W=2 (one worm a record) at the 8 κ of
    ``results/bkt-scan-W2-L64.log``, χ_V/L^(D−2Δ_V) gated as well; B1 and
    B2 (B3) launched;
E4. ``bkt-scan.py`` at its defaults (L=256, 32 chains, W=1, B1 resident)
    at κ=0.74, therm L²/2: ActionDensity and WindingSq against that row of
    ``results/bkt-scan-L256.log``, and χ_S/L^(D−2Δ);
E5. ``pod-fleet.py --thin 64 --steps 96`` (10240 chains, L=64, κ=0.74): its
    ActionDensity and WindingSquared against ``results/pod-fleet.log``, and
    its site-updates/s; run again with ``--mesh``, the same fleet bit for bit;
E6. ``self-dual-fused.py --L 64`` (W=∞, κ=1/2π): the duality pull, and each
    side's ActionDensity against 1/2; B1 in z-mode, B2, B4 and B5 launched;
E7. ``winf-line.py --Ls 64 128`` at κ=1/π: η_eff against the exact 1/(2πκ);
E8. ``end-to-end.py`` (Villain, and Worldline at W=2), ``action-comparison.py``,
    the two algorithm comparisons, ``no-vortices.py``, ``why-measure-inline.py``
    (at an even N and E8_CONFIGURATIONS) and ``fleet-scan.py`` at its own
    defaults (100 records, cut 25; also with ``--mesh``, the same fleets bit
    for bit): each exits 0, each comparison of two estimates of one quantity
    within 4, and B1, B2, B5 and K1 launched;

and for odd N, where the torus needs four colors (B1 and B4 read each site's
color from a table; B2 and B5 index any N):

O1. B1, B2, B4 and B5 at N = 5, 7, 11 (256 chains; B1 at W = 1, 2 and ∞, B2 at
    W = 1, 2 and ∞, B4 and B5 at W = 1, 2 and ∞) and at N = 255 (512 chains)
    against their plain twins fed the kernels' draws, as phases 7 and W5
    compare them; dn ≡ 0 (mod W), dn = 0 at W=∞ and δm = 0 bitwise after every
    call; each kernel's time per call at N = 255 beside N = 256 (512 chains; 50
    sweeps, or one worm a chain) with its bound, and B5's nanoseconds per move
    of the longest worm at both; and at even N the digests of
    the four kernels' outputs on fixed inputs and seeds equal to those of the
    kernels at commit ef03d56 (EVEN_N_DIGESTS);
O2. the six eager-generator scripts of E8 at their own default (odd) N and
    O2_CONFIGURATIONS, gated as E8 is;

and for general D, where no TPU kernel exists (they are D=2 only): the
Villain path runs PyTorch operations on the card, every kernel's count read
as 0 after D2 and D4, and the Worldline worm is K2:

D1. the calculus (d, δ, the incidence sums, the Laplacian, ★, ∧, push, pull),
    the sparse functions and ``Form`` at D = 3, 4 on the card against the port
    on the CPU: integer forms bit for bit, float32 to 1e-5 relative; and the
    topological observables at D=4 measured and bootstrapped on the card
    against the CPU in float64 (1e-4 relative);
D2. ``d4-topology.py`` at the shape of each committed log (N=8, 32 chains,
    60×2 steps, κ 0.2/0.4/0.6 at W=1 and W=∞; N=12, 16 chains, 40×2 steps,
    κ=0.4 at W=1): ActionDensity, WindingSquared and ⟨Q²⟩·Λ against the logs
    within |pull| < 4, and WindingSquared ≡ 0 and Q ≡ 0 at W=∞; and at W=∞
    (128 chains × 240 steps) ⟨ActionDensity⟩ against the exact free-field
    value (Λ − 1)/(2Λ), per-chain means within |pull| < 4;
D3. the generic Worldline Hammer at D = 3 and 4 (N=8, 16 steps, 32 chains on
    the card, plain twins refused): κ=0.2, W=1 at both D, also on the CPU (8
    chains), per-chain means of card and CPU within |pull| < 4; W=2 at D=3 and
    κ=0.3 at D=4 (worms of thousands of moves) on the card alone; δm = 0
    bitwise on every kept draw, finite ActionDensity, and K2 launched once a
    step of each card fleet and no other kernel;
D4. ``benchmark/dimension.py`` at D=4, N=8, 32 to 8192 chains: site-updates/s;

and for the chain mesh (``parallel/mesh.py``, ``parallel/distributed.py``),
where every kernel counts its Philox stream from its batch's global first
chain, ``chain0``:

P1. B1 (resident at N=256, table at N=255), B2, B4 (N=256 and 255) and B5 on
    512 chains, one call each, against the same calls on the shards [0, 128)
    and [128, 512) with chain0 = 0 and 128: every output row equal bit for
    bit; the second shard against its plain version fed the Philox draws from
    chain0 = 128, under phase 7's bounds;
P2. ``sample_fused_fleet`` with the Villain Hammer (W=1) and the Worldline
    Hammer (W=2) at the main path's width (3 records), and ``sample_fleet``
    with the generic Villain Hammer(fleet=True) at L=64 (1024 chains, W=2, and
    W=1 with K1), each over cuda:0 alone (the unsharded reference), with
    mesh=None, over
    ``chain_mesh()`` and over the card listed 4 times: equal columns, stats
    and final bit for bit, and each one's seconds per record;
P3. two processes over gloo (``torch.multiprocessing``, file init) on the one
    card, each with its 256 chains of P2's fused fleets: both return P2's
    unsharded fleets bit for bit (digests), with no collective inside the
    records and one gather after them, joined within P3_LIMIT seconds;
P4. ``python -m supervillain_tpu_torch.benchmark.scaling``: its one-card row
    (no efficiency on one card) and its collective audit (0 inside the
    records), with the card's name and power limit;

and for the space axis (``parallel/space.py``: each chain's last axis cut into
slabs with ghost columns, a halo exchange before each step and each later
color pass, CohomologyUpdate on its gathered slices, the worms and
WrappingUpdate on the gathered chain) and the worm's cost:

S1. B1's slab entry at N=SLAB_N (4 chains) split 2 and 4 ways: one sweep (the
    slab residual, a pass, a halo exchange, a pass) against its plain twin on
    the kernel's Philox draws cut to each slab (sites that differ: rounding
    flips only, under phase 7's bound) and against the whole torus's call on
    the same seed (equal bit for bit, accepted counts too), with the largest
    |Δφ| and |Δr| against the plain twin; the ms per color pass with
    its halo exchange, the exchange's share, the plain twin's time and the
    bound, beside the whole torus's one-sweep call;
S2. ``sample_fleet`` over chain × space meshes of cuda:0 listed 2 and 4 times
    (1×2, 2×2, 1×4): the W=2 Villain Hammer(fleet=True) at N=8 (κ = 0.5, the
    shape of __graft_entry__.py's dry run, and 0.1, where n moves), the W=2
    Worldline Hammer and the W=1 Villain Hammer (its ChunkedWorm, K1, on the
    gathered chain) at N=8, and NeighborhoodUpdate at L=1024 with one chain a
    chains-row, each against the unsharded fleet on one card: fields bit for
    bit, stats to 1e-5 relative, dn ≡ 0 (mod W) and δm = 0 on every record;
    the counts set to 0 after the references, the plain twins (and the slab
    entry's) refused on CUDA tensors, the slab entry, B2, B5 and K1 launched
    and the whole torus's sweep not;
S3. ``benchmark/scaling.py``'s audits: a space-sharded Hammer step makes halo
    exchanges, and a chain mesh's records no collective;
WC. ``benchmark/worm_cost.py`` (its main) at L=64 and 256, W=1 and 2, 256
    chains, and with ``--chunked 64``: one JSON line per (L, W), each share in
    [0, 1].

The next-to-last line is a JSON object describing each kernel, B1–B6 and K1,
K2 (its ``max_abs_err`` from the same-draws phases, its launches on its main
path (K1: G2b's; K2: D3's), its time, its plain version's time and the least
time the card could take for the same work, and for K1 and K2 the latency
floor beside it; ``launches_by_path`` splits its launches by the path that
made them, ``launches_by_parity`` by even and odd N, and ``at_N255`` and
``at_N256_same_run`` give O1's times and bounds; B1's ``slab_entry`` gives
S2's launches of the slab entry and S1's times and bounds by split); the last
line is ``{"ok": true, "device": {...}}``.  Nothing of JAX is imported.
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
MEASURE_RTOL = 1e-4    # float32 measurement on the card against float64 on the CPU (M1)
PULL_BOUND = 5.0       # estimators of one correlator against each other (M2)
# A taxicab estimator averages reweighting factors e^{-ΔS} whose logarithm
# spreads as the path grows; where a few samples carry the average its
# bootstrap error means nothing, so M2 holds a taxicab probe to PULL_BOUND only
# where Kish's effective sample size is at least this fraction of the samples.
ESS_FRACTION = 0.1

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
    from supervillain_tpu_torch.ops.sweep import (STREAMING_PLAN, SweepDraws, kernel_sweeps,
                                                  lattice, neighborhood_sweeps, plain_sweeps,
                                                  sum_bands, sweep_plan)

    say('== phase 3: sweep kernel against its plain version (N=16, 1024 chains, κ=0.5, W=1); '
        'the one-sweep inline sums also streaming at N=1024, 64 chains')
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

    def one_sweep_inline(phi, n, plan):
        """A one-sweep call's inline sums against its output fields."""
        N = phi.shape[-1]
        L = lattice(N)
        phi1, n1, _, inline = kernel_sweeps(phi, n, plan, kappa=kappa, W=W, interval_phi=math.pi,
                                            interval_n=1, sweeps=1, generator=host)
        r = calculus.d(L, 0, phi1.double()) - 2 * math.pi * n1.double()
        recomputed = (kappa / 2) * (r * r).sum(dim=(1, 2, 3)) / (N * N)
        rel = ((inline['ActionDensity'].double() - recomputed).abs()
               / recomputed.abs()).max().item()
        dn = calculus.d(L, 1, n1.long())
        exact = torch.equal(inline['WindingSquared'],
                            ((dn * dn).sum(dim=(1, 2, 3)).double() / (N * N)).float())
        say(f'  one-sweep inline ActionDensity vs recomputed ({plan.regime}, {phi.shape[0]} '
            f'chains, N={N}, {sum_bands(N)} bands a chain when streaming): max relative error '
            f'{rel!r} (bound {INLINE_RTOL}); WindingSquared exact: {exact}')
        require(rel < INLINE_RTOL, 'inline ActionDensity disagrees with the output fields')
        require(exact, 'inline WindingSquared disagrees with the output n')

    # In the plan's regime and in the streaming one, from the state above; then
    # the streaming regime at the L=1024 cell's shape, where a chain's sums
    # run in bands, from a hot start after 20 sweeps.
    for plan in (sweep_plan(N), STREAMING_PLAN):
        one_sweep_inline(*final, plan)
    B, N = 64, 1024
    g = torch.Generator().manual_seed(5)
    phi = ((torch.rand((B, 1, N, N), generator=g) - 0.5) * 2 * math.pi).to(dev)
    n = torch.zeros((B, 2, N, N), dtype=torch.int32, device=dev)
    phi, n, _, _ = kernel_sweeps(phi, n, STREAMING_PLAN, kappa=kappa, W=W, interval_phi=math.pi,
                                 interval_n=1, sweeps=20, generator=host)
    one_sweep_inline(phi, n, STREAMING_PLAN)


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
    from supervillain_tpu_torch.ops.sweep import (STREAMING_PLAN, SweepDraws, bands,
                                                  kernel_sweeps, neighborhood_sweeps, plain_sweeps,
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
    # What M3 measures: the per-chain sums of the kept histograms, reduced on
    # the host as a user of the fleet's columns would, and the final φ.
    t0 = time.perf_counter()
    sums = fleet.columns['Vortex_Vortex'][cut:].sum(axis=0)
    kept = {'action': S, 'Vortex_Vortex': sums, 'phi': fleet.final['phi'],
            'reduce_s': time.perf_counter() - t0, 'record_s': elapsed / steps,
            'records': steps - cut}

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
    say(f'  [{card}] sweep plan at N={N}: {plan}; '
        f'bands (first row, rows) {bands(N, plan.cluster)}; '
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
    return launches, ms, plain_ms, bounds, (phi, n), kept


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
        f'equal {same}; max |Δ inline| {inline!r} (bound {SAME_DRAWS_INLINE})')
    require(all(same), 'the resident and streaming sweep regimes differ on one seed')
    require(inline <= SAME_DRAWS_INLINE, 'the resident and streaming inline sums differ')
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
    t0 = time.perf_counter()
    sums = fleet.columns['Spin_Spin'][cut:].sum(axis=0)
    kept = {'action': S, 'Spin_Spin': sums, 'reduce_s': time.perf_counter() - t0,
            'record_s': elapsed / steps, 'records': steps - cut}
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
    return launches, ms, plain_ms, bounds, (m, v), kept


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


# -- the measurement half: observables, derived quantities, bootstrap ----------

def relative_difference(card, cpu):
    """max |card − cpu| over max |cpu| (norm-wise, so entries near zero count
    for what they weigh)."""
    card, cpu = np.asarray(card, dtype=np.complex128), np.asarray(cpu, dtype=np.complex128)
    return float(np.abs(card - cpu).max() / max(np.abs(cpu).max(), 1e-300))


def short_fleet(sv, S, chains, steps, thin, seed):
    """A Hammer fleet on the card with its fields kept (W3's zero-inflated Δn
    for the Villain sweep, which thermalizes it sooner)."""
    villain = isinstance(S, sv.Villain)
    return sv.sample_fused_fleet(S, chains=chains, steps=steps, thin=thin, worms=1,
                                 keep_fields=True, seed=seed, p_n=0.1 if villain else None)


def d2_names(registry):
    """The sorted names of a registry's quantities that D=2 measures: all but
    the D=4-only topological ones (held at D=4 by phase D1)."""
    from supervillain_tpu_torch.observables import topological
    return sorted(name for name, cls in registry.items() if cls.__module__ != topological.__name__)


def phase_card_against_cpu(torch):
    """M1: every observable and derived quantity measured and bootstrapped on
    the card against the same port code on the CPU in float64."""
    import supervillain_tpu_torch as sv
    from supervillain_tpu_torch.observables import derived_registry, registry

    primaries_2d, derived_2d = d2_names(registry), d2_names(derived_registry)
    N, B, kappa, W = 8, 256, 0.5, 2
    say(f'== phase M1: measurement on the card against the CPU in float64 (N={N}, {B} chains, '
        f'κ={kappa}, W={W}; relative bound {MEASURE_RTOL})')
    worst = 0.0
    for Action, histogram in ((sv.Villain, 'Vortex_Vortex'), (sv.Worldline, 'Spin_Spin')):
        S = Action(sv.Lattice2D(N), kappa, W=W)
        fleet = short_fleet(sv, S, B, steps=3, thin=20, seed=41)
        last = {k: v[-1] for k, v in fleet.columns.items()}
        prefix = histogram.split('_')[0]
        cases = (
            ('fields', {k: last[k] for k in S.fields}, primaries_2d, derived_2d),
            ('inline histogram', {histogram: last[histogram]}, [histogram],
             [f'{histogram}_Normalized', f'{prefix}Susceptibility',
              f'{prefix}SusceptibilityScaled', f'{prefix}CriticalMoment']))
        for label, columns, primaries, derived in cases:
            values = {}
            for device in ('cuda', 'cpu'):
                e = sv.Ensemble(S).from_configurations(sv.Configurations(dict(columns)),
                                                       device=device)
                boot = sv.Bootstrap(e, draws=100, seed=3)
                values[device] = {**{name: getattr(e, name) for name in primaries},
                                  **{f'Bootstrap.{name}': getattr(boot, name)
                                     for name in primaries + derived}}
            diffs = {name: relative_difference(values['cuda'][name], values['cpu'][name])
                     for name in values['cpu']}
            say(f'  {type(S).__name__}, {label}: largest relative difference of each')
            for name, d in diffs.items():
                say(f'    {name}: {d!r}')
            worst = max(worst, *diffs.values())
            bad = {k: d for k, d in diffs.items() if not d <= MEASURE_RTOL}
            require(not bad, f'M1: card and CPU disagree on {bad}')
    say(f'  worst relative difference {worst!r} (bound {MEASURE_RTOL})')


def effective_fraction(values):
    """Kish's effective sample size of positive reweighting samples, (Σx)²/Σx²,
    as a fraction of their number, at every displacement of (samples, N, N)."""
    x = np.abs(np.asarray(values, dtype=np.float64))
    return x.sum(axis=0) ** 2 / np.maximum((x ** 2).sum(axis=0), 1e-300) / len(x)


def pull(m1, e1, m2, e2):
    """|m1 − m2| in combined standard errors (0 where the two are equal)."""
    diff, scale = abs(float(m1) - float(m2)), math.hypot(float(e1), float(e2))
    return 0.0 if diff == 0 else diff / scale if scale > 0 else math.inf


def per_chain_means(values, records, chains):
    """(records·chains, ...) values pooled record-major → (chains, ...) means."""
    return np.asarray(values).reshape((records, chains) + np.shape(values)[1:]).mean(axis=0)


def phase_estimators(torch):
    """M2: estimators of the same correlator against each other, with
    per-chain means as independent samples."""
    import supervillain_tpu_torch as sv

    N, B, kappa, steps, cut, thin = 8, 512, 0.5, 60, 20, 20
    probes = ((0, 1), (1, 1), (2, 0), (4, 4))
    say(f'== phase M2: estimators against each other (N={N}, {B} chains, κ={kappa}, '
        f'{steps - cut} records of {thin} sweeps and a worm after {cut}; pull bound {PULL_BOUND} '
        f'at Δx in {probes})')
    for W in (1, 2):
        chains, ess = {}, {}
        for Action in (sv.Villain, sv.Worldline):
            S = Action(sv.Lattice2D(N), kappa, W=W)
            e = short_fleet(sv, S, B, steps, thin, seed=50 + W).pooled_ensemble(cut)
            records = steps - cut
            name = type(S).__name__
            histogram = 'Vortex_Vortex' if name == 'Villain' else 'Spin_Spin'
            columns = {'worm': getattr(e, histogram), 'Winding_Winding': e.Winding_Winding}
            del e.configuration.fields[histogram]      # measure it again, by the taxicab
            columns['taxicab'] = getattr(e, histogram)
            ess[name] = effective_fraction(columns['taxicab'])
            if name == 'Villain':
                columns['field spin'] = e.Spin_Spin
            for k, v in columns.items():
                chains[name, k] = per_chain_means(v, records, B)

        def estimate(S, name, column, derived):
            e = sv.Ensemble(S).from_configurations(sv.Configurations({name: column}))
            value = getattr(sv.Bootstrap(e, draws=200, seed=W), derived).real
            return value.mean(axis=0), value.std(axis=0)

        V = sv.Villain(sv.Lattice2D(N), kappa, W=W)
        WL = sv.Worldline(sv.Lattice2D(N), kappa, W=W)
        everywhere = np.ones((N, N))
        pairs = (
            ('Spin_Spin_Normalized: Worldline worm against Worldline taxicab',
             (WL, 'Spin_Spin', chains['Worldline', 'worm']),
             (WL, 'Spin_Spin', chains['Worldline', 'taxicab']), 'Spin_Spin_Normalized',
             ess['Worldline']),
            ('Spin_Spin_Normalized: Villain field (FFT) against Worldline worm',
             (V, 'Spin_Spin', chains['Villain', 'field spin']),
             (WL, 'Spin_Spin', chains['Worldline', 'worm']), 'Spin_Spin_Normalized', everywhere),
            ('Vortex_Vortex_Normalized: Villain worm against Villain taxicab',
             (V, 'Vortex_Vortex', chains['Villain', 'worm']),
             (V, 'Vortex_Vortex', chains['Villain', 'taxicab']), 'Vortex_Vortex_Normalized',
             ess['Villain']),
            ('Winding_Winding: Villain against Worldline',
             (V, 'Winding_Winding', chains['Villain', 'Winding_Winding']),
             (WL, 'Winding_Winding', chains['Worldline', 'Winding_Winding']), 'Winding_Winding',
             everywhere),
        )
        for label, a, b, derived, fraction in pairs:
            (ma, ea), (mb, eb) = estimate(*a, derived), estimate(*b, derived)
            pulls = [pull(ma[dx], ea[dx], mb[dx], eb[dx]) for dx in probes]
            held = [fraction[dx] >= ESS_FRACTION for dx in probes]
            say(f'  W={W} {label}: ' + '; '.join(
                f'{dx} {float(ma[dx])!r}±{float(ea[dx])!r} vs {float(mb[dx])!r}±'
                f'{float(eb[dx])!r} pull {p:.3f}'
                + ('' if h else f' (not held: taxicab ESS {float(fraction[dx])!r} of the samples)')
                for dx, p, h in zip(probes, pulls, held)))
            bad = [p for p, h in zip(pulls, held) if h and not p < PULL_BOUND]
            require(not bad, f'M2: W={W} {label} disagree (pulls {pulls})')


def timed_s(torch, fn):
    """Seconds of ``fn`` on the host clock, the card synchronised before and
    after, and its result."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def phase_published_quantities(torch, card, villain, worldline):
    """M3: the main path's published quantities, measured and bootstrapped on
    the card, with the seconds each step took."""
    import supervillain_tpu_torch as sv

    draws = 100
    say(f'== phase M3: the main path\'s published quantities on the card (L=256, 512 chains, '
        f'{draws} bootstrap draws)')
    for kept, histogram in ((villain, 'Vortex_Vortex'), (worldline, 'Spin_Spin')):
        S = kept['action']
        prefix = histogram.split('_')[0]
        e = sv.Ensemble(S).from_configurations(sv.Configurations({histogram: kept[histogram]}))
        boot_s, boot = timed_s(torch, lambda: sv.Bootstrap(e, draws=draws, seed=0))
        names = [f'{prefix}Susceptibility', f'{prefix}SusceptibilityScaled',
                 f'{prefix}CriticalMoment']
        seconds, values = timed_s(torch, lambda: {n: getattr(boot, n) for n in names})
        # A draw's derived quantities are defined where its resampled histogram
        # holds tallies at the origin, by which they are normalized.
        defined = getattr(boot, histogram)[:, 0, 0] > 0
        require(all(np.isfinite(v[defined]).all() for v in values.values()),
                f'M3: non-finite {names} in draws with tallies at the origin')
        report = ', '.join(f'{n} = {sv.Uncertain(v[defined].mean(), v[defined].std())}'
                           for n, v in values.items()) if defined.any() else 'undefined'
        say(f'  {type(S).__name__}, per-chain sums of {kept["records"]} records of the inline '
            f'{histogram} ({float(kept[histogram][:, 0, 0].sum())!r} tallies at the origin over '
            f'all chains; {int(defined.sum())} of {draws} draws hold some): {report}')
        # The same bootstrap on the host CPU, in float64, for comparison.
        cpu = sv.Ensemble(S).from_configurations(sv.Configurations({histogram: kept[histogram]}),
                                                 device='cpu')
        cpu_s, _ = timed_s(torch, lambda: getattr(sv.Bootstrap(cpu, draws=draws, seed=0),
                                                  names[0]))
        say(f'  [{card}] {type(S).__name__} histograms: NumPy per-chain sum on the host '
            f'{kept["reduce_s"]!r} s; bootstrap on the card {boot_s + seconds!r} s ({draws} '
            f'draws, the product and the three derived quantities), on the host CPU in float64 '
            f'{cpu_s!r} s (the product and {names[0]}); a record of the fleet '
            f'{kept["record_s"]!r} s')

        if histogram == 'Vortex_Vortex':
            field = sv.Ensemble(S).from_configurations(sv.Configurations({'phi': kept['phi']}))
            measure_s, spin = timed_s(torch, lambda: field.Spin_Spin)
            B, _, N, _ = kept['phi'].shape
            require(spin.shape == (B, N, N) and np.isfinite(spin).all(),
                    'M3: bad Spin_Spin of the final φ')
            names = ['SpinSusceptibility', 'SpinSusceptibilityScaled']
            seconds, values = timed_s(torch, lambda: {
                n: getattr(b, n) for b in [sv.Bootstrap(field, draws=draws, seed=0)] for n in names})
            require(all(np.isfinite(v).all() for v in values.values()), f'M3: non-finite {names}')
            report = ', '.join(f'{n} = {sv.Uncertain(v.mean(), v.std())}' for n, v in values.items())
            say(f'  Villain, Spin_Spin.Villain of the final φ of {B} chains: {report}')
            say(f'  [{card}] Spin_Spin.Villain (FFT) of {B} fields of {N}²: {measure_s!r} s; '
                f'its bootstrap and derived quantities {seconds!r} s')

    # The taxicab route at N=32: O(N⁵) gathers a configuration.
    S = sv.Worldline(sv.Lattice2D(32), 0.5, W=2)
    fleet = sv.sample_fused_fleet(S, chains=64, steps=1, thin=20, worms=1, keep_fields=True,
                                  seed=61)
    e = sv.Ensemble(S).from_configurations(sv.Configurations(
        {k: fleet.columns[k][-1] for k in S.fields}))
    e.Links
    seconds, taxicab = timed_s(torch, lambda: e.Spin_Spin)
    require(taxicab.shape == (64, 32, 32) and np.isfinite(taxicab).all(), 'M3: bad taxicab')
    say(f'  [{card}] Spin_Spin.Worldline (taxicab) at N=32 over 64 configurations: {seconds!r} s '
        f'({seconds / 64 * 1e3!r} ms a configuration)')


# -- the general generator path: eager updates, combinators, Hammers, sample_fleet --

#: The plain twins of the kernels that the general path's eager steps (B1, its
#: slab entry, B2, B5) and the ported scripts (those and B4) reach.
PLAIN_TWINS = (('supervillain_tpu_torch.ops.sweep', 'plain_sweeps'),
               ('supervillain_tpu_torch.ops.sweep', 'plain_slab_pass'),
               ('supervillain_tpu_torch.ops.worm', 'plain_worms'),
               ('supervillain_tpu_torch.ops.worm', 'plain_chunked_worms'),
               ('supervillain_tpu_torch.ops.worldline_worm', 'plain_worldline_worms'),
               ('supervillain_tpu_torch.ops.worldline', 'plain_worldline_sweeps'))


class PlainTwinsRefused:
    """Inside the block a plain twin of PLAIN_TWINS handed a CUDA tensor
    raises: on the card the eager steps and the scripts must launch the
    kernels, never their twins."""

    def __enter__(self):
        import importlib
        import torch
        self.saved = []
        for module_name, name in PLAIN_TWINS:
            module = importlib.import_module(module_name)
            plain = getattr(module, name)

            def guard(*args, _plain=plain, _name=name, **kwargs):
                if any(isinstance(a, torch.Tensor) and a.is_cuda
                       for a in (*args, *kwargs.values())):
                    raise SmokeFailure(f'{_name} was entered with a CUDA tensor')
                return _plain(*args, **kwargs)

            setattr(module, name, guard)
            self.saved.append((module, name, plain))
        return self

    def __exit__(self, *exc):
        for module, name, plain in self.saved:
            setattr(module, name, plain)
        return False


def general_counters():
    from supervillain_tpu_torch.ops.sweep import neighborhood_sweeps
    from supervillain_tpu_torch.ops.worldline_worm import worldline_worms, worldline_worms_general
    from supervillain_tpu_torch.ops.worm import chunked_worms, classic_worms
    return {'sweep': neighborhood_sweeps, 'worm': classic_worms, 'worldline_worm': worldline_worms,
            'chunked_worm': chunked_worms, 'worldline_worm_general': worldline_worms_general}


def worldline_distribution(W):
    """Exact distribution of u = m − δv/W on the 2×2 lattice (κ = WKAPPA),
    keyed by the int8 bytes of W·u: every closed integer m with |m| ≤ 3 and
    every v in {0..W−1} per plaquette (v → v + W·f only moves m by δf), which
    is complete for max |u| ≤ 2.5; states beyond that pool into one bin."""
    import torch
    from supervillain_tpu_torch.ops import calculus
    from supervillain_tpu_torch.ops.sweep import lattice
    forms, _ = enumerate_closed_forms(2, cutoff=3)
    weight_of = {}
    for v in np.ndindex(*(W,) * 4):
        dv = calculus.delta(lattice(2), 2, torch.tensor(v).reshape(1, 1, 2, 2))[0].numpy()
        keys = (W * forms.astype(np.int16) - dv).astype(np.int8)
        weights = np.exp(-((keys / W) ** 2).sum(axis=(1, 2, 3)) / (2 * WKAPPA))
        weight_of.update(zip((k.tobytes() for k in keys), weights))
    inside = {k: w for k, w in weight_of.items()
              if np.abs(np.frombuffer(k, dtype=np.int8)).max() <= 2.5 * W}
    Z = sum(weight_of.values())
    prob_of = {k: w / Z for k, w in inside.items()}
    prob_of[b'overflow'] = 1 - sum(prob_of.values())
    return prob_of


def chi2_of_worldline(samples, W):
    """χ²/dof of sampled W·u (draws, 2, 2, 2) against :func:`worldline_distribution`."""
    prob_of = worldline_distribution(W)
    counts = {}
    for x in np.rint(samples).astype(np.int8):
        k = x.tobytes() if np.abs(x).max() <= 2.5 * W else b'overflow'
        require(k in prob_of, 'sampled a state with δu != 0')
        counts[k] = counts.get(k, 0) + 1
    chi2, dof = chi2_against(prob_of, counts, len(samples))
    require(dof >= 5, f'too few populated bins ({dof})')
    return chi2 / dof


def chi2_of_exact_forms(samples):
    """χ²/dof of sampled n (draws, 2, 2, 2) against the Boltzmann distribution
    of the exact forms n = dz (φ frozen at 0, |z| ≤ 3, z at the origin 0)."""
    forms = {}
    for zrow in np.ndindex(*(7,) * 3):
        z = np.concatenate([[0], np.asarray(zrow) - 3]).reshape(2, 2)
        n = np.stack([np.roll(z, -1, axis=mu) - z for mu in range(2)])
        forms.setdefault(n.astype(np.int8).tobytes(),
                         np.exp(-(VKAPPA / 2) * ((2 * np.pi * n) ** 2).sum()))
    Z = sum(forms.values())
    prob_of = {k: w / Z for k, w in forms.items()}
    counts = {}
    for x in samples.astype(np.int8):
        require(x.tobytes() in prob_of, 'sampled n is not an exact form (dz)')
        counts[x.tobytes()] = counts.get(x.tobytes(), 0) + 1
    chi2, dof = chi2_against(prob_of, counts, len(samples))
    require(dof >= 5, f'too few populated bins ({dof})')
    return chi2 / dof


def phase_general_exact(torch):
    """G1: sample_fleet on the card against the exact N=2 distributions, the
    cases of tests/test_exact_distribution.py."""
    import supervillain_tpu_torch as sv
    from supervillain_tpu_torch.generators import villain as gv, worldline as gw
    from supervillain_tpu_torch.ops import calculus
    from supervillain_tpu_torch.ops.sweep import lattice

    say('== phase G1: the general generators against the exact N=2 distributions '
        '(sample_fleet on the card; plain twins refused on CUDA tensors)')
    cut = 20
    counters = general_counters()
    for f in counters.values():
        f.launches = 0

    def worldline_u(fleet, W):
        m = torch.as_tensor(fleet.columns['m'][cut:].reshape(-1, 2, 2, 2)).long()
        v = torch.as_tensor(fleet.columns['v'][cut:].reshape(-1, 1, 2, 2)).long()
        return (W * m - calculus.delta(lattice(2), 2, v)).numpy()

    def villain_n(fleet):
        return fleet.columns['n'][cut:].reshape(-1, 2, 2, 2)

    SW1 = sv.Worldline(sv.Lattice2D(2), WKAPPA, W=1)
    SW2 = sv.Worldline(sv.Lattice2D(2), WKAPPA, W=2)
    SV1 = sv.Villain(sv.Lattice2D(2), VKAPPA, W=1)
    SV2 = sv.Villain(sv.Lattice2D(2), VKAPPA, W=2)
    SVI = sv.Villain(sv.Lattice2D(2), VKAPPA, W=float('inf'))
    worldline = dict(chains=48, steps=120, thin=4)
    villain = dict(chains=64, steps=100)
    cases = (
        ('Worldline Hammer, W=1', SW1, gw.Hammer(SW1), dict(worldline, seed=7),
         lambda f: chi2_of_closed_forms(worldline_u(f, 1))),
        ('Worldline Hammer, W=2, worm capped at 6', SW2, gw.Hammer(SW2, max_worm_moves=6),
         dict(worldline, seed=17), lambda f: chi2_of_worldline(worldline_u(f, 2), 2)),
        ('Villain ClassicWorm, W=1', SV1, gv.ClassicWorm(SV1), dict(villain, thin=4, seed=11),
         lambda f: chi2_of_samples(villain_n(f), 1)),
        ('Villain ChunkedWorm(12), W=1', SV1, gv.ChunkedWorm(SV1, moves_per_step=12),
         dict(villain, thin=4, seed=11), lambda f: chi2_of_samples(villain_n(f), 1)),
        ('Villain ClassicWorm, W=2', SV2, gv.ClassicWorm(SV2), dict(villain, thin=4, seed=13),
         lambda f: chi2_of_samples(villain_n(f), 2)),
        ('Villain ClassicWorm, W=2, capped at 8', SV2, gv.ClassicWorm(SV2, max_moves=8),
         dict(villain, thin=16, seed=13), lambda f: chi2_of_samples(villain_n(f), 2)),
        ('ExactNeighborhoodUpdate(interval_phi=0), W=∞', SVI,
         gv.ExactNeighborhoodUpdate(SVI, interval_phi=0.0), dict(villain, thin=4, seed=23),
         lambda f: chi2_of_exact_forms(villain_n(f))),
    )
    with PlainTwinsRefused():
        for label, S, G, args, chi2 in cases:
            seconds, fleet = timed_s(torch, lambda: sv.sample_fleet(S, G, bound_worms='off',
                                                                    **args))
            ratio = chi2(fleet)
            say(f'  {label}: χ²/dof = {ratio:.3f} over {(args["steps"] - cut) * args["chains"]} '
                f'draws (bound {CHI2_BOUND}); {seconds:.2f} s')
            require(ratio < CHI2_BOUND, f'G1: {label} misses the exact distribution')
    launches = {k: f.launches for k, f in counters.items()}
    say(f'  kernel launches in G1: {launches}')
    require(all(launches[k] > 0 for k in ('sweep', 'worm', 'worldline_worm', 'chunked_worm')),
            f'G1: a kernel never launched: {launches}')
    return launches


def kept_fields(sv, fleet, cut):
    """The fleet's kept fields after ``cut`` records as one pooled ensemble, so
    that ActionDensity is the registry observable measured on them: a fused
    fleet's pooled ensemble would return its inline column of that name (for
    the Worldline action 1 minus the registry's, ROADMAP C4)."""
    S = fleet.Action
    return sv.Ensemble(S).from_configurations(sv.Configurations(
        {k: fleet.columns[k][cut:].reshape((-1,) + fleet.columns[k].shape[2:])
         for k in S.fields}))


def record_profile(torch, card, label, G, fleet, thin):
    """One record (``thin`` generator steps from the fleet's final state and
    the host copy of its inline observables), profiled: device time by kind
    against the wall time."""
    rng = torch.Generator(device='cuda').manual_seed(99)
    cfg = {k: torch.as_tensor(v, device='cuda') for k, v in fleet.final.items()}
    stats = G.init_stats()

    def record():
        c, st = cfg, stats
        for _ in range(thin):
            c, st, inline = G.step(rng, c, st)
        return {k: v.cpu().numpy() for k, v in inline.items()}

    record()
    torch.cuda.synchronize()
    kinds, wall_ms = profiled(torch, record, 1)
    say_breakdown(card, f'{label}: one record ({thin} Hammer steps and the host copy of its '
                  f'inline observables, torch.profiler)', kinds, wall_ms, 'the host clock')


def chunked_worm_ms(torch, S, chains, moves):
    """Milliseconds of one ChunkedWorm step over ``chains`` chains (CUDA events,
    mean of 5 after a warm-up), from a cold start."""
    import supervillain_tpu_torch as sv
    from supervillain_tpu_torch.generators import villain as gv
    G = gv.ChunkedWorm(S, moves_per_step=moves)
    cfg = G.prepare({k: v.expand((chains,) + v.shape).contiguous()
                     for k, v in S.initial('cuda').items()})
    rng = torch.Generator(device='cuda').manual_seed(5)
    ms, _ = time_ms(torch, lambda: G.step(rng, cfg, G.init_stats()), 5)
    return ms


def phase_general_full_width(torch, card):
    """G2: sample_fleet(S, Hammer(S, fleet=True)) at full width: agreement
    with sample_fused_fleet at L=64, then width and timing at L=256."""
    import supervillain_tpu_torch as sv
    from supervillain_tpu_torch.generators import villain as gv, worldline as gw

    counters = general_counters()
    N, B, thin, kappa = 64, 1024, 4, 0.5
    # From a cold start at L=64 the ActionDensity of the general Villain Hammer
    # settles to within 1e-4 after about 1000 steps at W=2 and 400 at W=1, and
    # that of the fused Villain sweep (zero-inflated, p_n = 0.1) after about
    # 2500 sweeps; with p_n unset the sweep is far from equilibrium after 200
    # (H100 runs of this phase, PERF.md §6).  The Worldline fleets settle
    # within 100.
    fused_thin = 50
    say(f'== phase G2a: the general Hammer fleets against the fused fleets (L={N}, {B} chains, '
        f'κ={kappa}, thin={thin}; the fused reference thin={fused_thin}, p_n=0.1 for the '
        f'Villain sweep); ActionDensity is the registry '
        f'observable measured on the kept fields of both fleets (for the Worldline action '
        f'(|ℓ|/2 − (1/2κ)Σ(m − δv/W)²)/Λ, 1 minus the fused kernels\' inline column, which '
        f'is not used)')
    general = {k: 0 for k in counters}
    with PlainTwinsRefused():
        for label, S, module, kernel, steps, cut, fused_steps, fused_cut in (
                ('Villain W=2 (ClassicWorm on B2, capped at 8·sites)',
                 sv.Villain(sv.Lattice2D(N), kappa, W=2), gv, 'worm', 300, 250, 100, 50),
                ('Villain W=1 (ChunkedWorm on K1, 64 micro-moves a step)',
                 sv.Villain(sv.Lattice2D(N), kappa, W=1), gv, 'chunked_worm', 150, 100, 100, 50),
                ('Worldline W=2 (ClassicWorm on B5, capped at 8·sites)',
                 sv.Worldline(sv.Lattice2D(N), kappa, W=2), gw, 'worldline_worm', 50, 25,
                 50, 25)):
            G = module.Hammer(S, fleet=True)
            for f in counters.values():
                f.launches = 0
            seconds, fleet = timed_s(torch, lambda: sv.sample_fleet(S, G, chains=B, steps=steps,
                                                                    thin=thin, seed=31))
            launches = {k: f.launches for k, f in counters.items()}
            fused = sv.sample_fused_fleet(S, chains=B, steps=fused_steps, thin=fused_thin,
                                          worms=1, keep_fields=True, seed=32,
                                          p_n=None if isinstance(S, sv.Worldline) else 0.1)
            means, estimates = [], []
            for f, records, skip in ((fleet, steps, cut), (fused, fused_steps, fused_cut)):
                e = kept_fields(sv, f, skip)
                means.append(per_chain_means(e.ActionDensity, records - skip, B))
                estimates.append(sv.Bootstrap(e, draws=100, seed=0).estimate('ActionDensity'))
            m = [float(x.mean()) for x in means]
            se = [float(x.std(ddof=1)) / math.sqrt(B) for x in means]
            z = pull(m[0], se[0], m[1], se[1])
            worm = fleet.stats['ClassicWorm']
            say(f'  {label}, {steps} records, cut {cut} (fused {fused_steps}, cut {fused_cut}): '
                f'general {m[0]!r} ± {se[0]!r}, fused '
                f'{m[1]!r} ± {se[1]!r} (per-chain means), pull {z:.3f} (bound {PULL_BOUND}); '
                f'pooled Bootstrap general '
                f'{sv.Uncertain(*estimates[0])}, fused {sv.Uncertain(*estimates[1])}')
            say(f'  [{card}] {label}: {seconds / steps!r} s per record, '
                f'{B * N * N * thin / (seconds / steps)!r} site-updates/s (chains·L²·thin over the '
                f'seconds of a record), launches {launches}; worms {worm["sweeps"]!r}, mean length '
                f'{worm["accepted"] / max(worm["sweeps"], 1.0)!r}')
            require(z < PULL_BOUND, f'G2: {label} disagrees with the fused fleet ({z:.2f} σ)')
            require(launches[kernel] == steps * thin,
                    f'G2: the worm kernel did not launch once a step for {label}: {launches}')
            if kernel == 'chunked_worm':
                say(f'  [{card}] ChunkedWorm(64) step (K1) over {B} chains at L={N}: '
                    f'{chunked_worm_ms(torch, S, B, 64)!r} ms (CUDA events, mean of 5)')
            del fleet, fused

        N, B, steps = 256, 512, 10
        say(f'== phase G2b: width and timing of the general Hammer fleets (L={N}, {B} chains, '
            f'κ={kappa}, W=2 and the Villain W=1 (ChunkedWorm on K1, the slice\'s path), '
            f'thin={thin}, {steps} records, keep_fields=False; not thermalized, no agreement '
            f'held)')
        for label, S, module in (('Villain', sv.Villain(sv.Lattice2D(N), kappa, W=2), gv),
                                 ('Worldline', sv.Worldline(sv.Lattice2D(N), kappa, W=2), gw),
                                 ('Villain W=1', sv.Villain(sv.Lattice2D(N), kappa, W=1), gv)):
            G = module.Hammer(S, fleet=True)
            for f in counters.values():
                f.launches = 0
            seconds, fleet = timed_s(torch, lambda: sv.sample_fleet(
                S, G, chains=B, steps=steps, thin=thin, seed=41, keep_fields=False))
            launches = {k: f.launches for k, f in counters.items()}
            for k, v in launches.items():
                general[k] += v
            villain = label.startswith('Villain')
            histogram = 'Vortex_Vortex' if villain else 'Spin_Spin'
            for k in (histogram, 'Worm_Length'):
                col = fleet.columns[k]
                require(col.shape[:2] == (steps, B) and np.isfinite(col).all(),
                        f'G2: bad column {k}')
            worm = fleet.stats['ClassicWorm']
            if S.W == 1:
                worms = (f'{worm["sweeps"]!r} worms closed, {worm["accepted"]!r} micro-moves '
                         f'tallied')
                kernel = 'chunked_worm'
            else:
                worms = (f'{worm["sweeps"] - worm["acceptance"]!r} of {worm["sweeps"]!r} worms '
                         f'truncated at {8 * N * N} moves, mean length '
                         f'{worm["accepted"] / worm["sweeps"]!r}')
                kernel = 'worm' if villain else 'worldline_worm'
            say(f'  [{card}] {label} Hammer(fleet=True): {seconds / steps!r} s per record, '
                f'{B * N * N * thin / (seconds / steps)!r} site-updates/s; launches {launches}; '
                f'{worms}')
            require(launches[kernel] == steps * thin,
                    f'G2: the {label} worm kernel did not launch once a step: {launches}')
            record_profile(torch, card, f'{label} Hammer(fleet=True)', G, fleet, thin)
            del fleet
        say(f'  [{card}] ChunkedWorm(64) step (K1) over {B} chains at L={N} (W=1): '
            f'{chunked_worm_ms(torch, sv.Villain(sv.Lattice2D(N), kappa, W=1), B, 64)!r} ms '
            f'(CUDA events, mean of 5; the parent\'s PyTorch loop 34–60 ms, PERF.md §5)')
    return general


def phase_general_host_path(torch):
    """G3: Ensemble.generate with the generic Villain Hammer on the card, every
    → continue_from, and the h5 round trip of its generator tree."""
    import supervillain_tpu_torch as sv
    from supervillain_tpu_torch.generators import villain as gv

    say('== phase G3: Ensemble.generate with the generic Villain Hammer on the card (N=8, W=2), '
        'every(2) → continue_from, h5 round trip')
    S = sv.Villain(sv.Lattice2D(8), 0.5, W=2)
    with PlainTwinsRefused():
        e = sv.Ensemble(S).generate(20, gv.Hammer(S, fleet=True), seed=3)
        strided = e.every(2)
        require(isinstance(strided.generator, sv.KeepEvery), 'every() dropped the generator')
        rest = sv.Ensemble.continue_from(strided, 5)
    require(len(rest) == 5 and rest.index[0] == strided.index[-1] + 2,
            f'continue_from of a strided ensemble: index {rest.index}')
    require(all(S.valid({'n': torch.as_tensor(n)}) for n in rest.n), 'G3: dn ≢ 0 mod 2')
    require(np.isfinite(sv.Bootstrap(rest, draws=50, seed=0).estimate('ActionDensity')).all(),
            'G3: non-finite ActionDensity')
    say(f'  generate(20) → every(2) → continue_from(5): index {rest.index.tolist()}, stats '
        f'{sorted(rest.stats)}')
    try:
        import h5py
    except ImportError:
        say('  h5py does not import here: the h5 round trip is skipped (not a failure)')
        return
    import tempfile
    with tempfile.TemporaryDirectory() as where:
        with h5py.File(f'{where}/g3.h5', 'w') as f:
            strided.to_h5(f.create_group('ensemble'))
            read = sv.Ensemble.from_h5(f['ensemble'])
    spec = sv.io.generator_spec(strided.generator)
    require(sv.io.generator_spec(read.generator) == spec, 'G3: the generator spec did not rebuild')
    say(f'  h5 round trip: the spec rebuilds ({spec["cls"]} of {spec["generator"]["cls"]})')


# -- K1 and K2: the general path's last host-driven loops, on the card -------------

#: K1's shapes (N, chains) and micro-moves a call: the slice's full width
#: first, then odd, small and large sides.
K1_SHAPES = ((256, 512), (5, 256), (32, 256), (255, 256))
K1_MOVES = 64
#: The shards of K1's chain0 check (as P1's).
K1_CUT = 128
#: |Δ| allowed in a ChunkedWorm call's closes and tallies (per chain, and the
#: histogram of every chain whose fields and worm state agree): none of them
#: depends on a Metropolis decision but through the head's path.
K1_TALLY_ATOL = 1e-6
#: K2's sides (D, N), the W and κ of its same-draws checks, its chains there,
#: and the chains of its timing at the main path's D=4.
K2_SHAPES = ((3, 8), (3, 16), (4, 8))
K2_WS = (1, 2, float('inf'))
K2_KAPPAS = (0.2, 0.3)
K2_CHAINS = 64
K2_TIMED_CHAINS = (32, 512)


def memory_round_trip_ns(torch, nbytes=256 * 2 ** 20, steps=20000, cached=False):
    """One round trip of a dependent load in ns: one thread follows ``steps``
    dependent loads through a random cycle over ``nbytes``, ``csrc/probe.cu``;
    CUDA events, the median of 3 after a warm-up.  Cold (the default, 256 MiB,
    five times the L2 cache) each call starts on its own stretch of the cycle:
    one device-memory round trip.  ``cached``: the buffer is read whole first,
    so that a buffer the size of a kernel's working set sits in the L2 cache
    as far as it fits, as the kernel's does."""
    from supervillain_tpu_torch.ops import kernels
    M = nbytes // 4
    g = torch.Generator(device='cuda').manual_seed(0)
    perm = torch.randperm(M, generator=g, device='cuda')
    chain = torch.empty(M, dtype=torch.int32, device='cuda')
    chain[perm] = perm.roll(-1).int()
    out = torch.empty(1, dtype=torch.int32, device='cuda')
    lib, stream = kernels.library(), kernels.stream_handle(torch.device('cuda'))

    # Cold, each call starts on its own stretch of the cycle, so that no load
    # finds its line in the L2 cache from an earlier call.
    starts = [int(perm[part * (M // 4)]) for part in range(4)]

    def chase(k, start):
        kernels.check(lib.sv_pointer_chase(chain.data_ptr(), k, start, out.data_ptr(), stream),
                      'sv_pointer_chase')

    chase(steps // 10, starts[0])
    times = []
    for start in starts[1:]:
        if cached:
            chain.sum()
        times.append(timed_call(torch, lambda: chase(steps, start))[0])
    del chain, perm
    return float(np.median(times)) * 1e6 / steps


def chunked_state(torch, N, B, seed):
    """A W=1 Villain batch for K1: uniform φ, n in {−1, 0, 1} (every n is valid
    at W=1) and a random open worm a chain."""
    host = torch.Generator().manual_seed(seed)
    phi = ((torch.rand((B, 1, N, N), generator=host) - 0.5) * 2 * math.pi).cuda()
    n = torch.randint(-1, 2, (B, 2, N, N), generator=host, dtype=torch.int32).cuda()
    worm = torch.cat([torch.randint(0, N, (B, 4), generator=host),
                      2 * torch.randint(0, 2, (B, 1), generator=host) - 1], dim=1)
    return phi, n, worm.int().cuda()


def compare_chunked(name, got, want):
    """K1's outputs (n, worm, hist, length, closes) against its plain twin's."""
    B = got[0].shape[0]
    links = float((got[0] != want[0]).double().mean())
    fields = differ(got[0], want[0]) | differ(got[1], want[1])
    parted = fields | differ(got[2], want[2])
    frac = float(parted.double().mean())
    tallies = max(float((got[k] - want[k]).abs().max()) for k in (3, 4))
    kept = ~fields
    hist = float((got[2][kept] - want[2][kept]).abs().max()) if bool(kept.any()) else 0.0
    say(f'  {name}: n differs at {links!r} of the links (bound {SAME_DRAWS_SITES}), the worm '
        f'state or histogram on {frac!r} of the {B} chains (bound {SAME_DRAWS_CHAINS}); max '
        f'|Δ| of the closes and lengths {tallies!r}, of the histograms of the chains that agree '
        f'{hist!r} (bound {K1_TALLY_ATOL})')
    require(links <= SAME_DRAWS_SITES and frac <= SAME_DRAWS_CHAINS,
            f'{name}: kernel and plain twin part on the same draws')
    require(tallies <= K1_TALLY_ATOL and hist <= K1_TALLY_ATOL,
            f'{name}: kernel and plain twin tally differently')
    return tallies


def phase_chunked_worm(torch, card, round_trip_ns):
    """K1: the ChunkedWorm kernel against its plain twin on K1's Philox draws
    at K1_SHAPES; its shards with chain0 = 0 and K1_CUT against the whole call
    bit for bit; its time per step at L=256, 512 chains, beside the plain
    twin's and the bound."""
    from supervillain_tpu_torch.ops import kernels
    from supervillain_tpu_torch.ops.worm import (KernelChunkedWormDraws, chunked_worms,
                                                 plain_chunked_worms)

    T, kappa = K1_MOVES, 0.5
    say(f'== phase K1: the ChunkedWorm kernel (csrc/worm.cu) against its plain twin on the same '
        f'Philox draws (T={T}, κ={kappa}, W=1; ' +
        ', '.join(f'N={N} {B} chains' for N, B in K1_SHAPES) + '), chain0 shards, timing')
    t0 = time.perf_counter()
    err, out = 0.0, {}
    for N, B in K1_SHAPES:
        phi, n, worm = chunked_state(torch, N, B, 70 + N)
        seed = 300 + N

        def call(lo=0, hi=B):
            return chunked_worms(phi[lo:hi], n[lo:hi], worm[lo:hi], kappa=kappa, moves=T,
                                 generator=torch.Generator().manual_seed(seed), chain0=lo)

        def plain():
            draws = KernelChunkedWormDraws(kernels.seed_from(torch.Generator().manual_seed(seed)),
                                           B=B, N=N, device='cuda')
            return plain_chunked_worms(phi, n, worm, kappa=kappa, moves=T, draws=draws)

        got = call()
        err = max(err, compare_chunked(f'K1 N={N}, {B} chains', got, plain()))
        if (N, B) != K1_SHAPES[0]:
            continue
        parts = [call(0, K1_CUT), call(K1_CUT, B)]
        equal = all(torch.equal(a[:K1_CUT], p) and torch.equal(a[K1_CUT:], q)
                    for a, p, q in zip(got, *parts))
        say(f'  K1 shards [0, {K1_CUT}) and [{K1_CUT}, {B}) with chain0 = 0 and {K1_CUT}: '
            f'equal to the whole call bit for bit: {equal}')
        require(equal, 'K1: a shard differs from its rows of the whole call')
        times, last = call_spread(torch, call, 7)
        plain_times, _ = call_spread(torch, plain, 3)
        closes = float(last[4].double().sum())
        # n read and written whole (the wrapper's copy), the histogram zeroed,
        # the worm state in and out, the tallies; φ only where a move that
        # does not close reads it (two sites).
        nbytes = (2 * 8 * B * N * N + 4 * B * N * N + 2 * 20 * B + 8 * B
                  + 8 * (B * T - int(closes)))
        # A micro-move is a worm move, and a close draws once more (its restart).
        bms, by = bound(nbytes, OPS_WORM_MOVE * B * T + PHILOX_OPS * closes)
        floor = T * round_trip_ns * 1e-6
        ms = float(np.median(times))
        say(f'  [{card}] K1 at L={N}, {B} chains, T={T}: {spread(times)} ms per step '
            f'(min / median / max of 7, CUDA events; the parent\'s PyTorch loop 34–60 ms, '
            f'PERF.md §5), plain twin {spread(plain_times)} ms (3 calls); bound {bms!r} ms '
            f'({by}: {nbytes} bytes: n read and written, the histogram zeroed, φ at '
            f'{B * T - int(closes)} moves that read it; {closes!r} closes), latency floor {floor!r} ms ({T} '
            f'dependent rounds of one {round_trip_ns!r} ns round trip); {ms / max(bms, floor)!r}× '
            f'the larger')
        out = {'ms': ms, 'plain_ms': float(np.median(plain_times)), 'bound': (bms, by),
               'latency_floor_ms': floor}
    torch.cuda.synchronize()
    say(f'  K1: {time.perf_counter() - t0!r} s (card: {card}); largest |Δ| {err!r}')
    return err, out


def worldline_general_state(torch, D, N, B, W, seed):
    """A closed Worldline batch at dimension D for K2: m = 0 and v random
    (integers in {−1, 0, 1}, or uniform at W=∞)."""
    host = torch.Generator().manual_seed(seed)
    C = D * (D - 1) // 2
    shape = (B, C) + (N,) * D
    m = torch.zeros((B, D) + (N,) * D, dtype=torch.int32, device='cuda')
    if W == float('inf'):
        v = (torch.rand(shape, generator=host) - 0.5).cuda()
    else:
        v = torch.randint(-1, 2, shape, generator=host, dtype=torch.int32).cuda()
    return m, v


def phase_general_worldline_worm(torch, card):
    """K2: the D-general Worldline worm kernel against its plain twin on the
    draws of KernelWorldlineWormDraws with D (both capped at ODD_REPLAY_CAP):
    δm = 0 bitwise after every call and every truncated worm rolled back
    exactly; then its time per call at D=4, N=8, κ=0.3, W=1 at the fleet cap
    on a state the generic Hammer has moved, at 32 and 512 chains, beside its
    latency floor: the longest worm's moves at one round trip of a dependent
    load through a buffer the size of its working set (m, δv/W and the
    histogram), read whole first, so that it sits in the L2 cache as far as
    it fits."""
    import supervillain_tpu_torch as sv
    from supervillain_tpu_torch.generators import worldline as gw
    from supervillain_tpu_torch.ops import calculus, kernels
    from supervillain_tpu_torch.ops.worldline_worm import (KernelWorldlineWormDraws,
                                                           plain_worldline_worms,
                                                           worldline_worms_general)

    say(f'== phase K2: the Worldline worm at D ≥ 3 (csrc/worldline_worm_general.cu) against its '
        f'plain twin on the same draws (' + ', '.join(f'D={D} N={N}' for D, N in K2_SHAPES) +
        f'; W = 1, 2, ∞; κ = {", ".join(map(str, K2_KAPPAS))}; {K2_CHAINS} chains, capped at '
        f'{ODD_REPLAY_CAP}), and its time at D=4')
    t0 = time.perf_counter()
    err = 0.0
    for D, N in K2_SHAPES:
        L = sv.Lattice(D, N)
        for W in K2_WS:
            for kappa in K2_KAPPAS:
                m, v = worldline_general_state(torch, D, N, K2_CHAINS, W, 10 * D + N)
                seed = 400 + 10 * D + N
                common = dict(kappa=kappa, W=W, worms=1, max_worm_moves=ODD_REPLAY_CAP)
                got = worldline_worms_general(m, v, generator=torch.Generator().manual_seed(seed),
                                              **common)
                want = plain_worldline_worms(m, v, draws=KernelWorldlineWormDraws(
                    kernels.seed_from(torch.Generator().manual_seed(seed)), B=K2_CHAINS, N=N,
                    device='cuda', D=D), **common)
                label = f'K2 D={D} N={N} W={W} κ={kappa}'
                err = max(err, compare_worms(label, got, want))
                require(bool((calculus.delta(L, 1, got[0]) == 0).all()), f'{label}: δm ≠ 0')
                rolled = got[3].bool()
                require(torch.equal(got[0][rolled], m[rolled]),
                        f'{label}: a truncated worm was not rolled back exactly')
                say(f'    {int(rolled.sum())} of {K2_CHAINS} worms truncated and rolled back '
                    f'exactly; longest {float(got[2].max())!r} moves')

    # Time at the main path's D=4 (D3's κ=0.3 fleet), on a state moved by 20
    # steps of the generic Hammer, at the fleet cap.
    S = sv.Worldline(sv.Lattice(4, 8), 0.3, W=1)
    cap = gw.fleet_worm_cap(S.Lattice)
    fleet = sv.sample_fleet(S, gw.Hammer(S, fleet=True), chains=max(K2_TIMED_CHAINS), steps=1,
                            thin=20, seed=5, keep_fields=True)
    m_all = torch.as_tensor(fleet.final['m'], device='cuda')
    v_all = torch.as_tensor(fleet.final['v'], device='cuda')
    host = torch.Generator().manual_seed(6)
    out = {}
    for B in K2_TIMED_CHAINS:
        m, v = m_all[:B].contiguous(), v_all[:B].contiguous()
        common = dict(kappa=S.kappa, W=S.W, worms=1)
        worldline_worms_general(m, v, max_worm_moves=cap, generator=host, **common)
        calls = [timed_call(torch, lambda: worldline_worms_general(
            m, v, max_worm_moves=cap, generator=host, **common)) for _ in range(3)]
        ms = float(np.mean([t for t, _ in calls]))
        longest = float(np.mean([float((o[2] + 1 - o[3]).max()) for _, o in calls]))
        moves = float(np.mean([worm_moves(o[2], o[3], 1) for _, o in calls]))
        C, V = 6, S.Lattice.sites
        nbytes = 8 * B * 4 * V + 4 * B * C * V + 4 * B * V + 8 * B
        bms, by = bound(nbytes, OPS_WORM_MOVE * moves)
        working_set = B * V * (4 * 4 + 4 * 4 + 4)
        round_trip_ns = memory_round_trip_ns(torch, working_set, cached=True)
        floor = longest * round_trip_ns * 1e-6
        say(f'  [{card}] K2 at D=4, N=8, κ=0.3, W=1, {B} chains, cap {cap}: {ms!r} ms per call '
            f'(mean of 3, CUDA events), {ms * 1e6 / longest!r} ns per move of the longest worm '
            f'({longest!r} moves), {moves / ms * 1e3!r} moves/s; bound {bms!r} ms ({by}), '
            f'latency floor {floor!r} ms (the longest worm\'s moves at one {round_trip_ns!r} ns '
            f'round trip through a warmed {working_set} bytes, its working set); '
            f'{ms / max(bms, floor)!r}× the larger')
        out[B] = {'ms': ms, 'ns_per_move': ms * 1e6 / longest, 'bound': (bms, by),
                  'latency_floor_ms': floor, 'round_trip_ns': round_trip_ns,
                  'working_set_bytes': working_set}
    B = K2_TIMED_CHAINS[0]
    m, v = m_all[:B].contiguous(), v_all[:B].contiguous()
    common = dict(kappa=S.kappa, W=S.W, worms=1, max_worm_moves=ODD_REPLAY_CAP)
    seed = kernels.seed_from(torch.Generator().manual_seed(7))
    capped_ms, _ = timed_call(torch, lambda: worldline_worms_general(
        m, v, generator=torch.Generator().manual_seed(7), **common))
    plain_ms, _ = timed_call(torch, lambda: plain_worldline_worms(m, v, draws=KernelWorldlineWormDraws(
        seed, B=B, N=8, device='cuda', D=4), **common))
    say(f'  [{card}] with worms capped at {ODD_REPLAY_CAP} moves ({B} chains): K2 '
        f'{capped_ms!r} ms, plain twin {plain_ms!r} ms')
    del fleet, m_all, v_all
    torch.cuda.synchronize()
    say(f'  K2: {time.perf_counter() - t0!r} s (card: {card}); largest |Δ Worm_Length| {err!r}')
    return err, out, (capped_ms, plain_ms)


# -- the ported scripts: the CLI tier and the examples, against the JAX logs ----

#: Where the port's example scripts live, from the repo root.
EXAMPLES = 'supervillain_tpu_torch/examples'
#: Committed logs of the JAX package's production runs, from the repo root.
RESULTS = 'results'
#: A script's result against a committed log, or against an exact value: |pull|.
SCRIPT_PULL_BOUND = 4.0
#: Thermalization sweeps of the L=64 scans (E2, E3): 8·L², the factor of the
#: JAX package's scripts for critical chains.  At 2·L² the chains just below
#: κ_c (0.6 and 0.65 at W=1, 0.14 and 0.16 at W=2) are still relaxing from the
#: cold start (PERF.md §7).
SCAN_THERM = 8 * 64 ** 2
#: E8's depth: the eager scripts at an even N, with fewer configurations than
#: O2 runs them with at their odd defaults (the host-bound eager steps are most
#: of the run's time).  fleet-scan.py runs at its own defaults (100 records,
#: cut 25), since its ChunkedWorm is one launch of K1 a step.
E8_CONFIGURATIONS = 500
O2_CONFIGURATIONS = 1000

# An Uncertain as the JAX package prints it: '+7.1357(23) × 10^-1' (error in
# units of the last digit), '+8.5(3.1)' (error in the value's units),
# '(+1.00 ± 10.00) × 10^-1' or, with no error, '+1.25 × 10^-1'.
_UNCERTAIN = re.compile(
    r'(?:(?P<mean>[+-]\d+(?:\.\d+)?)(?:\((?P<err>[\d.]+)\))?'
    r'|\((?P<pm_mean>[+-]?\d+(?:\.\d+)?) ± (?P<pm_err>\d+(?:\.\d+)?)\))'
    r'(?: × 10\^(?P<exp>[+-]\d+))?')


def parse_uncertain(match):
    """(mean, error) of one :data:`_UNCERTAIN` match."""
    scale = 10.0 ** int(match['exp'] or 0)
    if match['pm_mean'] is not None:
        return float(match['pm_mean']) * scale, float(match['pm_err']) * scale
    mean, err = match['mean'], match['err']
    if err is None:
        return float(mean) * scale, 0.0
    if '.' not in err:       # in units of the mean's last digit
        err = int(err) * 10.0 ** -len(mean.partition('.')[2])
    return float(mean) * scale, float(err) * scale


#: The columns of a bkt-scan table row after κ and the acceptance, in order.
SCAN_COLUMNS = ('S', 'W2', 'chi', 'chi_scaled', 'chiV_scaled')
#: ... and those E2 and E3 hold against the logs: ActionDensity, WindingSq, χ_S/L^(D−2Δ).
SCAN_GATED = ('S', 'W2', 'chi_scaled')


def read_scan_log(path):
    """{κ: {column: (mean, error)}} of the table in a bkt-scan log, columns
    named as the groups of its h5 file (:data:`SCAN_COLUMNS`)."""
    rows = {}
    for line in open(path, encoding='utf-8'):
        head = re.match(r'\s*(\d+\.\d+)\s+[\d.]+%\s', line)
        if head is None:
            continue
        rest = line[head.end():].split('sect=')[0]
        values = [parse_uncertain(m) for m in _UNCERTAIN.finditer(rest)]
        rows[float(head[1])] = dict(zip(SCAN_COLUMNS, values))
    return rows


def read_fleet_log(path):
    """{name: (mean, error)} of the 'name = value' lines of pod-fleet.log."""
    values = {}
    for line in open(path, encoding='utf-8'):
        m = re.match(r'(\w+)\s*=\s*(\S.*)$', line.strip())
        if m:
            values[m[1]] = parse_uncertain(_UNCERTAIN.match(m[2]))
    return values


def repo_root():
    import pathlib
    return pathlib.Path(__file__).resolve().parent


def run_script(name, argv):
    """Run the port's example ``name`` in this process as ``python name argv``
    would, and return its globals (runpy), so that the kernels' launch
    counts can be read after it."""
    import runpy
    path = repo_root() / EXAMPLES / name
    saved = sys.argv
    sys.argv = [str(path)] + [str(a) for a in argv]
    try:
        return runpy.run_path(str(path), run_name='__main__')
    finally:
        sys.argv = saved


def script_counters():
    from supervillain_tpu_torch.ops.hammer import hammer_sweeps
    from supervillain_tpu_torch.ops.worldline import worldline_sweeps
    from supervillain_tpu_torch.ops.worldline_hammer import worldline_hammer_sweeps
    return general_counters() | {'hammer': hammer_sweeps, 'worldline_sweep': worldline_sweeps,
                                 'worldline_hammer': worldline_hammer_sweeps}


def script_phase(torch, card, label, runs, kernels):
    """Run each (script, argv) of ``runs`` with every count at 0 and the plain
    twins refused; require that each of ``kernels`` launched.  Returns the
    scripts' globals and the launches."""
    counters = script_counters()
    for f in counters.values():
        f.launches = 0
    t0 = time.perf_counter()
    results = []
    with PlainTwinsRefused():
        for script, argv in runs:
            say(f'  -- {script} {" ".join(str(a) for a in argv)}')
            t1 = time.perf_counter()
            results.append(run_script(script, argv))
            torch.cuda.synchronize()
            say(f'  -- {script}: {time.perf_counter() - t1!r} s')
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items()}
    say(f'  {label}: {seconds!r} s (card: {card}); launches {launches}')
    require(all(launches[k] > 0 for k in kernels), f'{label}: a kernel never launched: {launches}')
    return results, launches


def gate_pulls(label, pulls, bound=SCRIPT_PULL_BOUND):
    """Print each pull and require |pull| < bound of every one."""
    for what, p in pulls.items():
        say(f'    {label} {what}: pull {p:+.3f}')
    worst = max(pulls, key=lambda k: abs(pulls[k]))
    require(abs(pulls[worst]) < bound, f'{label}: |pull| of {worst} is {abs(pulls[worst]):.3f}')


def shown(value):
    """A (mean, error) pair as the JAX logs print it."""
    from supervillain_tpu_torch.analysis import Uncertain
    return str(Uncertain(*value))


def signed_pull(ours, theirs):
    """(ours − theirs)/√(σ_ours² + σ_theirs²) of two (mean, error) pairs."""
    return (ours[0] - theirs[0]) / math.hypot(ours[1], theirs[1])


def phase_cli():
    """E1: python -m supervillain_tpu_torch --version and --license, both at once."""
    from supervillain_tpu_torch import license, meta
    say('== phase E1: python -m supervillain_tpu_torch --version / --license')
    t0 = time.perf_counter()
    runs = [(flag, text, subprocess.Popen([sys.executable, '-m', 'supervillain_tpu_torch', flag],
                                          cwd=repo_root(), stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
            for flag, text in (('--version', meta.version), ('--license', license.license()))]
    for flag, text, process in runs:
        out, err = process.communicate(timeout=300)
        require(process.returncode == 0, f'E1: {flag} exited {process.returncode}: {err}')
        require(out.strip() == text.strip(), f'E1: {flag} printed {out[:200]!r}')
        say(f'  {flag}: exit 0, {len(out.strip())} characters as meta/license say')
    say(f'  E1: {time.perf_counter() - t0!r} s')


def scan_against_log(label, results, log, columns):
    """Pulls of a bkt-scan's results against a committed log's rows, per κ."""
    pulls = {}
    for kappa, ours in results.items():
        theirs = log[kappa]
        for c in columns:
            pulls[f'κ={kappa} {c}'] = signed_pull(ours[c], theirs[c])
        say(f'    {label} κ={kappa} ({ours["seconds"]!r} s): ' + ', '.join(
            f'{c} {shown(ours[c])} against {shown(theirs[c])}' for c in ('S', 'W2', 'chi_scaled')))
    return pulls


def phase_scan_w1(torch, card):
    """E2: bkt-scan.py at L=64, W=1 against results/bkt-scan-L64.log."""
    log = read_scan_log(repo_root() / RESULTS / 'bkt-scan-L64.log')
    say(f'== phase E2: bkt-scan.py --L 64 --chains 256 --W 1 --therm-sweeps {SCAN_THERM} at the '
        f'{len(log)} κ of results/bkt-scan-L64.log')
    (g,), launches = script_phase(torch, card, 'E2', [('bkt-scan.py', [
        '--L', 64, '--chains', 256, '--W', 1, '--therm-sweeps', SCAN_THERM, '--kappas', *log])],
        ('sweep',))
    gate_pulls('E2', scan_against_log('E2', g['results'], log, SCAN_GATED))
    return launches


def phase_scan_w2(torch, card):
    """E3: bkt-scan.py at L=64, W=2 against results/bkt-scan-W2-L64.log."""
    log = read_scan_log(repo_root() / RESULTS / 'bkt-scan-W2-L64.log')
    say(f'== phase E3: bkt-scan.py --L 64 --chains 256 --W 2 --therm-sweeps {SCAN_THERM} at the '
        f'{len(log)} κ of results/bkt-scan-W2-L64.log (worms 1)')
    (g,), launches = script_phase(torch, card, 'E3', [('bkt-scan.py', [
        '--L', 64, '--chains', 256, '--W', 2, '--therm-sweeps', SCAN_THERM, '--kappas', *log])],
        ('sweep', 'worm', 'hammer'))
    results = g['results']
    for kappa, ours in results.items():
        say(f'    E3 κ={kappa} χ_V/L^(D-2Δ_V) {shown(ours["chiV_scaled"])} against '
            f'{shown(log[kappa]["chiV_scaled"])}')
    gate_pulls('E3', scan_against_log('E3', results, log, SCAN_GATED + ('chiV_scaled',)))
    return launches


def phase_scan_l256(torch, card):
    """E4: bkt-scan.py at its defaults (L=256, W=1), κ=0.74, against
    results/bkt-scan-L256.log: ActionDensity, WindingSq and χ_S/L^(D−2Δ)."""
    from supervillain_tpu_torch.ops.sweep import sweep_plan
    log = read_scan_log(repo_root() / RESULTS / 'bkt-scan-L256.log')
    plan = sweep_plan(256)
    say(f'== phase E4: bkt-scan.py at its defaults (L=256, 32 chains, W=1) --kappas 0.74 '
        f'--therm-sweeps 32768, against results/bkt-scan-L256.log; sweep plan {plan}')
    require(plan.regime == 'resident', f'E4: L=256 is not in the resident regime: {plan}')
    (g,), launches = script_phase(torch, card, 'E4', [('bkt-scan.py', [
        '--kappas', 0.74, '--therm-sweeps', 32768])], ('sweep',))
    ours, theirs = g['results'][0.74], log[0.74]
    gate_pulls('E4', scan_against_log('E4', {0.74: ours}, {0.74: theirs}, SCAN_GATED))
    return launches


def require_same_fleets(label, a, b):
    """Two runs of a script, without and with --mesh, give the same fleet."""
    diff = fleet_differences(a, b)
    say(f'    {label} with --mesh against without: '
        f'{"equal bit for bit" if not diff else "differs in " + ", ".join(diff)}; mesh {b.mesh}')
    require(not diff, f'{label}: --mesh changes the fleet: {diff}')


def phase_pod_fleet(torch, card):
    """E5: pod-fleet.py against results/pod-fleet.log, and with --mesh the same fleet."""
    log = read_fleet_log(repo_root() / RESULTS / 'pod-fleet.log')
    say('== phase E5: pod-fleet.py --thin 64 --steps 96 (10240 chains, L=64, κ=0.74, therm 2048) '
        'against results/pod-fleet.log, and with --mesh')
    argv = ['--thin', 64, '--steps', 96]
    (g, gm), launches = script_phase(torch, card, 'E5', [('pod-fleet.py', argv),
                                                          ('pod-fleet.py', argv + ['--mesh'])],
                                     ('sweep',))
    require_same_fleets('E5', g['result']['fleet'], gm['result']['fleet'])
    result = g['result']
    say(f'    E5: {result["site_updates_per_second"]!r} site-updates/s over '
        f'{result["seconds"]!r} s (card: {card})')
    gate_pulls('E5', {name: signed_pull(result[name], log[name])
                      for name in ('ActionDensity', 'WindingSquared')})
    return launches


def phase_self_dual(torch, card):
    """E6: self-dual-fused.py --L 64: the duality, and each side at 1/2."""
    say('== phase E6: self-dual-fused.py --L 64 (W=∞, κ=1/2π, both fused Hammers)')
    (g,), launches = script_phase(torch, card, 'E6', [('self-dual-fused.py', ['--L', 64])],
                           ('sweep', 'worm', 'hammer', 'worldline_sweep', 'worldline_worm',
                            'worldline_hammer'))
    result = g['result']
    gate_pulls('E6', {'duality': result['pull'],
                      **{f'{side} ActionDensity − 1/2': signed_pull(result[side.lower()], (0.5, 0.0))
                         for side in ('Villain', 'Worldline')}})
    return launches


def phase_winf_line(torch, card):
    """E7: winf-line.py at κ = 1/π: η_eff against the exact 1/(2πκ)."""
    kappa = 1 / math.pi
    eta = 1 / (2 * math.pi * kappa)
    say(f'== phase E7: winf-line.py --Ls 64 128 --kappas {kappa!r} (η exact {eta!r})')
    (g,), launches = script_phase(torch, card, 'E7', [('winf-line.py', [
        '--Ls', 64, 128, '--kappas', repr(kappa)])], ('sweep', 'worm', 'hammer'))
    measured, = g['results'][kappa]['eta']
    gate_pulls('E7', {'η_eff(64, 128) − 1/(2πκ)': signed_pull(measured, (eta, 0.0))})
    return launches


def phase_small_scripts(torch, card):
    """E8: the eager-generator scripts and fleet-scan.py on the card."""
    C = E8_CONFIGURATIONS
    runs = [('end-to-end.py', ['--N', 6, '--configurations', C]),
            ('end-to-end.py', ['--action', 'worldline', '--W', 2, '--N', 6, '--configurations', C]),
            ('action-comparison.py', ['--N', 6, '--configurations', C]),
            ('villain-algorithm-comparison.py', ['--N', 6, '--configurations', C]),
            ('worldline-algorithm-comparison.py', ['--N', 6, '--configurations', C]),
            ('no-vortices.py', ['--N', 12, '--configurations', C]),
            ('why-measure-inline.py', ['--N', 8, '--configurations', C]),
            ('fleet-scan.py', []),
            ('fleet-scan.py', ['--mesh'])]
    say(f'== phase E8: the eager-generator scripts ({C} configurations, even N) and '
        f'fleet-scan.py at its defaults (100 records, cut 25), and with --mesh')
    results, launches = script_phase(torch, card, 'E8', runs,
                                     ('sweep', 'worm', 'worldline_worm', 'chunked_worm'))
    plain, meshed = results[-2]['results'], results[-1]['results']
    for kappa in plain:
        require_same_fleets(f'E8 fleet-scan.py κ={kappa}', plain[kappa][0], meshed[kappa][0])
    gate_pulls('E8', eager_script_pulls(runs, results))
    return launches


def eager_script_pulls(runs, results):
    """The pulls the eager-generator scripts return, by script and quantity,
    and why-measure-inline.py's inline against taxicab Spin_Spin_Normalized
    where the taxicab's reweighting overlaps (the nearest displacements;
    ROADMAP C5)."""
    pulls = {}
    for (script, _), g in zip(runs, results):
        for what, p in g.get('pulls', {}).items():
            pulls[f'{script} {what}'] = p
        dxs = ('(0, 1)', '(1, 1)', '(2, 2)', '(0, N//2)')
        for dx, p in zip(dxs, g.get('correlator_pulls', ())):
            pulls[f'{script} Spin_Spin/Vortex_Vortex at {dx}'] = p
    g = next(g for (script, _), g in zip(runs, results) if script == 'why-measure-inline.py')
    for dx in ((0, 1), (1, 1)):
        pulls[f'why-measure-inline.py inline − taxicab at {dx}'] = signed_pull(
            (g['inline'].mean(axis=0)[dx], g['inline'].std(axis=0)[dx]),
            (g['taxicab'].mean(axis=0)[dx], g['taxicab'].std(axis=0)[dx]))
    return pulls


# -- odd N: the color-table passes of B1 and B4; B2 and B5 at any N ------------

#: Odd sides of O1's same-draws checks, and its large odd side (beside 256).
ODD_N = (5, 7, 11)
ODD_LARGE_N = 255
#: Moves a worm may make in O1's replays at N=255 (the plain worm is a host loop).
ODD_REPLAY_CAP = 1024
#: SHA-256 prefixes of B1, B2, B4 and B5's outputs at even N on fixed inputs and
#: seeds (:func:`even_n_digests`), as the kernels at commit ef03d56
#: give them on an H100: O1 requires this tree's kernels to give the same bits.
EVEN_N_DIGESTS = {
    'B1 N=256 W=1': '83918d37ea7f0134',
    'B1 N=256 W=2': '91ffd2b270ed7be8',
    'B1 N=256 W=inf': 'bc4b6ad3973b2581',
    'B1 N=512 W=1': '04937127558c1e13',
    'B1 N=512 W=2': '498ee46d69bf0d12',
    'B1 N=512 W=inf': 'e0de5e9449a9cb83',
    'B2 N=64 W=1': 'bbfcd0700fe1ef64',
    'B2 N=64 W=2': 'c0f12114c3d30502',
    'B4 N=64 W=2': 'ec8cdf4bc567b9e3',
    'B5 N=64 W=2': 'e8450df77f930002',
    'B4 N=64 W=inf': '70422b4fff5aee7f',
    'B5 N=64 W=inf': '923420b0614a7a03',
}


def digest(*tensors):
    """First 16 hex digits of the SHA-256 of the tensors' bytes, in order."""
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def even_n_digests(torch):
    """Digests of the four kernels' outputs at even N, from inputs and seeds
    fixed here: B1 in the resident (N=256) and streaming (N=512) regimes at
    W = 1, 2 and ∞, B2 at W = 1 and 2 (capped), B4 at W = 2 and ∞ and B5 after
    it.  Uses only the wrappers' public arguments, so another checkout's
    package gives its own kernels' digests."""
    from supervillain_tpu_torch.ops.sweep import neighborhood_sweeps
    from supervillain_tpu_torch.ops.worldline import worldline_sweeps
    from supervillain_tpu_torch.ops.worldline_worm import worldline_worms
    from supervillain_tpu_torch.ops.worm import classic_worms

    inf = float('inf')
    g = torch.Generator().manual_seed(2024)
    out = {}
    for N, B in ((256, 16), (512, 2)):
        phi = ((torch.rand((B, 1, N, N), generator=g) - 0.5) * 8 * math.pi).cuda()
        k = torch.randint(-1, 2, (B, 2, N, N), generator=g, dtype=torch.int32).cuda()
        for W, p_n in ((1, None), (2, 0.3), (inf, 0.3)):
            res = neighborhood_sweeps(phi, k * (1 if W == inf else W), kappa=0.4, W=W,
                                      interval_phi=1.5, interval_n=1, sweeps=4, p_n=p_n,
                                      generator=torch.Generator().manual_seed(7))
            out[f'B1 N={N} W={W}'] = digest(res[0], res[1], res[2], *res[3].values())
    N, B = 64, 256
    phi = ((torch.rand((B, 1, N, N), generator=g) - 0.5) * 2 * math.pi).cuda()
    zero = torch.zeros((B, 2, N, N), dtype=torch.int32, device='cuda')
    for W, cap in ((1, None), (2, 4096)):
        res = classic_worms(phi, zero, kappa=0.5, W=W, worms=2, max_worm_moves=cap,
                            generator=torch.Generator().manual_seed(8))
        out[f'B2 N={N} W={W}'] = digest(*res)
    for W in (2, inf):
        v = (torch.rand((B, 1, N, N), generator=g) * 4 - 2 if W == inf
             else torch.randint(-2, 3, (B, 1, N, N), generator=g, dtype=torch.int32)).cuda()
        res = worldline_sweeps(zero, v, kappa=0.5, W=W, sweeps=4,
                               generator=torch.Generator().manual_seed(9))
        out[f'B4 N={N} W={W}'] = digest(res[0], res[1], res[2], res[3]['ActionDensity'])
        worm = worldline_worms(res[0], res[1], kappa=0.5, W=W, worms=2, max_worm_moves=4096,
                               generator=torch.Generator().manual_seed(10))
        out[f'B5 N={N} W={W}'] = digest(*worm)
    torch.cuda.synchronize()
    return out


def villain_invariant(torch, n, W):
    """dn ≡ 0 (mod W), or dn = 0 at W=∞, on every plaquette of every chain."""
    from supervillain_tpu_torch.ops import calculus
    from supervillain_tpu_torch.ops.sweep import lattice_of
    dn = calculus.d(lattice_of(n), 1, n)
    return bool(((dn == 0) if W == float('inf') else (dn % W == 0)).all())


def odd_same_draws(torch, N, B, sweeps, cap, villain_modes, worldline_ws, seed):
    """B1, B2, B4 and B5 at side N against their plain twins on the kernels'
    draws, with the exact invariants checked bitwise after each kernel call.
    Returns the largest error of each kernel."""
    from supervillain_tpu_torch.ops import kernels
    from supervillain_tpu_torch.ops.sweep import (KernelSweepDraws, neighborhood_sweeps,
                                                  plain_sweeps)
    from supervillain_tpu_torch.ops.worldline import (KernelWorldlineSweepDraws,
                                                      plain_worldline_sweeps, worldline_sweeps)
    from supervillain_tpu_torch.ops.worldline_worm import (KernelWorldlineWormDraws,
                                                           plain_worldline_worms, worldline_worms)
    from supervillain_tpu_torch.ops.worm import KernelWormDraws, classic_worms, plain_worms

    inf = float('inf')
    err = {'sweep': 0.0, 'worm': 0.0, 'worldline_sweep': 0.0, 'worldline_worm': 0.0}

    def kernel_seed(s):
        return kernels.seed_from(torch.Generator().manual_seed(s))

    g = torch.Generator().manual_seed(seed)
    phi = ((torch.rand((B, 1, N, N), generator=g) - 0.5) * 2 * math.pi).cuda()
    for W, p_n in villain_modes:
        n = torch.zeros((B, 2, N, N), dtype=torch.int32, device='cuda')
        common = dict(kappa=0.5, W=W, interval_phi=math.pi, interval_n=1, p_n=p_n)
        got = neighborhood_sweeps(phi, n, sweeps=sweeps, generator=torch.Generator().manual_seed(seed + 1),
                                  **common)
        draws = KernelSweepDraws(kernel_seed(seed + 1), B=B, N=N, interval_phi=math.pi,
                                 interval_n=1, p_n=p_n, zmode=W == inf, fdt=torch.float32,
                                 idt=torch.int32, device='cuda')
        want = plain_sweeps(phi, n, kappa=0.5, W=W, sweeps=sweeps, draws=draws)
        err['sweep'] = max(err['sweep'], compare_sweeps(f'N={N} B1 W={W}', got, want))
        require(villain_invariant(torch, got[1], W), f'N={N} B1 W={W}: dn breaks the constraint')
        require(float(got[2].sum()) > 0, f'N={N} B1 W={W}: no move accepted')
        worm_cap = None if W == 1 else cap
        wgot = classic_worms(got[0], got[1], kappa=0.5, W=W, worms=2, max_worm_moves=worm_cap,
                             generator=torch.Generator().manual_seed(seed + 2))
        wwant = plain_worms(got[0], got[1], kappa=0.5, W=W, worms=2, max_worm_moves=worm_cap,
                            draws=KernelWormDraws(kernel_seed(seed + 2), B=B, N=N, device='cuda'))
        err['worm'] = max(err['worm'], compare_worms(f'N={N} B2 W={W}', wgot, wwant))
        require(villain_invariant(torch, wgot[0], W), f'N={N} B2 W={W}: dn breaks the constraint')
    for W in worldline_ws:
        vdt = torch.float32 if W == inf else torch.int32
        m = torch.zeros((B, 2, N, N), dtype=torch.int32, device='cuda')
        v = torch.zeros((B, 1, N, N), dtype=vdt, device='cuda')
        common = dict(kappa=0.5, W=W)
        m, v, _, _ = worldline_sweeps(m, v, sweeps=4, generator=torch.Generator().manual_seed(seed),
                                      **common)
        got = worldline_sweeps(m, v, sweeps=sweeps, generator=torch.Generator().manual_seed(seed + 3),
                               **common)
        draws = KernelWorldlineSweepDraws(kernel_seed(seed + 3), B=B, N=N,
                                          interval_v=1.0 if W == inf else 1, interval_t=1,
                                          interval_w=1, winf=W == inf, fdt=torch.float32,
                                          idt=torch.int32, device='cuda')
        want = plain_worldline_sweeps(m, v, sweeps=sweeps, draws=draws, **common)
        err['worldline_sweep'] = max(err['worldline_sweep'],
                                     compare_worldline_sweeps(f'N={N} B4 W={W}', got, want))
        require(divergence_free(torch, got[0]), f'N={N} B4 W={W}: δm ≠ 0')
        wgot = worldline_worms(got[0], got[1], worms=2, max_worm_moves=cap,
                               generator=torch.Generator().manual_seed(seed + 4), **common)
        wwant = plain_worldline_worms(
            got[0], got[1], worms=2, max_worm_moves=cap,
            draws=KernelWorldlineWormDraws(kernel_seed(seed + 4), B=B, N=N, device='cuda'),
            **common)
        err['worldline_worm'] = max(err['worldline_worm'],
                                    compare_worms(f'N={N} B5 W={W}', wgot, wwant))
        require(divergence_free(torch, wgot[0]), f'N={N} B5 W={W}: δm ≠ 0')
    torch.cuda.synchronize()
    return err


def phase_odd_n(torch, card):
    """O1: B1, B2, B4 and B5 at odd N against their plain twins on the same
    draws; their times at N=255 beside N=256 with bounds; and, at even N, the
    digests of the kernels at commit ef03d56."""
    from supervillain_tpu_torch.ops.sweep import neighborhood_sweeps, sweep_plan
    from supervillain_tpu_torch.ops.worldline import worldline_sweeps
    from supervillain_tpu_torch.ops.worldline_worm import worldline_worms
    from supervillain_tpu_torch.ops.worm import classic_worms

    inf = float('inf')
    say(f'== phase O1: the kernels at odd N (N = {", ".join(map(str, ODD_N))}, 256 chains; '
        f'N = {ODD_LARGE_N}, 512 chains) against their plain twins on the kernels\' draws; '
        f'times at N = {ODD_LARGE_N} and 256; even-N digests against commit ef03d56\'s')
    t0 = time.perf_counter()
    counters = script_counters()
    for f in counters.values():
        f.launches = 0
    err = {}
    for N in ODD_N:
        require(sweep_plan(N).regime == 'table', f'N={N}: plan {sweep_plan(N)}')
        e = odd_same_draws(torch, N, 256, 6, 64, ((1, None), (2, 0.3), (inf, 0.3)),
                           (1, 2, inf), seed=100 + N)
        err = {k: max(err.get(k, 0.0), x) for k, x in e.items()}
    e = odd_same_draws(torch, ODD_LARGE_N, 512, 2, ODD_REPLAY_CAP, ((1, None),), (2,), seed=7)
    err = {k: max(err[k], x) for k, x in e.items()}
    launches = {k: f.launches for k, f in counters.items()}
    say(f'  O1 same draws: launches {launches}; largest errors {err}')
    require(all(launches[k] > 0 for k in err), f'O1: a kernel never launched: {launches}')

    # Times per call at N = 255 beside N = 256, 512 chains, from warmed states.
    timing = {}
    for N in (ODD_LARGE_N, 256):
        B, thin, cap = 512, 50, 64 * N * N
        host = torch.Generator().manual_seed(N)
        phi = ((torch.rand((B, 1, N, N), generator=host) - 0.5) * 2 * math.pi).cuda()
        n = torch.zeros((B, 2, N, N), dtype=torch.int32, device='cuda')
        phi, n, _, _ = neighborhood_sweeps(phi, n, kappa=0.5, W=1, interval_phi=math.pi,
                                           interval_n=1, sweeps=200, generator=host)
        m = torch.zeros((B, 2, N, N), dtype=torch.int32, device='cuda')
        v = torch.zeros((B, 1, N, N), dtype=torch.int32, device='cuda')
        m, v, _, _ = worldline_sweeps(m, v, kappa=0.5, W=2, sweeps=200, generator=host)
        sweep = call_spread(torch, lambda: neighborhood_sweeps(
            phi, n, kappa=0.5, W=1, interval_phi=math.pi, interval_n=1, sweeps=thin,
            generator=host), 5)
        worm = time_ms(torch, lambda: classic_worms(phi, n, kappa=0.5, W=1, worms=1,
                                                    max_worm_moves=cap, generator=host), 5)
        wsweep = call_spread(torch, lambda: worldline_sweeps(m, v, kappa=0.5, W=2, sweeps=thin,
                                                             generator=host), 5)
        # B5 call by call: a call lasts as long as its longest worm.
        worldline_worms(m, v, kappa=0.5, W=2, worms=1, max_worm_moves=cap, generator=host)
        calls = [timed_call(torch, lambda: worldline_worms(
            m, v, kappa=0.5, W=2, worms=1, max_worm_moves=cap, generator=host)) for _ in range(3)]
        wworm = (sum(t for t, _ in calls) / len(calls), calls[-1][1])
        longest = sum(float(out[2].max()) for _, out in calls)
        say(f'  [{card}] N={N} worldline_worm: {sum(t for t, _ in calls) * 1e6 / longest!r} ns per '
            f'move of the longest worm ({longest!r} moves over {len(calls)} calls)')
        sites = B * N * N
        moves = worm_moves(worm[1][2], worm[1][3], 1)
        wmoves = worm_moves(wworm[1][2], wworm[1][3], 1)
        timing[N] = {
            'sweep': (float(np.median(sweep[0])),
                      bound(24 * sites + 12 * B, OPS_VILLAIN_SITE * sites * thin)),
            'worm': (worm[0], bound(24 * sites + 8 * B, OPS_WORM_MOVE * moves)),
            'worldline_sweep': (float(np.median(wsweep[0])),
                                bound(24 * sites + 12 * B, OPS_WORLDLINE_SITE * sites * thin)),
            'worldline_worm': (wworm[0], bound(24 * sites + 8 * B, OPS_WORM_MOVE * wmoves)),
        }
        plan = sweep_plan(N)
        for k, (ms, (bms, by)) in timing[N].items():
            what = f'{thin}-sweep call' if 'sweep' in k else 'call (1 worm a chain)'
            say(f'  [{card}] N={N} ({plan.regime} sweep plan) {k}: {ms!r} ms per {what}, bound '
                f'{bms!r} ms ({by}), {ms / bms!r}× the bound')
    digests = even_n_digests(torch)
    for k, d in digests.items():
        say(f'  even-N digest {k}: {d} (ef03d56: {EVEN_N_DIGESTS.get(k, "not recorded")})')
    require(digests == EVEN_N_DIGESTS, 'O1: the kernels\' even-N outputs differ from ef03d56\'s')
    say(f'  O1: {time.perf_counter() - t0!r} s')
    return launches, err, timing


def phase_odd_scripts(torch, card):
    """O2: the eager-generator scripts at their own (odd) default N on the card."""
    C = O2_CONFIGURATIONS
    runs = [('end-to-end.py', ['--configurations', C]),
            ('end-to-end.py', ['--action', 'worldline', '--W', 2, '--configurations', C]),
            ('action-comparison.py', ['--configurations', C]),
            ('villain-algorithm-comparison.py', ['--configurations', C]),
            ('worldline-algorithm-comparison.py', ['--configurations', C]),
            ('no-vortices.py', ['--configurations', C]),
            ('why-measure-inline.py', ['--configurations', C])]
    say(f'== phase O2: the eager-generator scripts at their default (odd) N, {C} configurations')
    results, launches = script_phase(torch, card, 'O2', runs, ('sweep', 'worm', 'worldline_worm'))
    gate_pulls('O2', eager_script_pulls(runs, results))
    return launches


# -- general D: the calculus, Form, and the D ≥ 3 path (no kernel exists there) --

def no_kernel_launched(label, counters):
    launches = {k: f.launches for k, f in counters.items()}
    say(f'  {label}: kernel launches {launches} (the Villain path at D ≥ 3 has no kernel)')
    require(not any(launches.values()), f'{label}: a kernel launched: {launches}')


def phase_calculus_general(torch):
    """D1: the calculus, sparse functions and Form at D = 3, 4 on the card
    against the port on the CPU: integer forms bit for bit, float forms
    (float32 on the card, float64 on the CPU) to 1e-5 relative."""
    from supervillain_tpu_torch import lattice as tl
    from supervillain_tpu_torch.ops import Lattice, calculus

    say('== phase D1: calculus, sparse functions and Form at D = 3, 4, card against CPU')
    t0 = time.perf_counter()
    rng = np.random.default_rng(41)
    worst, checked = 0.0, 0
    for D, N in ((3, 5), (3, 8), (4, 3), (4, 8)):
        L = Lattice(D, N)
        for p in range(D + 1):
            for integer in (True, False):
                shape = L.form_shape(p)
                host = torch.as_tensor(rng.integers(-5, 6, shape) if integer
                                       else rng.normal(size=shape))
                card = host.to('cuda', torch.int32 if integer else torch.float32)
                other = torch.as_tensor(rng.integers(-5, 6, L.form_shape(D - p)) if integer
                                        else rng.normal(size=L.form_shape(D - p)))
                ops = [('laplacian', lambda f, L=L, p=p: calculus.laplacian(L, p, f)),
                       ('star', lambda f, L=L, p=p: calculus.star(L, p, f)),
                       ('push', lambda f, D=D: calculus.push(f, (1, 2) + (0,) * (D - 2))),
                       ('pull', lambda f, D=D: calculus.pull(f, (0, 1) + (3,) * (D - 2))),
                       ('wedge', lambda f, L=L, p=p, D=D, o=other: calculus.wedge(
                           L, p, f, D - p, o.to(f.device, f.dtype)))]
                if p < D:
                    ops += [('d', lambda f, L=L, p=p: calculus.d(L, p, f)),
                            ('coface_sum', lambda f, L=L, p=p: calculus.coface_sum(L, p, f))]
                if p > 0:
                    ops += [('delta', lambda f, L=L, p=p: calculus.delta(L, p, f)),
                            ('face_sum', lambda f, L=L, p=p: calculus.face_sum(L, p, f))]
                for name, op in ops:
                    got, want = op(card), op(host)
                    require(got.is_cuda, f'D1: {name} left the card')
                    if integer:
                        require(torch.equal(got.cpu().long(), want),
                                f'D1: {name} D={D} N={N} p={p} integer forms differ')
                    else:
                        scale = max(1.0, float(want.abs().max()))
                        e = float((got.double().cpu() - want).abs().max()) / scale
                        worst = max(worst, e)
                        require(e < 1e-5, f'D1: {name} D={D} N={N} p={p}: {e!r}')
                    checked += 1
        # Form (host tier) from a card tensor, and the sparse functions on the card.
        f1 = torch.as_tensor(rng.integers(-4, 5, L.form_shape(1)), dtype=torch.int32,
                             device='cuda')
        form = L.form(1, f1)
        require(np.array_equal(np.asarray(form.coface_sum()),
                               calculus.coface_sum(L, 1, f1).cpu().numpy()), 'D1: Form coface')
        require(np.array_equal(np.asarray(tl.d(form)), calculus.d(L, 1, f1).cpu().numpy()),
                'D1: Form d')
        color = L.checkerboarding[0]
        values = torch.arange(len(color[0]), dtype=torch.int32, device='cuda') - 3
        got = tl.delta_sparse(L, 2, 0, color, values)
        require(got.is_cuda and torch.equal(got.cpu(), tl.delta_sparse(L, 2, 0, color,
                                                                       values.cpu())),
                'D1: delta_sparse on the card')
        checked += 3
    # The topological observables at D=4 (4⁴, W=1), measured and bootstrapped
    # on the card against the CPU in float64, relative bound MEASURE_RTOL.
    import supervillain_tpu_torch as sv
    S = sv.Villain(Lattice(4, 4), 0.4, W=1)
    cfgs = {'phi': rng.uniform(-math.pi, math.pi, (32, 1) + (4,) * 4),
            'n': rng.choice([-1, 0, 1], p=[0.2, 0.6, 0.2], size=(32, 4) + (4,) * 4)}
    names = ('TopologicalChargeDensity', 'TopologicalCharge', 'TopologicalChargeDensitySquared',
             'TopologicalTwoPoint')
    values = {}
    for device in ('cuda', 'cpu'):
        e = sv.Ensemble(S).from_configurations(sv.Configurations(dict(cfgs)), device=device)
        boot = sv.Bootstrap(e, draws=40, seed=3)
        values[device] = {**{n: getattr(e, n) for n in names},
                          'Bootstrap.Topological_Topological': boot.Topological_Topological}
    for name in values['cpu']:
        d = relative_difference(values['cuda'][name], values['cpu'][name])
        say(f'  D=4 {name}: card against CPU, largest relative difference {d!r}')
        require(d <= MEASURE_RTOL, f'D1: {name} on the card and the CPU differ by {d!r}')
        checked += 1
    require(np.array_equal(values['cuda']['TopologicalCharge'], np.zeros(32)),
            'D1: Q of a configuration on the torus is not 0')
    torch.cuda.synchronize()
    say(f'  D1: {checked} comparisons, largest relative float32 error {worst!r}; '
        f'{time.perf_counter() - t0!r} s')


def read_d4_log(path):
    """{κ: (ActionDensity, WindingSquared, ⟨Q²⟩·Λ)}, each (mean, error), of a
    d4-topology log's table."""
    rows = {}
    for line in open(path, encoding='utf-8'):
        head = re.match(r'\s*(\d+\.\d+)\s', line)
        if head:
            values = [parse_uncertain(m) for m in _UNCERTAIN.finditer(line[head.end():])]
            rows[float(head[1])] = tuple(values[:3])
    return rows


#: D2's runs: the shape of each committed d4-topology log.
D4_RUNS = (('d4-topology-N8-W1.log', ['--N', 8, '--chains', 32, '--steps', 60, '--thin', 2,
                                      '--cut', 20, '--kappas', 0.2, 0.4, 0.6, '--W', 1]),
           ('d4-topology-N8-Winf.log', ['--N', 8, '--chains', 32, '--steps', 60, '--thin', 2,
                                        '--cut', 20, '--kappas', 0.2, 0.4, 0.6, '--W', 'inf']),
           ('d4-topology-N12-W1.log', ['--N', 12, '--chains', 16, '--steps', 40, '--thin', 2,
                                       '--cut', 20, '--kappas', 0.4, '--W', 1]))


def phase_d4_topology(torch, card):
    """D2: the ported d4-topology.py on the card at each committed log's shape."""
    say('== phase D2: d4-topology.py on the card at the committed logs\' shapes')
    counters = script_counters()
    for f in counters.values():
        f.launches = 0
    t0 = time.perf_counter()
    pulls = {}
    for log, argv in D4_RUNS:
        say(f'  -- d4-topology.py {" ".join(str(a) for a in argv)}')
        t1 = time.perf_counter()
        results = run_script('d4-topology.py', argv)['results']
        torch.cuda.synchronize()
        say(f'  -- {log}: {time.perf_counter() - t1!r} s')
        reference = read_d4_log(repo_root() / RESULTS / log)
        require(sorted(results) == sorted(reference), f'D2: κ of {log} not all run')
        winf = '--W' in argv and argv[argv.index('--W') + 1] == 'inf'
        for kappa, res in results.items():
            S, W2, Q2 = reference[kappa]
            say(f'    κ={kappa}: ActionDensity {shown(res["S"])} (log {shown(S)}), '
                f'WindingSquared {shown(res["W2"])} (log {shown(W2)}), ⟨Q²⟩·Λ '
                f'{shown(res["Q2V"])} (log {shown(Q2)}), {res["su_per_s"]!r} su/s, '
                f'{res["seconds"]!r} s')
            pulls[f'{log} κ={kappa} ActionDensity'] = signed_pull(res['S'], S)
            if winf:
                require(res['W2'][0] == 0.0 and res['Q2V'][0] == 0.0,
                        f'D2: W=∞ needs WindingSquared ≡ 0 and Q ≡ 0, got {res}')
            else:
                pulls[f'{log} κ={kappa} WindingSquared'] = signed_pull(res['W2'], W2)
                pulls[f'{log} κ={kappa} ⟨Q²⟩·Λ'] = signed_pull(res['Q2V'], Q2)
    # At W=∞, n = dz + a harmonic winding: the φ modes are free Gaussians, so
    # ⟨S⟩/Λ = (Λ − 1)/(2Λ) up to winding sectors suppressed by e^{-2π²κN^{D−2}}.
    import supervillain_tpu_torch as sv
    from supervillain_tpu_torch.generators import villain as gv
    L = sv.Lattice(4, 8)
    S = sv.Villain(L, 0.4, W=float('inf'))
    chains, steps, cut = 128, 240, 80
    t1 = time.perf_counter()
    fleet = sv.sample_fleet(S, gv.Hammer(S), chains=chains, steps=steps, thin=1, seed=47,
                            device='cuda')
    means = np.asarray(fleet.pooled_ensemble(cut).ActionDensity,
                       dtype=np.float64).reshape(-1, chains).mean(axis=0)
    exact = (L.sites - 1) / (2 * L.sites)
    pulls['W=∞ equipartition, ⟨ActionDensity⟩ − (Λ−1)/(2Λ)'] = signed_pull(
        (means.mean(), means.std(ddof=1) / math.sqrt(chains)), (exact, 0.0))
    say(f'    W=∞, κ=0.4, {chains} chains × {steps} steps (cut {cut}): ⟨ActionDensity⟩ '
        f'{means.mean()!r} ± {means.std(ddof=1) / math.sqrt(chains)!r} against the exact '
        f'{exact!r}; {time.perf_counter() - t1!r} s')
    no_kernel_launched('D2', counters)
    gate_pulls('D2', pulls)
    say(f'  D2: {time.perf_counter() - t0!r} s (card: {card})')


#: D3's fleets: (D, κ, W, whether the CPU runs the same fleet beside the
#: card's).  At κ=0.2, W=1 a worm is short and the CPU's host loop affordable;
#: at W=2 (D=3) and κ=0.3 (D=4) a worm is thousands of moves, which only K2
#: makes affordable, so those run on the card alone.
D3_FLEETS = ((3, 0.2, 1, True), (4, 0.2, 1, True), (3, 0.2, 2, False), (4, 0.3, 1, False))
D3_STEPS = 16


def phase_worldline_general(torch, card):
    """D3: the generic Worldline Hammer at D = 3 and 4 (N=8) on the card with
    the plain twins refused, K2 launched once a step of each card fleet and
    every other kernel never: δm = 0 bit for bit on every kept draw, finite
    ActionDensity, and, at κ=0.2 and W=1, held in distribution against the
    port's same fleet on the CPU (per-chain means, |pull| < 4); W=2 at D=3 and
    κ=0.3 at D=4 on the card alone."""
    import supervillain_tpu_torch as sv
    from supervillain_tpu_torch.generators import worldline as gw
    from supervillain_tpu_torch.ops import calculus

    say(f'== phase D3: the Worldline Hammer at D = 3, 4 (N=8; κ=0.2, W=1 card against CPU; W=2 '
        f'at D=3 and κ=0.3 at D=4 on the card), {D3_STEPS} steps, K2 once a step')
    counters = script_counters()
    total = {k: 0 for k in counters}
    t0 = time.perf_counter()
    pulls = {}
    for D, kappa, W, on_cpu in D3_FLEETS:
        S = sv.Worldline(sv.Lattice(D, 8), kappa, W=W)
        cap = gw.fleet_worm_cap(S.Lattice)
        means = {}
        for device, chains in (('cuda', 32), ('cpu', 8))[:2 if on_cpu else 1]:
            for f in counters.values():
                f.launches = 0
            t1 = time.perf_counter()
            with PlainTwinsRefused():
                fleet = sv.sample_fleet(S, gw.Hammer(S, fleet=True), chains=chains,
                                        steps=D3_STEPS, thin=1, seed=D, device=device)
            seconds = time.perf_counter() - t1
            launches = {k: f.launches for k, f in counters.items()}
            label = f'D={D} κ={kappa} W={W}'
            if device == 'cuda':
                for k, v in launches.items():
                    total[k] += v
                require(launches['worldline_worm_general'] == D3_STEPS
                        and not any(v for k, v in launches.items()
                                    if k != 'worldline_worm_general'),
                        f'D3 {label}: K2 did not launch once a step, or a D=2 kernel '
                        f'launched: {launches}')
            m = fleet.columns['m']
            dm = calculus.delta(S.Lattice, 1, torch.as_tensor(m.reshape((-1,) + m.shape[2:])))
            require(bool((dm == 0).all()), f'D3: δm ≠ 0 at {label} on the {device}')
            e = fleet.pooled_ensemble(4)
            a = np.asarray(e.ActionDensity)
            require(np.isfinite(a).all(), f'D3: non-finite ActionDensity at {label}')
            means[device] = a.reshape(-1, chains).mean(axis=0)
            worm = fleet.stats['ClassicWorm']
            say(f'  [{card if device == "cuda" else "cpu"}] {label}, {chains} chains × '
                f'{D3_STEPS} steps: {seconds!r} s, ActionDensity {means[device].mean()!r} ± '
                f'{means[device].std(ddof=1) / math.sqrt(chains)!r}; worms: mean length '
                f'{worm["accepted"] / worm["sweeps"]!r}, {worm["sweeps"] - worm["acceptance"]!r} '
                f'of {worm["sweeps"]!r} truncated at {cap} moves; launches {launches}')
        if on_cpu:
            c, h = means['cuda'], means['cpu']
            pulls[f'D={D} κ={kappa} W={W} ActionDensity card − CPU'] = signed_pull(
                (c.mean(), c.std(ddof=1) / math.sqrt(len(c))),
                (h.mean(), h.std(ddof=1) / math.sqrt(len(h))))
    gate_pulls('D3', pulls)
    say(f'  D3: {time.perf_counter() - t0!r} s; launches on the card {total}')
    return total


def phase_dimension(torch, card):
    """D4: benchmark/dimension.py at D=4, N=8, 32 to 8192 chains."""
    from supervillain_tpu_torch.benchmark import dimension

    say('== phase D4: benchmark/dimension.py saturation curve at D=4, N=8 on the card')
    counters = script_counters()
    for f in counters.values():
        f.launches = 0
    t0 = time.perf_counter()
    curve = dimension.saturation_curve(D=4, N=8, chain_counts=(32, 128, 512, 2048, 8192),
                                       thin=16, reps=3, samples=1, device='cuda')
    require(curve and all(r > 0 for r in curve.values()), f'D4: bad curve {curve}')
    for k, r in curve.items():
        say(f'  [{card}] D=4 N=8 {k}: {r!r} site-updates/s (eager NeighborhoodUpdate)')
    no_kernel_launched('D4', counters)
    say(f'  D4: {time.perf_counter() - t0!r} s')
    return curve


# -- the chain mesh: global chain offsets, sharded fleets, processes ------------

#: Chains of P1's kernel calls, and where P1 cuts them into two shards.
OFFSET_CHAINS, OFFSET_CUT = 512, 128
#: P2's and P3's fused fleets: the main path's width, 3 records.
MESH_FLEETS = {'Villain Hammer W=1': ('Villain', 1), 'Worldline Hammer W=2': ('Worldline', 2)}
MESH_RECORDS = 3
#: Seconds P3's two ranks may take before the phase fails.
P3_LIMIT = 300


def flat_outputs(out):
    """A kernel wrapper's outputs as a list of tensors (inline dicts by key)."""
    tensors = []
    for x in out:
        tensors += [x[k] for k in sorted(x)] if isinstance(x, dict) else [x]
    return tensors


def fleet_differences(a, b):
    """The names of the columns, final fields and stats where two fleets differ."""
    out = [f'columns {k}' for k in sorted(set(a.columns) | set(b.columns))
           if k not in a.columns or k not in b.columns
           or not np.array_equal(a.columns[k], b.columns[k])]
    out += [f'final {k}' for k in sorted(set(a.final) | set(b.final))
            if k not in a.final or k not in b.final or not np.array_equal(a.final[k], b.final[k])]
    return out + (['stats'] if a.stats != b.stats else [])


def fleet_digest(fleet):
    """SHA-256 prefix of a fleet's columns, final fields and stats, in key order."""
    import hashlib
    h = hashlib.sha256()
    for part in (fleet.columns, fleet.final):
        for k in sorted(part):
            h.update(k.encode())
            h.update(np.ascontiguousarray(part[k]).tobytes())
    h.update(repr(sorted((t, sorted(s.items())) for t, s in fleet.stats.items())).encode())
    return h.hexdigest()[:16]


def mesh_fused_fleet(name, mesh, progress=None):
    """One of P2's fused fleets: L=256, 512 chains, κ=0.5, thin=50, one worm a
    record (capped at 64·N²), MESH_RECORDS records."""
    import supervillain_tpu_torch as sv
    action, W = MESH_FLEETS[name]
    S = getattr(sv, action)(sv.Lattice2D(256), 0.5, W=W)
    return sv.sample_fused_fleet(S, chains=512, steps=MESH_RECORDS, thin=50, worms=1,
                                 seed=20261017, mesh=mesh, progress=progress)


def counter(name):
    """The port's counter ``name`` (``supervillain_tpu_torch.tracing``)."""
    from supervillain_tpu_torch import tracing
    return tracing.counters().get(name, 0)


def collective_watch(calls, seen):
    """A ``progress`` wrapper that notes the collective count before each record
    and after the last."""
    def watch(records):
        for i in records:
            seen.append(calls())
            yield i
        seen.append(calls())
    return watch


def phase_chain_offsets(torch, card):
    """P1: each kernel on 512 chains, then on the shards [0, 128) and [128, 512)
    with chain0 = 0 and 128: every row equal bit for bit; the second shard
    against its plain version fed the Philox draws from chain0 = 128."""
    from supervillain_tpu_torch.ops import kernels
    from supervillain_tpu_torch.ops.sweep import (KernelSweepDraws, neighborhood_sweeps,
                                                  plain_sweeps, sweep_plan)
    from supervillain_tpu_torch.ops.worldline import (KernelWorldlineSweepDraws,
                                                      plain_worldline_sweeps, worldline_sweeps)
    from supervillain_tpu_torch.ops.worldline_worm import (KernelWorldlineWormDraws,
                                                           plain_worldline_worms, worldline_worms)
    from supervillain_tpu_torch.ops.worm import KernelWormDraws, classic_worms, plain_worms

    B, cut = OFFSET_CHAINS, OFFSET_CUT
    say(f'== phase P1: global chain offsets: each kernel on {B} chains against the shards '
        f'[0, {cut}) and [{cut}, {B}) with chain0 = 0 and {cut}, and the second shard against '
        f'its plain version on the Philox draws from chain0 = {cut}')
    t0 = time.perf_counter()
    err = {}

    def sharded(name, fn, fields, seed):
        """fn on the whole batch and on both shards, one seed; every row equal."""
        whole = fn(*fields, generator=torch.Generator().manual_seed(seed))
        parts = [fn(*(f[lo:hi] for f in fields), generator=torch.Generator().manual_seed(seed),
                    chain0=lo) for lo, hi in ((0, cut), (cut, B))]
        w, (p0, p1) = flat_outputs(whole), [flat_outputs(p) for p in parts]
        equal = all(torch.equal(a[:cut], b) and torch.equal(a[cut:], c)
                    for a, b, c in zip(w, p0, p1))
        say(f'  {name}: {len(w)} outputs of the shards equal to the whole call\'s rows: {equal}')
        require(equal, f'P1 {name}: a shard differs from its rows of the whole call')
        return whole, parts[1]

    def seed_of(s):
        return kernels.seed_from(torch.Generator().manual_seed(s))

    host = torch.Generator().manual_seed(2026)
    for N in (256, 255):
        plan = sweep_plan(N)
        phi = ((torch.rand((B, 1, N, N), generator=host) - 0.5) * 2 * math.pi).cuda()
        n = torch.zeros((B, 2, N, N), dtype=torch.int32, device='cuda')
        sweep = dict(kappa=0.5, W=2, interval_phi=math.pi, interval_n=1, sweeps=2)
        whole, part = sharded(f'B1 N={N} ({plan.regime})', lambda *f, **k: neighborhood_sweeps(
            *f, **sweep, **k), (phi, n), 30 + N)
        draws = KernelSweepDraws(seed_of(30 + N), B=B - cut, N=N, interval_phi=math.pi,
                                 interval_n=1, p_n=None, zmode=False, fdt=torch.float32,
                                 idt=torch.int32, device='cuda', chain0=cut)
        want = plain_sweeps(phi[cut:], n[cut:], kappa=0.5, W=2, sweeps=2, draws=draws)
        err['sweep'] = max(err.get('sweep', 0.0), compare_sweeps(f'B1 N={N} shard', part, want))
        if N == 256:
            worm = dict(kappa=0.5, W=2, worms=1, max_worm_moves=ODD_REPLAY_CAP)
            phi1, n1 = whole[0], whole[1]
            _, part = sharded('B2 N=256', lambda *f, **k: classic_worms(*f, **worm, **k),
                              (phi1, n1), 40)
            want = plain_worms(phi1[cut:], n1[cut:], **worm, draws=KernelWormDraws(
                seed_of(40), B=B - cut, N=N, device='cuda', chain0=cut))
            err['worm'] = compare_worms('B2 N=256 shard', part, want)
        m = torch.zeros((B, 2, N, N), dtype=torch.int32, device='cuda')
        v = torch.randint(-2, 3, (B, 1, N, N), generator=host, dtype=torch.int32).cuda()
        wsweep = dict(kappa=0.5, W=2, sweeps=2)
        whole, part = sharded(f'B4 N={N}', lambda *f, **k: worldline_sweeps(*f, **wsweep, **k),
                              (m, v), 50 + N)
        draws = KernelWorldlineSweepDraws(seed_of(50 + N), B=B - cut, N=N, interval_v=1,
                                          interval_t=1, interval_w=1, winf=False,
                                          fdt=torch.float32, idt=torch.int32, device='cuda',
                                          chain0=cut)
        want = plain_worldline_sweeps(m[cut:], v[cut:], kappa=0.5, W=2, sweeps=2, draws=draws)
        err['worldline_sweep'] = max(err.get('worldline_sweep', 0.0),
                                     compare_worldline_sweeps(f'B4 N={N} shard', part, want))
        if N == 256:
            worm = dict(kappa=0.5, W=2, worms=1, max_worm_moves=ODD_REPLAY_CAP)
            m1, v1 = whole[0], whole[1]
            _, part = sharded('B5 N=256', lambda *f, **k: worldline_worms(*f, **worm, **k),
                              (m1, v1), 60)
            want = plain_worldline_worms(m1[cut:], v1[cut:], **worm, draws=KernelWorldlineWormDraws(
                seed_of(60), B=B - cut, N=N, device='cuda', chain0=cut))
            err['worldline_worm'] = compare_worms('B5 N=256 shard', part, want)
    torch.cuda.synchronize()
    say(f'  P1: {time.perf_counter() - t0!r} s (card: {card}); largest errors {err}')
    return err


def phase_mesh_fleets(torch, card):
    """P2: the fused fleets at the main path's width and the generic Villain
    Hammer's sample_fleet at L=64 over cuda:0 alone (the unsharded
    reference), with mesh=None, over chain_mesh() and over the card listed 4
    times: equal columns, stats and final bit for bit.  With more than one
    card visible, mesh=None and chain_mesh() shard over every card, and the
    reference stays one card.  Returns the fused fleets' digests (for P3) and
    the kernels' launches."""
    import supervillain_tpu_torch as sv
    from supervillain_tpu_torch.generators import villain as gv
    from supervillain_tpu_torch.parallel import ChainMesh, chain_mesh

    reference = 'cuda:0 alone'
    meshes = {reference: ChainMesh(['cuda:0']), 'mesh=None': None, 'chain_mesh()': chain_mesh(),
              'cuda:0 listed 4 times': ChainMesh(['cuda:0'] * 4)}
    say(f'== phase P2: sharded fleets on the card: {", ".join(MESH_FLEETS)} (L=256, 512 chains, '
        f'κ=0.5, thin=50, 1 worm, {MESH_RECORDS} records) and sample_fleet of the generic '
        f'Villain Hammer (L=64, 1024 chains, W=2, thin=4, {MESH_RECORDS} records), each over '
        f'{", ".join(meshes)}')
    counters = script_counters()
    for f in counters.values():
        f.launches = 0
    t0 = time.perf_counter()
    digests = {}

    def over_meshes(name, run, records):
        fleets = {}
        for label, mesh in meshes.items():
            t1 = time.perf_counter()
            fleets[label] = run(mesh)
            torch.cuda.synchronize()
            say(f'  [{card}] {name}, {label}: {(time.perf_counter() - t1) / records!r} s per '
                f'record ({records} records, host copies included); mesh {fleets[label].mesh}')
        ref = fleets[reference]
        for label, fleet in fleets.items():
            diff = fleet_differences(fleet, ref)
            say(f'  {name}, {label} against {reference}: '
                f'{"equal bit for bit" if not diff else "differs in " + ", ".join(diff)}')
            require(not diff, f'P2 {name}: {label} differs from the unsharded fleet: {diff}')
        return ref

    for name in MESH_FLEETS:
        digests[name] = fleet_digest(over_meshes(name, lambda mesh: mesh_fused_fleet(name, mesh),
                                                 MESH_RECORDS))
    for W in (2, 1):
        S = sv.Villain(sv.Lattice2D(64), 0.5, W=W)
        over_meshes(f'sample_fleet Hammer(fleet=True) W={W}', lambda mesh: sv.sample_fleet(
            S, gv.Hammer(S, fleet=True), chains=1024, steps=MESH_RECORDS, thin=4, seed=17,
            mesh=mesh), MESH_RECORDS)
    launches = {k: f.launches for k, f in counters.items()}
    say(f'  P2: {time.perf_counter() - t0!r} s (card: {card}); launches {launches}')
    require(all(v > 0 for k, v in launches.items() if k != 'worldline_worm_general'),
            f'P2: a kernel never launched: {launches}')
    return digests, launches


def p3_rank(rank, init, out):
    """One of P3's two ranks: P2's fused fleets over chain_mesh() of a group of
    two processes on cuda:0, the digests of the returned fleets and the
    collective count inside and after the records, written to out/rank.json."""
    import torch
    from supervillain_tpu_torch.parallel import chain_mesh, distributed

    distributed.initialize(init, 2, rank)
    mesh = chain_mesh()
    result = {}
    for name in MESH_FLEETS:
        seen = []
        fleet = mesh_fused_fleet(name, mesh, collective_watch(
            lambda: counter('distributed.collective'), seen))
        result[name] = {'digest': fleet_digest(fleet), 'inside': seen[-1] - seen[0],
                        'after': counter('distributed.collective') - seen[-1],
                        'mesh': fleet.mesh,
                        'device': str(torch.cuda.current_device())}
    with open(f'{out}/rank{rank}.json', 'w') as f:
        json.dump(result, f)
    torch.distributed.destroy_process_group()


def phase_processes(torch, card, digests):
    """P3: two gloo ranks on the one card, each with its 256 chains of P2's
    fused fleets: both return P2's unsharded fleet bit for bit, with no
    collective inside the records and one gather after them."""
    import tempfile
    import torch.multiprocessing as mp

    say(f'== phase P3: two processes (gloo, file init) on cuda:0, 256 chains each of '
        f'{", ".join(MESH_FLEETS)}; joined within {P3_LIMIT} s')
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        context = mp.start_processes(p3_rank, args=(f'file://{tmp}/init', tmp), nprocs=2,
                                     join=False, start_method='spawn')
        deadline = time.monotonic() + P3_LIMIT
        try:
            while not context.join(timeout=1):
                require(time.monotonic() < deadline, f'P3: the ranks did not end in {P3_LIMIT} s')
        finally:
            for proc in context.processes:
                if proc.is_alive():
                    proc.kill()
                proc.join(timeout=30)
        ranks = []
        for rank in range(2):
            with open(f'{tmp}/rank{rank}.json') as f:
                ranks.append(json.load(f))
    for rank, result in enumerate(ranks):
        for name, r in result.items():
            say(f'  rank {rank} {name}: digest {r["digest"]} (unsharded, P2: {digests[name]}); '
                f'collectives inside the records {r["inside"]}, after them {r["after"]}; '
                f'mesh {r["mesh"]}; card {r["device"]}')
            require(r['digest'] == digests[name], f'P3 rank {rank} {name}: not the unsharded fleet')
            require(r['inside'] == 0, f'P3 rank {rank} {name}: a collective inside a record')
            require(r['after'] == 1, f'P3 rank {rank} {name}: {r["after"]} gathers after the records')
            require(r['mesh']['size'] == 2, f'P3 rank {rank} {name}: mesh {r["mesh"]}')
    say(f'  P3: {time.perf_counter() - t0!r} s (card: {card}), process start-up included')


def phase_scaling(torch, card):
    """P4: benchmark/scaling.py on the card: its one-card row (no efficiency on
    one card) and its collective audit (0 inside the records)."""
    import tempfile
    say('== phase P4: python -m supervillain_tpu_torch.benchmark.scaling on the card')
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        done = subprocess.run([sys.executable, '-m', 'supervillain_tpu_torch.benchmark.scaling',
                               '--json', f'{tmp}/scaling.json'], cwd=repo_root(),
                              capture_output=True, text=True, timeout=600)
        for line in done.stdout.splitlines():
            say(f'  | {line}')
        require(done.returncode == 0, f'P4: scaling.py failed ({done.returncode}): {done.stderr}')
        with open(f'{tmp}/scaling.json') as f:
            payload = json.load(f)
    rows, audit = payload['weak_scaling'], payload['collectives_in_compiled_step']
    require(len(rows) == 1 and rows[0]['devices'] == 1 and rows[0]['efficiency'] is None,
            f'P4: one card must give one row and no efficiency: {rows}')
    require(audit['inside_records'] == 0, f'P4: collectives inside the records: {audit}')
    say(f'  [{payload["config"]["card"]}] P4 one-card row: {rows[0]!r}; audit {audit}; '
        f'{time.perf_counter() - t0!r} s (card: {card})')


# -- the space axis: one chain's lattice over slabs, with halo exchange ---------------

#: S1's torus and chains, and its splits.
SLAB_N, SLAB_CHAINS, SLAB_SPLITS = 1024, 4, (2, 4)
#: S2's fleets (the shapes of __graft_entry__.py dryrun_multichip): N, κ and W,
#: chains a chains-row, records.
SPACE_FLEETS = {'Villain Hammer(fleet=True) W=2 κ=0.5': ('Villain', 0.5, 2),
                'Villain Hammer(fleet=True) W=2 κ=0.1': ('Villain', 0.1, 2),
                'Worldline Hammer(fleet=True) W=2 κ=0.5': ('Worldline', 0.5, 2),
                'Villain Hammer(fleet=True) W=1 κ=0.5': ('Villain', 0.5, 1)}
SPACE_N, SPACE_CHAINS, SPACE_RECORDS = 8, 4, 3
#: S2's NeighborhoodUpdate: L, records (one chain a chains-row).
SPACE_LARGE_N, SPACE_LARGE_RECORDS = 1024, 3
#: The chain × space meshes of S2, over cuda:0 listed chains·space times.
SPACE_MESHES = ((1, 2), (2, 2), (1, 4))


def one_card_row(torch, split, B, N):
    """A :class:`Row` of ``split`` slabs of one chains-row on cuda:0, as
    ``parallel/space.py`` builds it for a 1 × split mesh of cuda:0."""
    from supervillain_tpu_torch.ops.shard import Slab
    from supervillain_tpu_torch.parallel import space
    width = N // split
    device = torch.device('cuda', 0)
    local = [(s, device, Slab(N, s * width, width, space.GHOST)) for s in range(split)]
    return space.Row(0, range(B), split, local, None)


def phase_slab_kernel(torch, card):
    """S1: B1's slab entry at N=SLAB_N split 2 and 4 ways: one sweep (slab
    residual, a pass, a halo exchange, a pass) against the plain slab pass
    on the kernel's Philox draws cut to each slab, and against the whole
    torus's kernel call on the same seed; the ms per color pass with its halo
    and its bound.  Returns the slab entry's row of the kernels line."""
    from supervillain_tpu_torch.ops import kernels
    from supervillain_tpu_torch.ops.sweep import (STREAMING_PLAN, KernelSweepDraws, kernel_sweeps,
                                                  plain_slab_pass, slab_pass, slab_residual)
    from supervillain_tpu_torch.ops.shard import SlabGenerator
    from supervillain_tpu_torch.parallel import space

    N, B = SLAB_N, SLAB_CHAINS
    splits = ' and '.join(map(str, SLAB_SPLITS))
    say(f'== phase S1: B1\'s slab entry at N={N}, {B} chains, split {splits} '
        f'ways (ghost {space.GHOST}), against its plain twin on the kernel\'s draws and against '
        'the whole torus\'s call on the same seed')
    t0 = time.perf_counter()
    host = torch.Generator().manual_seed(2027)
    phi = ((torch.rand((B, 1, N, N), generator=host) - 0.5) * 2 * math.pi).cuda()
    n = torch.randint(-1, 2, (B, 2, N, N), generator=host, dtype=torch.int32).mul_(2).cuda()
    sweep = dict(kappa=0.5, W=2, interval_phi=math.pi, interval_n=1, p_n=None)
    seed = kernels.seed_from(torch.Generator().manual_seed(71))
    whole = kernel_sweeps(phi, n, STREAMING_PLAN, sweeps=1,
                          generator=torch.Generator().manual_seed(71), **sweep)
    whole_ms, _ = time_ms(torch, lambda: kernel_sweeps(
        phi, n, STREAMING_PLAN, sweeps=1, generator=torch.Generator().manual_seed(71), **sweep), 20)
    draws = KernelSweepDraws(seed, B=B, N=N, interval_phi=math.pi, interval_n=1, p_n=None,
                             zmode=False, fdt=torch.float32, idt=torch.int32, device='cuda')
    passes = [draws(0), draws(1)]
    result = {}
    for split in SLAB_SPLITS:
        row = one_card_row(torch, split, B, N)
        gens = [SlabGenerator(torch.Generator(device='cuda'), 0, B, slab)
                for _, _, slab in row.local]
        start = [{'phi': phi[..., slab.col0:slab.col0 + slab.width].contiguous(),
                  'n': n[..., slab.col0:slab.col0 + slab.width].contiguous()}
                 for _, _, slab in row.local]

        def sweep_slabs(step):
            states = space.halo_exchange(row, start)
            states = [st | {'r': slab_residual(st['phi'], st['n'])} for st in states]
            accepted = 0
            for color in (0, 1):
                if color:
                    states = space.halo_exchange(row, states)
                for j, ((_, _, slab), g) in enumerate(zip(row.local, gens)):
                    p, m, r, acc = step(states[j], color, slab, g)
                    states[j] = {'phi': p, 'n': m, 'r': r}
                    accepted = accepted + acc
            return states, accepted

        def kernel_step(st, color, slab, g):
            return slab_pass(st['phi'], st['n'], st['r'], color, generator=g, seed=seed, **sweep)

        def plain_step(st, color, slab, g):
            cut = {k: slab.cut(v) for k, v in passes[color].items()}
            return plain_slab_pass(st['phi'], st['n'], st['r'], color, cut, slab, kappa=0.5, W=2)

        got, got_acc = sweep_slabs(kernel_step)
        want, want_acc = sweep_slabs(plain_step)

        def joined(states, k):
            return torch.cat([slab.own(st[k]) for (_, _, slab), st in zip(row.local, states)], -1)

        sites = int((joined(got, 'phi') != joined(want, 'phi')).sum())
        links = int((joined(got, 'n') != joined(want, 'n')).sum())
        torus_sites = int((joined(got, 'phi') != whole[0]).sum())
        torus_links = int((joined(got, 'n') != whole[1]).sum())
        err = max(float((joined(got, k) - joined(want, k)).abs().max()) for k in ('phi', 'r'))
        say(f'  split {split}: the slab kernel against its plain twin: φ differs at {sites} of '
            f'{B * N * N} sites, n at {links} of {2 * B * N * N} links (rounding flips; bound '
            f'{SAME_DRAWS_SITES} of them); against the whole torus\'s kernel call: {torus_sites} '
            f'sites, {torus_links} links; accepted {got_acc.tolist()} against the whole call\'s '
            f'{whole[2].tolist()}; max |Δφ|, |Δr| against the plain twin {err!r}')
        require(sites <= SAME_DRAWS_SITES * B * N * N and links <= SAME_DRAWS_SITES * 2 * B * N * N,
                f'S1 split {split}: the slab kernel and its plain twin part on the same draws')
        require(torus_sites == 0 and torus_links == 0 and torch.equal(got_acc, whole[2]),
                f'S1 split {split}: the slab kernel differs from the whole torus\'s call')

        def one_pass(step):
            def run():
                states = space.halo_exchange(row, got)
                return [step(st, 0, slab, g)
                        for (_, _, slab), g, st in zip(row.local, gens, states)]
            return run

        ms, _ = time_ms(torch, one_pass(kernel_step), 20)
        halo_ms, _ = time_ms(torch, lambda: space.halo_exchange(row, got), 20)
        plain_ms, _ = time_ms(torch, one_pass(plain_step), 3)
        # A pass reads φ, n and r (20 B a site) and writes them once; it
        # updates half the torus's sites.
        nbytes = 2 * 20 * B * N * N
        bound_ms, bound_by = bound(nbytes, OPS_VILLAIN_SITE * B * N * N / 2)
        say(f'  [{card}] split {split}: {ms!r} ms per color pass with its halo exchange ({B} '
            f'chains, N={N}; CUDA events, mean of 20), of which the halo exchange alone '
            f'{halo_ms!r} ms; plain twin {plain_ms!r} ms; bound {bound_ms!r} ms ({bound_by}), '
            f'{ms / bound_ms!r}× the bound; the whole torus\'s call (one sweep: residual, '
            f'2 passes, sums) {whole_ms!r} ms')
        result[split] = {'ms_per_color_pass': ms, 'halo_exchange_ms': halo_ms,
                         'plain_ms': plain_ms, 'bound_ms': bound_ms, 'bound_by': bound_by,
                         'whole_torus_sweep_ms': whole_ms, 'max_abs_err': err,
                         'differing_sites': sites, 'differing_links': links}
    torch.cuda.synchronize()
    say(f'  S1: {time.perf_counter() - t0!r} s (card: {card})')
    return result


def space_counters():
    from supervillain_tpu_torch.ops.sweep import slab_pass
    return general_counters() | {'slab': slab_pass}


def phase_space_fleets(torch, card):
    """S2: sample_fleet over chain × space meshes of cuda:0 listed 2 and 4
    times: the W=2 Villain and Worldline Hammer(fleet=True) at N=SPACE_N and
    NeighborhoodUpdate at L=SPACE_LARGE_N, one chain a chains-row, each equal
    to the unsharded fleet bit for bit on every field, with the invariants
    held on every record.  The unsharded references run first; then every
    count is set to 0, the sharded fleets run with the plain twins refused
    on CUDA tensors, and the counts are read.  Returns the launches."""
    import supervillain_tpu_torch as sv
    from supervillain_tpu_torch.generators import villain as gv, worldline as gw
    from supervillain_tpu_torch.ops import calculus as calc
    from supervillain_tpu_torch.parallel import ChainMesh, chain_space_mesh

    say(f'== phase S2: space-sharded fleets on cuda:0 listed 2 and 4 times (meshes '
        f'{", ".join(f"{c}x{s}" for c, s in SPACE_MESHES)}): {", ".join(SPACE_FLEETS)} at '
        f'N={SPACE_N} ({SPACE_CHAINS} chains a chains-row, {SPACE_RECORDS} records), '
        f'NeighborhoodUpdate at L={SPACE_LARGE_N} (one chain a chains-row, '
        f'{SPACE_LARGE_RECORDS} records), each against the unsharded fleet')
    t0 = time.perf_counter()
    runs = []
    for name, (action, kappa, W) in SPACE_FLEETS.items():
        S = getattr(sv, action)(sv.Lattice2D(SPACE_N), kappa, W=W)
        G = (gv if action == 'Villain' else gw).Hammer(S, fleet=True)
        runs += [(name, S, G, chains, SPACE_RECORDS, (chains, space))
                 for chains, space in SPACE_MESHES]
    SL = sv.Villain(sv.Lattice2D(SPACE_LARGE_N), 0.5, W=1)
    runs += [(f'NeighborhoodUpdate L={SPACE_LARGE_N} W=1', SL, gv.NeighborhoodUpdate(SL), chains,
              SPACE_LARGE_RECORDS, (chains, space)) for chains, space in SPACE_MESHES]

    def fleet(S, G, chains, records, mesh):
        return sv.sample_fleet(S, G, chains=chains * (SPACE_CHAINS if S.Lattice.N == SPACE_N
                                                      else 1),
                               steps=records, seed=23, mesh=mesh)

    references = {}
    for name, S, G, chains, records, shape in runs:
        if (name, chains) not in references:
            t1 = time.perf_counter()
            references[(name, chains)] = fleet(S, G, chains, records, ChainMesh(['cuda:0']))
            torch.cuda.synchronize()
            references[(name, chains), 's'] = (time.perf_counter() - t1) / records
    counters = space_counters()
    for f in counters.values():
        f.launches = 0
    halo = counter('space.halo_exchange')
    with PlainTwinsRefused():
        for name, S, G, chains, records, shape in runs:
            t1 = time.perf_counter()
            mesh = chain_space_mesh(*shape, ['cuda:0'] * (shape[0] * shape[1]))
            got = fleet(S, G, chains, records, mesh)
            torch.cuda.synchronize()
            seconds = (time.perf_counter() - t1) / records
            want = references[(name, chains)]
            diff = fleet_differences(got, want)
            fields_diff = [d for d in diff if d != 'stats']
            stats_err = max(abs(got.stats[t][k] - v) / max(abs(v), 1e-30)
                            for t, st in want.stats.items() for k, v in st.items())
            L = S.Lattice
            if action_is_worldline(S):
                bad = int((calc.delta(L, 1, torch.as_tensor(got.columns['m'])) != 0).sum())
            else:
                dn = calc.d(L, 1, torch.as_tensor(got.columns['n']))
                bad = int((torch.remainder(dn, int(S.W)) != 0).sum())
            same = ('fields equal bit for bit' if not fields_diff
                    else 'differs in ' + ', '.join(fields_diff))
            say(f'  [{card}] {name}, mesh {shape[0]}x{shape[1]}: {same}'
                f' to the unsharded fleet; stats within {stats_err!r} relative; invariant broken '
                f'at {bad} cells; {seconds!r} s per record (unsharded '
                f'{references[(name, chains), "s"]!r})')
            require(not fields_diff, f'S2 {name} {shape}: differs from the unsharded fleet: {diff}')
            require(stats_err <= 1e-5, f'S2 {name} {shape}: stats differ by {stats_err}')
            require(bad == 0, f'S2 {name} {shape}: the invariant is broken')
    launches = {k: f.launches for k, f in counters.items()}
    launches['halo_exchanges'] = counter('space.halo_exchange') - halo
    say(f'  S2: {time.perf_counter() - t0!r} s (card: {card}); launches {launches}')
    require(all(launches[k] > 0 for k in ('slab', 'worm', 'worldline_worm', 'chunked_worm')),
            f'S2: a kernel of the space path never launched: {launches}')
    require(launches['sweep'] == 0, f'S2: the whole-torus sweep ran on a slab: {launches}')
    return launches


def action_is_worldline(S):
    return type(S).__name__ == 'Worldline'


def phase_space_audit(torch, card):
    """S3: benchmark/scaling.py's audits on the card: the space-sharded Hammer
    step (1×4 mesh of cuda:0, N=32) makes halo exchanges, and a chain mesh's
    records no collective."""
    from supervillain_tpu_torch.benchmark.scaling import (audit_collectives,
                                                          audit_space_collectives)
    from supervillain_tpu_torch.parallel import chain_mesh
    say('== phase S3: the space audit of benchmark/scaling.py and the chain audit')
    space_audit = audit_space_collectives(N=32, space=4)
    chain_audit = audit_collectives(N=32, chains=64, steps=3, mesh=chain_mesh())
    say(f'  [{card}] space-sharded Hammer step: {space_audit}; chain mesh records: {chain_audit}')
    require(space_audit['halo_exchanges'] > 0, f'S3: no halo exchange: {space_audit}')
    require(chain_audit['inside_records'] == 0, f'S3: collectives inside records: {chain_audit}')


#: WC's chains: a quarter of worm_cost.py's default 1024, to keep the whole run's time.
WC_CHAINS = 256


def phase_worm_cost(torch, card):
    """WC: python -m supervillain_tpu_torch.benchmark.worm_cost at L=64 and
    256, W=1 and 2, WC_CHAINS chains, and with --chunked 64 (W=1): one JSON
    line per (L, W)."""
    import contextlib
    import io
    from supervillain_tpu_torch.benchmark import worm_cost
    say(f'== phase WC: benchmark/worm_cost.py --L 64 256 --W 1 2 --chains {WC_CHAINS}, and '
        '--chunked 64 (its main, in this process)')
    t0 = time.perf_counter()
    rows = []
    for extra in ([], ['--chunked', '64']):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            worm_cost.main(['--L', '64', '256', '--W', '1', '2', '--chains', str(WC_CHAINS),
                            *extra])
        for line in out.getvalue().splitlines():
            say(f'  | {line}')
        rows += [json.loads(line) for line in out.getvalue().splitlines() if line.startswith('{')]
    require(len(rows) == 6 and all(0 <= r['worm_share'] <= 1 for r in rows),
            f'WC: expected 6 rows with shares in [0, 1]: {rows}')
    say(f'  WC: {time.perf_counter() - t0!r} s (card: {card})')


def main():
    import torch

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device is available', file=sys.stderr)
        return 1
    from supervillain_tpu_torch.generators import worldline as gw
    from supervillain_tpu_torch.ops import kernels

    card = phase_toolchain(torch, kernels)
    phase_build(kernels)
    phase_sweep(torch)
    phase_worm(torch)
    phase_invariants(torch)
    launches, ms, plain_ms, bounds, final, villain_kept = phase_main_path(torch, card)
    err = phase_same_draws(torch, final)
    del final
    phase_worldline_sweep(torch)
    phase_worldline_exact(torch)
    phase_duality(torch)
    w_launches, w_ms, w_plain_ms, w_bounds, w_final, worldline_kept = \
        phase_worldline_main_path(torch, card)
    err |= phase_worldline_same_draws(torch, w_final)
    del w_final
    phase_card_against_cpu(torch)
    phase_estimators(torch)
    phase_published_quantities(torch, card, villain_kept, worldline_kept)
    exact = phase_general_exact(torch)
    general = phase_general_full_width(torch, card)
    phase_general_host_path(torch)
    round_trip_ns = memory_round_trip_ns(torch)
    say(f'[{card}] one device-memory round trip: {round_trip_ns!r} ns (one thread chasing 20000 '
        f'dependent loads through a random cycle over 256 MiB, csrc/probe.cu; median of 3)')
    k1_err, k1 = phase_chunked_worm(torch, card, round_trip_ns)
    k2_err, k2, (k2_capped_ms, k2_plain_ms) = phase_general_worldline_worm(torch, card)
    phase_cli()
    scripts = [phase(torch, card) for phase in (
        phase_scan_w1, phase_scan_w2, phase_scan_l256, phase_pod_fleet, phase_self_dual,
        phase_winf_line, phase_small_scripts)]
    scripts = {k: sum(s[k] for s in scripts) for k in scripts[0]}
    odd_launches, odd_err, odd_timing = phase_odd_n(torch, card)
    odd_scripts = phase_odd_scripts(torch, card)
    phase_calculus_general(torch)
    phase_d4_topology(torch, card)
    d3 = phase_worldline_general(torch, card)
    phase_dimension(torch, card)
    offset_err = phase_chain_offsets(torch, card)
    digests, mesh_launches = phase_mesh_fleets(torch, card)
    phase_processes(torch, card, digests)
    phase_scaling(torch, card)
    slab = phase_slab_kernel(torch, card)
    space_launches = phase_space_fleets(torch, card)
    phase_space_audit(torch, card)
    phase_worm_cost(torch, card)
    launches |= w_launches
    ms |= w_ms
    plain_ms |= w_plain_ms
    bounds |= w_bounds
    err |= {'chunked_worm': k1_err, 'worldline_worm_general': k2_err}
    # K1's and K2's paths: the generic Villain Hammer at W=1 (G2b's L=256 row)
    # and the generic Worldline Hammer at D >= 3 (D3).
    path = launches | {'chunked_worm': general['chunked_worm'],
                       'worldline_worm_general': d3['worldline_worm_general']}
    ms |= {'chunked_worm': k1['ms'], 'worldline_worm_general': k2[K2_TIMED_CHAINS[0]]['ms']}
    plain_ms |= {'chunked_worm': k1['plain_ms'], 'worldline_worm_general': k2_plain_ms}
    bounds |= {'chunked_worm': k1['bound'],
               'worldline_worm_general': k2[K2_TIMED_CHAINS[0]]['bound']}
    extra = {'chunked_worm': {'latency_floor_ms': k1['latency_floor_ms'],
                              'shape': f'L=256, 512 chains, {K1_MOVES} micro-moves'},
             'worldline_worm_general': {
                 'latency_floor_ms': k2[K2_TIMED_CHAINS[0]]['latency_floor_ms'],
                 'round_trip_ns_in_its_working_set': k2[K2_TIMED_CHAINS[0]]['round_trip_ns'],
                 'ns_per_move_of_the_longest_worm': k2[K2_TIMED_CHAINS[0]]['ns_per_move'],
                 'shape': f'D=4, N=8, {K2_TIMED_CHAINS[0]} chains, κ=0.3, W=1, '
                          f'cap {gw.FLEET_CAP_PER_SITE}·sites',
                 'plain_ms_capped_at': ODD_REPLAY_CAP, 'ms_at_that_cap': k2_capped_ms,
                 f'at_{K2_TIMED_CHAINS[1]}_chains': {
                     'ms': k2[K2_TIMED_CHAINS[1]]['ms'],
                     'ns_per_move_of_the_longest_worm': k2[K2_TIMED_CHAINS[1]]['ns_per_move'],
                     'bound_ms': k2[K2_TIMED_CHAINS[1]]['bound'][0],
                     'latency_floor_ms': k2[K2_TIMED_CHAINS[1]]['latency_floor_ms'],
                     'round_trip_ns_in_its_working_set': k2[K2_TIMED_CHAINS[1]]['round_trip_ns']}}}

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
        # No Pallas kernel: the JAX package's device loops these put on the card.
        'chunked_worm': ('supervillain_tpu_torch/csrc/worm.cu',
                         'supervillain_tpu/generators/villain.py:614'),
        'worldline_worm_general': ('supervillain_tpu_torch/csrc/worldline_worm_general.cu',
                                   'supervillain_tpu/generators/worldline.py:335'),
    }
    def odd(name, N):
        t = odd_timing[N].get(name)
        return None if t is None else {'ms': t[0], 'bound_ms': t[1][0], 'bound_by': t[1][1]}

    report = {'kernels': [
        {'name': name, 'route': 'cuda', 'source': src, 'replaces': replaces,
         'launches': path[name],
         'launches_by_path': {'sample_fused_fleet (phases 6, W4)': launches.get(name, 0),
                              'sample_fleet, exact cases (G1)': exact.get(name, 0),
                              'sample_fleet Hammer(fleet=True), L=256 (G2b)': general.get(name, 0),
                              'the ported scripts at even N (E2-E8)': scripts[name],
                              'odd N against the plain twins (O1)': odd_launches.get(name, 0),
                              'the scripts at their odd default N (O2)': odd_scripts[name],
                              'D >= 3 (D2-D4)': d3.get(name, 0),
                              'sharded fleets on the card (P2)': mesh_launches[name],
                              'space-sharded fleets (S2)': space_launches.get(
                                  'slab' if name == 'sweep' else name, 0)},
         'launches_by_parity': {'even': launches.get(name, 0) + exact.get(name, 0)
                                + general.get(name, 0) + scripts[name] + d3.get(name, 0),
                                'odd': odd_launches.get(name, 0) + odd_scripts[name]},
         'max_abs_err': max(err[name], odd_err.get(name, 0.0), offset_err.get(name, 0.0)),
         'ms': ms[name], 'plain_ms': plain_ms[name], 'bound_ms': bounds[name][0],
         'bound_by': bounds[name][1], 'library_ms': None,
         'at_N255': odd(name, ODD_LARGE_N), 'at_N256_same_run': odd(name, 256)}
        | ({'slab_entry': {'launches': space_launches['slab'], 'at_N1024_by_split': slab}}
           if name == 'sweep' else {}) | extra.get(name, {})
        for name, (src, replaces) in sources.items()]}
    say(f'card: {card}')
    say(json.dumps(report))
    say(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                                           'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
