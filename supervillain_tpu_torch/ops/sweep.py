"""Fused Villain neighborhood sweeps: the CUDA kernel and its plain PyTorch twin.

Counterpart of :func:`supervillain_tpu.ops.pallas_sweep.neighborhood_sweeps`.
:func:`neighborhood_sweeps` dispatches by device: a CPU batch runs
:func:`plain_sweeps` with draws from a ``torch.Generator``, a CUDA batch runs
the kernel of ``csrc/sweep.cu`` (seeded from the same generator), and any
other device raises.  On the card, :func:`sweep_plan` picks the kernel's
regime from N alone: a chain resident in a thread-block cluster's shared
memory for the whole call (even N <= 304), kernels streaming it from
device memory (larger even N), or at odd N, where the torus needs four
colors, streaming passes that read each site's color from a table
(:func:`color_table`).  All give the same fields bit for bit where they
overlap.  The kernel is D=2 only, as the TPU kernel is.

The plain version is the same transition kernel as
:class:`supervillain_tpu.generators.villain.NeighborhoodUpdate` (and, at
``W = inf``, ``ExactNeighborhoodUpdate``), batched over chains and vectorised
over sites, in any dimension D (the eager updates run it at D >= 3, where no
kernel exists), with the random draws of each color pass as an input: from a
``torch.Generator`` (:class:`SweepDraws`), the JAX package's own (tests), or the
kernel's own Philox stream (:class:`KernelSweepDraws`), which makes it replay a
kernel call.  A batch that is a shard of a fleet (:mod:`.shard`) draws the
fleet's numbers and keeps its rows on the CPU, and counts the kernel's stream
from its first chain's global index, ``chain0``, on the card.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from . import calculus as calc
from . import kernels, philox, shard
from .lattice import Lattice, Lattice2D
from .. import tracing
from ..generators.base import metropolis, uniform_int_with_zero, zero_inflated_int

TWO_PI = 2 * np.pi


@lru_cache(maxsize=None)
def lattice(N: int, D: int = 2) -> Lattice:
    return Lattice2D(N) if D == 2 else Lattice(D, N)


def lattice_of(field) -> Lattice:
    """The lattice of a batch of forms (B, C, N, ..., N)."""
    return lattice(field.shape[-1], field.dim() - 2)


@lru_cache(maxsize=None)
def color_table(N: int, device) -> torch.Tensor:
    """Each site's checkerboard color on the D=2 lattice of side N, (N, N) int8
    on ``device``: the table the kernels read at odd N."""
    masks = lattice(N).checkerboard_masks
    return torch.as_tensor(np.argmax(masks, axis=0).astype(np.int8), device=device)


#: Bytes of one site of a chain held in shared memory: φ f32, n 2×i32, r 2×f32.
RESIDENT_BYTES_PER_SITE = 20
#: Dynamic shared memory one block of the resident kernel may take: the
#: H100's 232,448 bytes a block, less 1 KB for the kernel's static arrays.
RESIDENT_SHARED_BYTES = 232_448 - 1024
#: Cluster sizes a plan chooses from: powers of two up to the portable limit
#: of 8, which pack the card's GPCs (16 or 18 SMs each) without a remainder
#: larger than two SMs.
CLUSTER_SIZES = (1, 2, 4, 8)
RESIDENT_THREADS = 1024         # csrc/sweep.cu kResidentThreads
STREAMING_THREADS = 256         # csrc/sweep.cu sv_sweeps


#: The counters of a resident call's cycles (:func:`kernel_sweeps`), in the
#: order of the columns of its ``cycles``.
BARRIER_COUNTERS = ('sweep.villain.barrier_cycles', 'sweep.villain.cycles')


class SweepPlan(NamedTuple):
    """How the sweep kernel runs chains of one N (see :func:`sweep_plan`)."""
    regime: str         # 'resident' or 'streaming'
    cluster: int        # blocks per chain, each holding a band of rows (0: streaming)
    rows: int           # rows of the tallest band (0: streaming)
    threads: int        # threads per block
    shared_bytes: int   # dynamic shared memory per block


def bands(N, k):
    """(first row, rows) of each of k bands of a chain's N rows, in order: N // k
    rows each, one more for the first N % k bands (``csrc/sweep.cu``
    ``band_of``).  A resident plan's cluster ranks (k = its ``cluster``; none
    when streaming, k = 0) and the streaming inline sums' blocks
    (:func:`sum_bands`) cut a chain so."""
    if k == 0:
        return []
    base, extra = divmod(N, k)
    return [(band * base + min(band, extra), base + (band < extra)) for band in range(k)]


#: The plan of every even N beyond the resident regime's reach.
STREAMING_PLAN = SweepPlan('streaming', 0, 0, STREAMING_THREADS, 0)
#: The plan of every odd N: streaming passes over a color table.
TABLE_PLAN = SweepPlan('table', 0, 0, STREAMING_THREADS, 0)


@lru_cache(maxsize=None)
def sweep_plan(N: int) -> SweepPlan:
    """The sweep kernel's plan for chains of side ``N``, a function of N alone.

    At odd N, :data:`TABLE_PLAN`: the torus needs four colors, and one
    streaming launch a color reads each site's from :func:`color_table`.
    At even N, resident when some cluster size k of :data:`CLUSTER_SIZES` gives bands of
    ``ceil(N / k)`` rows whose 20 bytes a site fit :data:`RESIDENT_SHARED_BYTES`
    (up to N = 304); the plan takes the smallest such k, and one thread per
    entry of a band's color plane up to :data:`RESIDENT_THREADS`.  Otherwise
    the chain streams from device memory, one launch per color pass.  The card
    either runs the plan or raises: the regime is never a retry."""
    if N < 2:
        raise ValueError(f'the sweep kernel needs N >= 2, got N={N}')
    if N % 2:
        return TABLE_PLAN
    for k in CLUSTER_SIZES:
        rows = -(-N // k)
        shared = RESIDENT_BYTES_PER_SITE * rows * N
        if shared <= RESIDENT_SHARED_BYTES:
            entries = rows * (N // 2)
            threads = min(RESIDENT_THREADS, 32 * -(-entries // 32))
            return SweepPlan('resident', k, rows, threads, shared)
    return STREAMING_PLAN


#: Sites a block of the streaming inline sums takes, 64 a thread: at 64
#: chains of N=1024 the fastest of 33 to 512 bands a chain on the H100.
SUM_SITES = 64 * STREAMING_THREADS


def sum_bands(N: int) -> int:
    """Blocks a chain of the streaming regime's inline sums (``csrc/sweep.cu``
    ``inline_sums``), a function of N alone: each takes a band of rows
    (:func:`bands`) of about :data:`SUM_SITES` sites, and a chain of fewer
    than twice that one block.  Never more bands than the chain has rows.  So
    a chain's sums are added in one order whatever chains share its call and
    whatever the card: a shard gives its rows of the whole call bit for bit."""
    return max(1, min(N, N * N // SUM_SITES))


def resident_clusters(plan: SweepPlan) -> int:
    """How many clusters of a resident ``plan`` the card runs at once (0: none,
    and a launch would raise).  Needs the CUDA kernels."""
    active = ctypes.c_int(0)
    code = kernels.library().sv_sweeps_resident_clusters(plan.cluster, plan.threads,
                                                         plan.shared_bytes,
                                                         ctypes.addressof(active))
    kernels.check(code, 'resident_clusters')
    return active.value


class SweepDraws:
    """Draws of one color pass from a ``torch.Generator`` on the fields' device:
    ``{'phi', 'fwd', 'bwd', 'u'}`` or, in z-mode, ``{'phi', 'z', 'u'}``.

    ``phi`` is the Δφ proposal in ±interval_phi, ``fwd``/``bwd`` the integer
    Δn/W draws on each site's forward links and on the backward links indexed
    by link position, ``z`` the Δz draw, ``u`` the Metropolis uniforms, on the
    lattice of dimension ``D``."""

    def __init__(self, generator, *, B, N, interval_phi, interval_n, p_n, zmode,
                 fdt, idt, device, D=2):
        self.generator = generator
        self.B, self.N, self.D = B, N, D
        self.interval_phi, self.interval_n, self.p_n = interval_phi, interval_n, p_n
        self.zmode = zmode
        self.fdt, self.idt, self.device = fdt, idt, device

    def _ints(self, shape):
        if self.p_n is None:
            return uniform_int_with_zero(self.generator, shape, self.interval_n,
                                         dtype=self.idt, device=self.device)
        return zero_inflated_int(self.generator, shape, self.interval_n, self.p_n,
                                 dtype=self.idt, device=self.device)

    def __call__(self, color):
        g, dev, fdt = self.generator, self.device, self.fdt
        site = (self.B,) + (self.N,) * self.D
        link = (self.B, self.D) + site[1:]
        out = {'phi': (2 * shard.rand(g, site, dtype=fdt, device=dev) - 1) * self.interval_phi}
        if self.zmode:
            out['z'] = self._ints(site)
        else:
            out['fwd'] = self._ints(link)
            out['bwd'] = self._ints(link)
        out['u'] = shard.rand(g, site, dtype=fdt, device=dev)
        return out


class KernelSweepDraws:
    """The draws of one CUDA sweep-kernel call seeded with ``seed``, as a draw
    source of :func:`plain_sweeps`: Philox-4x32-10 keyed by the seed and
    countered by (site, chain0 + chain, color pass, k), with the kernel's
    float32 conversions (``csrc/sweep.cu``).  Fed these, the plain version
    repeats the kernel call; they can differ only where float rounding of ΔS
    flips a Metropolis decision.  Draws are made for every site; a pass uses
    its color's."""

    def __init__(self, seed, *, B, N, interval_phi, interval_n, p_n, zmode, fdt, idt, device,
                 chain0=0):
        self.key = philox.key_of(seed)
        self.interval_phi, self.interval_n, self.p_n = interval_phi, interval_n, p_n
        self.zmode = zmode
        self.fdt, self.idt, self.device = fdt, idt, device
        self.site = torch.arange(N * N, device=device).reshape(1, N, N)
        self.chain = (chain0 + torch.arange(B, device=device)).reshape(B, 1, 1)
        self.passes = 0

    def _int(self, a, b):
        """``draw`` of the kernel (an integer here): uniform in {-i..i}, or zero-inflated."""
        i, p = self.interval_n, self.p_n
        if p is None:
            return torch.floor(philox.u24(a) * float(2 * i + 1)).to(self.idt) - i
        u = philox.u24(a)
        mag = 1 if i == 1 else torch.floor(philox.u24(b) * float(i)).to(self.idt) + 1
        sign = (u < 0.5 * p).to(self.idt) - ((u >= 0.5 * p) & (u < p)).to(self.idt)
        return sign * mag

    def __call__(self, color):
        def words(k):
            return philox.philox4x32_10((self.site, self.chain, self.passes, k), self.key,
                                        self.device)

        w0, w1 = words(0), words(1)
        w2 = words(2) if self.p_n is not None and self.interval_n > 1 else (0,) * 4
        self.passes += 1
        out = {'phi': ((2 * philox.u24(w0[0]) - 1) * self.interval_phi).to(self.fdt),
               'u': philox.u24(w0[1]).to(self.fdt)}
        if self.zmode:
            out['z'] = self._int(w0[2], w1[2])
        else:
            out['fwd'] = torch.stack([self._int(w0[2], w1[2]), self._int(w0[3], w1[3])], dim=1)
            # The kernel draws the backward links' Δn at the site; the plain
            # version indexes them by link position x - e_mu.
            back = [self._int(w1[0], w2[0]), self._int(w1[1], w2[1])]
            out['bwd'] = torch.stack([torch.roll(back[mu], -1, dims=mu - 2) for mu in range(2)],
                                     dim=1)
        return out


def color_pass(phi, n, r, color, draws, *, kappa, W, slab=None):
    """One checkerboard color pass on a chain batch.

    ``phi`` (B, 1, N, ..., N), ``n`` and the residual ``r = dφ - 2πn`` (B, D, N,
    ..., N), ``draws`` as produced by :class:`SweepDraws`.  ``W = inf`` selects
    z-mode.  Returns the updated ``(phi, n, r)`` and the accepted count per chain.
    With a :class:`.shard.Slab`, the fields (and draws) are the padded slab's
    columns: the torus's color on them, and the accepts of its own columns."""
    L = lattice_of(phi)
    D, spatial = L.D, tuple(range(-L.D, 0))
    fdt = phi.dtype
    mask = L.mask(color, phi.device) if slab is None else slab.mask(lattice(slab.N), color,
                                                                    phi.device)
    change_phi = torch.where(mask, draws['phi'], 0)[:, None]

    if W == float('inf'):
        change_z = torch.where(mask, draws['z'], 0)[:, None]
        change_n = calc.d(L, 0, change_z)
    else:
        fwd = W * draws['fwd']
        bwd = W * draws['bwd']
        change_n_fwd = torch.stack(
            [torch.where(mask, fwd[:, mu], 0) for mu in range(D)], dim=1)
        change_n_bwd = torch.stack(
            [torch.where(torch.roll(mask, -1, dims=mu - D), bwd[:, mu], 0) for mu in range(D)],
            dim=1)
        change_n = change_n_fwd + change_n_bwd

    change_r = calc.d(L, 0, change_phi) - TWO_PI * change_n.to(fdt)
    dS_link = (kappa / 2) * change_r * (2 * r + change_r)
    dS = calc.face_sum(L, 1, dS_link)[:, 0]

    accept, _ = metropolis(draws['u'], dS)
    accept = accept & mask

    applied_phi = torch.where(accept, change_phi[:, 0], 0)[:, None]
    if W == float('inf'):
        applied_n = calc.d(L, 0, torch.where(accept, change_z[:, 0], 0)[:, None])
    else:
        applied_n = torch.stack(
            [torch.where(accept, change_n_fwd[:, mu], 0)
             + torch.where(torch.roll(accept, -1, dims=mu - D), change_n_bwd[:, mu], 0)
             for mu in range(D)], dim=1)

    phi = phi + applied_phi
    n = n + applied_n
    r = r + calc.d(L, 0, applied_phi) - TWO_PI * applied_n.to(fdt)
    accepted = accept.sum(dim=spatial) if slab is None else slab.site_sum(accept, D)
    return phi, n, r, accepted.to(fdt)


def plain_sweeps(phi, n, *, kappa, W, sweeps, draws):
    """``sweeps`` neighborhood sweeps in plain PyTorch, on any device.

    ``draws(color)`` supplies each color pass's draws, in order, over the
    lattice's ``n_colors`` colors (4 at odd N in D=2).  Any D.  Returns
    ``(phi, n, accepted, inline)`` like :func:`neighborhood_sweeps`."""
    L = lattice_of(phi)
    form = tuple(range(1, L.D + 2))
    fdt = phi.dtype
    r = calc.d(L, 0, phi) - TWO_PI * n.to(fdt)
    B = phi.shape[0]
    accepted = torch.zeros(B, dtype=fdt, device=phi.device)
    sS = torch.zeros_like(accepted)
    sw2 = torch.zeros_like(accepted)
    for _ in range(sweeps):
        for color in range(L.n_colors):
            phi, n, r, acc = color_pass(phi, n, r, color, draws(color), kappa=kappa, W=W)
            accepted = accepted + acc
        sS = sS + (kappa / 2) * torch.sum(r * r, dim=form) / L.sites
        dn = calc.d(L, 1, n).to(fdt)
        sw2 = sw2 + torch.sum(dn * dn, dim=form) / L.sites
    return phi, n, accepted, {'ActionDensity': sS / sweeps, 'WindingSquared': sw2 / sweeps}


def neighborhood_sweeps(phi, n, *, kappa, W, interval_phi, interval_n, sweeps,
                        p_n=None, generator, chain0=None):
    """Run ``sweeps`` fused neighborhood sweeps on a chain batch.

    Parameters
    ----------
    phi: (B, 1, N, N) float; n: (B, 2, N, N) int; any N >= 2
    W: int or ``float('inf')`` (z-mode: Δn = d(Δz), dn preserved exactly)
    generator: ``torch.Generator`` or a shard's :class:`.shard.ShardGenerator`
        — the draws on the CPU, the kernel seed on a GPU
    chain0: the global index of the batch's first chain, which the kernel's
        stream counts from (default: the generator's, 0 for a ``torch.Generator``)

    Returns
    -------
    (phi, n, accepted, inline): updated fields, accepted site updates per chain
    (B,), and the inline ``ActionDensity`` and ``WindingSquared`` per chain
    (B,), each averaged over the call's sweeps.
    """
    chain0 = shard.resolve_chain0(generator, chain0, phi.device)
    if phi.device.type == 'cpu':
        B, N = phi.shape[0], phi.shape[-1]
        draws = SweepDraws(generator, B=B, N=N, interval_phi=interval_phi,
                           interval_n=interval_n, p_n=p_n, zmode=W == float('inf'),
                           fdt=phi.dtype, idt=n.dtype, device=phi.device)
        return plain_sweeps(phi, n, kappa=kappa, W=W, sweeps=sweeps, draws=draws)
    if phi.device.type != 'cuda':
        raise ValueError(f'neighborhood_sweeps runs on the CPU or a CUDA device, not {phi.device}')

    B, N = kernels.require_fields(phi, n)
    return kernel_sweeps(phi, n, sweep_plan(N), kappa=kappa, W=W, interval_phi=interval_phi,
                         interval_n=interval_n, sweeps=sweeps, p_n=p_n, generator=generator,
                         chain0=chain0)


def kernel_sweeps(phi, n, plan, *, kappa, W, interval_phi, interval_n, sweeps, p_n=None,
                  generator, chain0=0, cycles=None):
    """:func:`neighborhood_sweeps` of a CUDA batch under a given ``plan``: its
    :func:`sweep_plan`, or (to compare the regimes on one card) the streaming
    or table plan at an even N that would be resident, the batch's first
    chain being ``chain0`` of the fleet.  ``cycles``, a (B·k, 2)
    int64 tensor on the card, receives for each block of a resident call the
    clock cycles its thread 0 waited at cluster barriers and its cycles in
    all.  While a ``torch.profiler`` records, a resident call given none
    makes its own; a resident call's cycles, summed over its blocks on the
    card, count in ``sweep.villain.barrier_cycles`` and
    ``sweep.villain.cycles`` (:mod:`..tracing`)."""
    B, N = kernels.require_fields(phi, n)
    if N % 2 and plan.regime != 'table':
        raise ValueError(f'an odd N={N} needs the table plan, not {plan.regime!r}')
    sweeps = int(sweeps)
    if sweeps < 1:
        raise ValueError(f'sweeps must be >= 1, got {sweeps}')
    lib = kernels.library()
    phi_out = torch.empty_like(phi)
    n_out = torch.empty_like(n)
    accepted = torch.empty(B, dtype=torch.int32, device=phi.device)
    sums = torch.empty((B, 2), dtype=torch.float64, device=phi.device)
    args = (B, N, sweeps, float(kappa), 0 if W == float('inf') else int(W), float(interval_phi),
            int(interval_n), -1.0 if p_n is None else float(p_n), kernels.seed_from(generator),
            kernels.chain_word(chain0, B))
    stream = kernels.stream_handle(phi.device)
    with torch.cuda.device(phi.device):
        if plan.regime == 'resident':
            if cycles is None and tracing.recording():
                cycles = torch.empty((B * plan.cluster, 2), dtype=torch.int64, device=phi.device)
            if cycles is not None and (cycles.shape != (B * plan.cluster, 2)
                                       or cycles.dtype != torch.int64
                                       or cycles.device != phi.device):
                raise ValueError(f'cycles must be ({B * plan.cluster}, 2) int64 on {phi.device}')
            code = lib.sv_sweeps_resident(
                phi.data_ptr(), n.data_ptr(), phi_out.data_ptr(), n_out.data_ptr(),
                accepted.data_ptr(), sums.data_ptr(),
                None if cycles is None else cycles.data_ptr(),
                *args, plan.cluster, plan.rows, plan.threads, plan.shared_bytes, stream)
        else:
            r = torch.empty(n.shape, dtype=torch.float32, device=phi.device)
            k = sum_bands(N)
            slot_r2, slot_dn2 = _sum_slots(B * k, phi.device)
            colors, n_colors = None, 2
            if plan.regime == 'table':
                colors, n_colors = color_table(N, phi.device), lattice(N).n_colors
            code = lib.sv_sweeps(
                phi.data_ptr(), n.data_ptr(), phi_out.data_ptr(), n_out.data_ptr(), r.data_ptr(),
                slot_r2.data_ptr(), slot_dn2.data_ptr(), accepted.data_ptr(), sums.data_ptr(),
                None if colors is None else colors.data_ptr(), n_colors, k, *args, stream)
    kernels.check(code, f'neighborhood_sweeps ({plan.regime})')
    neighborhood_sweeps.launches += 1
    if plan.regime == 'resident' and cycles is not None:
        tracing.count_on_device(BARRIER_COUNTERS, cycles.sum(dim=0))
    per_site = sums / (N * N * sweeps)
    inline = {'ActionDensity': ((kappa / 2) * per_site[:, 0]).float(),
              'WindingSquared': per_site[:, 1].float()}
    return phi_out, n_out, accepted.float(), inline


#: Calls that launched the CUDA kernel (the CPU path never counts).
neighborhood_sweeps.launches = 0


def _sum_slots(blocks, device):
    """The streaming inline sums' scratch: a float64 Σr² and an int64 Σ(dn)²
    slot a block."""
    return (torch.empty(blocks, dtype=torch.float64, device=device),
            torch.empty(blocks, dtype=torch.int64, device=device))


def streaming_sums(r, n, bands=None):
    """One sweep's inline sums of the streaming regime, alone: Σ r² and Σ (dn)²
    of each chain, (B, 2) float64, of a residual ``r`` (B, 2, N, N) float32 and
    ``n`` (B, 2, N, N) int32 on the card, reduced by the blocks and slots that
    :func:`kernel_sweeps` uses after every streaming sweep, in ``bands`` bands
    a chain (default :func:`sum_bands`)."""
    B, N = kernels._require_batch(('r', r), ('n', n), (torch.float32, torch.int32), (2, 2))
    k = sum_bands(N) if bands is None else int(bands)
    slot_r2, slot_dn2 = _sum_slots(B * k, r.device)
    sums = torch.empty((B, 2), dtype=torch.float64, device=r.device)
    with torch.cuda.device(r.device):
        code = kernels.library().sv_inline_sums(r.data_ptr(), n.data_ptr(), slot_r2.data_ptr(),
                                                slot_dn2.data_ptr(), sums.data_ptr(), k, B, N,
                                                kernels.stream_handle(r.device))
    kernels.check(code, 'streaming_sums')
    return sums


# -- the slab entry: one color pass over a slab of a chain × space mesh ----------

def slab_residual(phi, n):
    """The residual r = dφ − 2πn of a padded slab (B, ·, N, w + 2g) of a chain
    × space mesh: right on every column but the last, whose forward link
    leaves the slab (the passes never read it).  B1's slab entry builds it on
    the card (``csrc/sweep.cu`` ``init_residual_slab``), as ``sv_sweeps``
    builds the whole torus's."""
    if phi.device.type == 'cpu':
        return calc.d(lattice_of(phi), 0, phi) - TWO_PI * n.to(phi.dtype)
    B, N, padded = _require_slab(phi, n)
    r = torch.empty(n.shape, dtype=torch.float32, device=phi.device)
    with torch.cuda.device(phi.device):
        code = kernels.library().sv_slab_residual(phi.data_ptr(), n.data_ptr(), r.data_ptr(), B,
                                                  N, padded, kernels.stream_handle(phi.device))
    kernels.check(code, 'slab_residual')
    return r


def _require_slab(phi, n):
    """A Villain batch of padded slabs on the card: φ (B, 1, N, P) float32 and
    n (B, 2, N, P) int32, contiguous.  Returns (B, N, P)."""
    if phi.device.type != 'cuda' or n.device != phi.device:
        raise ValueError(f'the slab kernels need phi and n on one CUDA device, got '
                         f'{phi.device} and {n.device}')
    if (phi.dtype, n.dtype) != (torch.float32, torch.int32):
        raise TypeError(f'the slab kernels need float32 phi and int32 n, got {phi.dtype} '
                        f'and {n.dtype}')
    if phi.dim() != 4 or phi.shape[1] != 1 or tuple(n.shape) != (phi.shape[0], 2) + phi.shape[2:]:
        raise ValueError(f'a slab is phi (B, 1, N, P) and n (B, 2, N, P), got '
                         f'{tuple(phi.shape)} and {tuple(n.shape)}')
    if not (phi.is_contiguous() and n.is_contiguous()):
        raise ValueError('the slab kernels need contiguous phi and n')
    B, _, N, padded = phi.shape
    if 2 * B * N * padded >= 2 ** 31:
        raise ValueError(f'{B} slabs of {N}×{padded} exceed the kernels\' 32-bit indexing')
    return B, N, padded


def plain_slab_pass(phi, n, r, color, draws, slab, *, kappa, W):
    """The plain twin of :func:`slab_pass`: :func:`color_pass` on the padded
    slab, ``draws`` being the torus's cut to its columns (:class:`SweepDraws`
    of a :class:`.shard.SlabGenerator`, or ``slab.cut`` of each of the
    torus's draws)."""
    return color_pass(phi, n, r, color, draws, kappa=kappa, W=W, slab=slab)


def slab_pass(phi, n, r, color, *, kappa, W, interval_phi, interval_n, p_n, generator,
              seed=None):
    """One color pass of B1's slab entry over a batch of padded slabs.

    ``phi`` (B, 1, N, w + 2g), ``n`` and the residual ``r`` (B, 2, N, w + 2g)
    of the slab of ``generator``, a :class:`.shard.SlabGenerator`, whose ghost
    columns hold the neighbouring slabs' current values.  The pass updates the
    sites of ``color`` of every column but the outermost two (their ghosts
    included, which change the slab's own links as they do on the whole
    torus); the wrap holds along the unsharded axis only.  On the card,
    ``csrc/sweep.cu`` ``color_pass_slab``, whose Philox counters are the
    global site t·N + x, chain ``chain0 + chain`` and ``color``, with the
    kernel ``seed`` (required there, :func:`.kernels.seed_from` of the
    generator at the sweep's start): the numbers the whole torus's one-sweep
    call draws there.  On the CPU, :func:`plain_slab_pass` with the draws of
    :class:`SweepDraws` from the generator (no seed).  Returns ``(phi, n, r,
    accepted)``, the accepts counted over the slab's own columns."""
    slab = shard.slab_of(generator)
    if slab is None:
        raise ValueError('slab_pass runs the slab of a SlabGenerator')
    if phi.device.type == 'cpu':
        draws = SweepDraws(generator, B=phi.shape[0], N=slab.N, interval_phi=interval_phi,
                           interval_n=interval_n, p_n=p_n, zmode=W == float('inf'),
                           fdt=phi.dtype, idt=n.dtype, device=phi.device)(color)
        return plain_slab_pass(phi, n, r, color, draws, slab, kappa=kappa, W=W)
    if phi.device.type != 'cuda':
        raise ValueError(f'slab_pass runs on the CPU or a CUDA device, not {phi.device}')
    if seed is None:
        raise ValueError('slab_pass on a CUDA device needs the sweep\'s kernel seed')
    B, N, padded = _require_slab(phi, n)
    if padded != slab.padded or N != slab.N or N % 2:
        raise ValueError(f'a padded slab of {slab} is (B, ·, {slab.N}, {slab.padded}) at even '
                         f'N, got {tuple(phi.shape)}')
    chain0 = kernels.chain_word(shard.chain0_of(generator), B)
    if not r.is_contiguous() or r.dtype != torch.float32 or r.shape != n.shape:
        raise ValueError('the slab kernels need a contiguous float32 r shaped as n')
    phi, n, r = phi.clone(), n.clone(), r.clone()
    accepted = torch.zeros(B, dtype=torch.int32, device=phi.device)
    with torch.cuda.device(phi.device):
        code = kernels.library().sv_slab_color_pass(
            phi.data_ptr(), n.data_ptr(), r.data_ptr(), accepted.data_ptr(), B, N, padded,
            slab.first, slab.ghost, slab.width, int(color), int(seed), chain0, float(kappa),
            0 if W == float('inf') else int(W), float(interval_phi), int(interval_n),
            -1.0 if p_n is None else float(p_n), kernels.stream_handle(phi.device))
    kernels.check(code, 'slab_pass')
    slab_pass.launches += 1
    return phi, n, r, accepted.float()


#: Calls that launched B1's slab entry (the CPU path never counts).
slab_pass.launches = 0
