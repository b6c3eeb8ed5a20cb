"""Fused Worldline local-update sweeps: the CUDA kernel and its plain PyTorch twin.

Counterpart of :func:`supervillain_tpu.ops.pallas_worldline.worldline_sweeps`.
:func:`worldline_sweeps` dispatches by device: a CPU batch runs
:func:`plain_worldline_sweeps` with draws from a ``torch.Generator``, a CUDA
batch runs the kernel of ``csrc/worldline.cu`` (seeded from the same
generator), and any other device raises.

One sweep is the reference's local-update stack: checkerboarded VortexUpdate
passes (Δv on the plaquettes of each color in turn: 2 colors at even N, 4 at
odd N), CoexactUpdate passes (Δm = δt on the plaquettes of each color), then a
WrappingUpdate pass (a shift of m along whole torus cycles, μ = 0 and 1).  The
plain passes take any dimension D (a plaquette is then one component of a
2-form, swept color by color and component by component, as the JAX package
sweeps them); the kernel is D=2 only, as the TPU kernel is.  The plain version is the same transition
kernel as :class:`supervillain_tpu.generators.worldline.VortexUpdate`,
``CoexactUpdate`` and ``WrappingUpdate``, batched over chains, with the link
residual u = m − δv/_W kept beside the fields and the draws of each pass as an
input: from a ``torch.Generator`` (:class:`WorldlineSweepDraws`), the JAX
package's own (tests), or the kernel's own Philox stream
(:class:`KernelWorldlineSweepDraws`), which makes it replay a kernel call.

D=2 stencils: (δv)₀[t,x] = v[t,x] − v[t,x−1] and (δv)₁[t,x] = −(v[t,x] − v[t−1,x]),
so plaquette (t, x) touches the links ℓ₀[t,x], ℓ₀[t,x+1], ℓ₁[t,x] and ℓ₁[t+1,x].
"""

from __future__ import annotations

import numpy as np
import torch

from . import calculus as calc
from . import kernels, philox, shard
from .sweep import color_table, lattice, lattice_of
from ..device import float_dtype_of
from ..generators.base import metropolis, uniform_nonzero_int


def passes(L):
    """The per-sweep order of the passes on lattice ``L``, ``(kind, color,
    component)`` for the plaquette passes and ``('wrapping', μ, 0)``: every
    color's vortex passes (component by component), then the coexact ones,
    then one wrapping pass per direction.  A pass's index counts the kernel's
    draws: 6 a sweep at even N in D=2, 10 at odd N."""
    plaquettes = [(color, comp) for color in range(L.n_colors)
                  for comp in range(len(L.components[2]))]
    return ([('vortex', c, k) for c, k in plaquettes] + [('coexact', c, k) for c, k in plaquettes]
            + [('wrapping', mu, 0) for mu in range(L.D)])


#: The order of :func:`passes` at even N in D=2, as ``(kind, color or μ)``.
PASSES = tuple((kind, index) for kind, index, _ in passes(lattice(2)))


def inverse_w(W):
    """1/_W, with _W = W at finite W and 2π at W=∞.  The kernels and the plain
    versions both multiply by it, so that their residuals agree bit for bit."""
    return 1.0 / (2 * np.pi if W == float('inf') else float(W))


def residual(m, v, W):
    """The link residual u = m − δv/_W in the fields' float dtype."""
    fdt = float_dtype_of(v)
    return m.to(fdt) - calc.delta(lattice_of(m), 2, v).to(fdt) * inverse_w(W)


def action_density(m, v, kappa, W):
    """(1/2κ)Σu²/Λ per chain: the fused Worldline kernels' inline ActionDensity
    (1 minus the registry observable of that name, in D=2)."""
    u = residual(m, v, W)
    L = lattice_of(m)
    return (0.5 / kappa) * torch.sum(u * u, dim=tuple(range(-(L.D + 1), 0))) / L.sites


def _link_terms(kappa, u, du):
    """Per-link ΔS = (1/2κ)·du·(2u + du) of a change du of the residual."""
    return (0.5 / kappa) * du * (2 * u + du)


def on_component(values, comp, L):
    """A 2-form (B, C(D,2), N, ..., N) holding ``values`` (B, N, ..., N) on
    component ``comp`` and zero elsewhere."""
    comps = len(L.components[2])
    if comps == 1:
        return values[:, None]
    return torch.stack([values if k == comp else torch.zeros_like(values)
                        for k in range(comps)], dim=1)


def _mask(L, color, device, slab):
    """Color ``color`` of the lattice, or of the torus on a padded slab's columns."""
    return L.mask(color, device) if slab is None else slab.mask(lattice(slab.N, L.D), color,
                                                                device)


def _owned_sum(accept, D, slab):
    """Σ of ``accept`` over the sites, or over a padded slab's own columns."""
    return accept.sum(dim=tuple(range(-D, 0))) if slab is None else slab.site_sum(accept, D)


def vortex_pass(v, u, color, draws, *, kappa, W, comp=0, slab=None):
    """Δv on the plaquettes of ``color`` (component ``comp``): the links change
    by −δ(Δv)/_W.  Returns ``(v, u, accepted)`` with the accepted count per chain.
    With a :class:`.shard.Slab` the fields and draws are a padded slab's columns."""
    L = lattice_of(u)
    mask = _mask(L, color, u.device, slab)
    change = on_component(torch.where(mask, draws['v'], 0), comp, L)
    du = -(calc.delta(L, 2, change).to(u.dtype) * inverse_w(W))
    dS = calc.coface_sum(L, 1, _link_terms(kappa, u, du))[:, comp]
    accept, _ = metropolis(draws['u'], dS)
    accept = accept & mask
    applied = on_component(torch.where(accept, draws['v'], 0), comp, L)
    v = v + applied
    u = u - calc.delta(L, 2, applied).to(u.dtype) * inverse_w(W)
    return v, u, _owned_sum(accept, L.D, slab)


def coexact_pass(m, u, color, draws, *, kappa, comp=0, slab=None):
    """Δm = δt with t on the plaquettes of ``color`` (component ``comp``;
    δ(Δm) = 0 keeps the constraint).  Returns ``(m, u, accepted)``."""
    L = lattice_of(u)
    mask = _mask(L, color, u.device, slab)
    t = on_component(torch.where(mask, draws['t'], 0), comp, L)
    du = calc.delta(L, 2, t).to(u.dtype)
    dS = calc.coface_sum(L, 1, _link_terms(kappa, u, du))[:, comp]
    accept, _ = metropolis(draws['u'], dS)
    accept = accept & mask
    dm = calc.delta(L, 2, on_component(torch.where(accept, draws['t'], 0), comp, L))
    return m + dm, u + dm.to(u.dtype), _owned_sum(accept, L.D, slab)


def wrapping_pass(m, u, draws, *, kappa):
    """Δm ∈ ±{1..interval_w} along whole cycles: for each direction μ one
    proposal per cycle, a line along μ through each of the N^(D−1) positions
    perpendicular to it (ΔS summed along the line).  ``draws[μ]`` holds the
    cycles' ``'w'`` and ``'u'`` (B, N^(D−1)).  Every direction reads the
    residual from before the pass.  Returns ``(m, u, accepted)``."""
    D = u.dim() - 2
    B, N = u.shape[0], u.shape[-1]
    shifts, accepted = [], 0
    for mu in range(D):
        perp = (B,) + tuple(1 if i == mu else N for i in range(D))
        change = draws[mu]['w'].reshape(perp)
        dS = _link_terms(kappa, u[:, mu], change.to(u.dtype)).sum(dim=1 + mu)
        accept, _ = metropolis(draws[mu]['u'], dS.reshape(B, -1))
        shifts.append(torch.where(accept.reshape(perp), change, 0).expand((B,) + u.shape[2:]))
        accepted = accepted + accept.sum(dim=-1)
    shift = torch.stack(shifts, dim=1)
    return m + shift, u + shift.to(u.dtype), accepted


class WorldlineSweepDraws:
    """Draws of one pass from a ``torch.Generator`` on the fields' device.

    ``draws(kind, index)`` for a pass of :func:`passes`: ``{'v', 'u'}``
    (vortex: Δv in ±{1..interval_v}, or U(±interval_v) at W=∞), ``{'t', 'u'}``
    (coexact) over the sites of one plaquette component (B, N, ..., N), and
    ``{'w', 'u'}`` (wrapping) over the cycles of one direction (B, N^(D−1));
    ``u`` are the Metropolis uniforms."""

    def __init__(self, generator, *, B, N, interval_v, interval_t, interval_w, winf,
                 fdt, idt, device, D=2):
        self.generator, self.B, self.N, self.D = generator, B, N, D
        self.interval_v, self.interval_t, self.interval_w = interval_v, interval_t, interval_w
        self.winf, self.fdt, self.idt, self.device = winf, fdt, idt, device

    def _uniform(self, shape):
        return shard.rand(self.generator, shape, dtype=self.fdt, device=self.device)

    def _nonzero(self, shape, interval):
        return uniform_nonzero_int(self.generator, shape, interval, dtype=self.idt,
                                   device=self.device)

    def __call__(self, kind, index):
        plaquettes = (self.B,) + (self.N,) * self.D
        if kind == 'vortex':
            if self.winf:
                change = (2 * self._uniform(plaquettes) - 1) * self.interval_v
            else:
                change = self._nonzero(plaquettes, self.interval_v)
            return {'v': change, 'u': self._uniform(plaquettes)}
        if kind == 'coexact':
            return {'t': self._nonzero(plaquettes, self.interval_t), 'u': self._uniform(plaquettes)}
        cycles = (self.B, self.N ** (self.D - 1))
        return {'w': self._nonzero(cycles, self.interval_w), 'u': self._uniform(cycles)}


class KernelWorldlineSweepDraws:
    """The draws of one CUDA worldline-sweep call seeded with ``seed``, as a
    draw source of :func:`plain_worldline_sweeps`: Philox-4x32-10 keyed by the
    seed's Worldline key and countered by (plaquette or cycle, chain0 + chain,
    pass, 0), pass = (2·n_colors + 2)·sweep + the index in :func:`passes`
    (D=2), with the kernel's float32 conversions (``csrc/worldline.cu``).  Fed
    these, the plain version repeats the kernel call; they can differ only
    where float rounding of ΔS flips a Metropolis decision."""

    def __init__(self, seed, *, B, N, interval_v, interval_t, interval_w, winf, fdt, idt, device,
                 chain0=0):
        self.key = philox.worldline_key(seed)
        self.interval_v, self.interval_t, self.interval_w = interval_v, interval_t, interval_w
        self.winf, self.fdt, self.idt, self.device = winf, fdt, idt, device
        self.plaquette = torch.arange(N * N, device=device).reshape(1, N, N)
        self.cycle = torch.arange(N, device=device).reshape(1, N)
        self.chain = chain0 + torch.arange(B, device=device)
        self.passes = 0

    def _nonzero(self, word, interval):
        """``draw_nonzero`` of the kernel: ±{1..i} as floor(u·2i) − i, shifted past 0."""
        r = torch.floor(philox.u24(word) * float(2 * interval)).to(self.idt) - interval
        return torch.where(r < 0, r, r + 1)

    def __call__(self, kind, index):
        p = self.passes
        self.passes += 1
        if kind == 'wrapping':
            w = philox.philox4x32_10((self.cycle, self.chain[:, None], p, 0), self.key, self.device)
            return {'w': self._nonzero(w[0], self.interval_w), 'u': philox.u24(w[1]).to(self.fdt)}
        w = philox.philox4x32_10((self.plaquette, self.chain[:, None, None], p, 0), self.key,
                                 self.device)
        out = {'u': philox.u24(w[1]).to(self.fdt)}
        if kind == 'coexact':
            out['t'] = self._nonzero(w[0], self.interval_t)
        elif self.winf:
            out['v'] = ((2 * philox.u24(w[0]) - 1) * self.interval_v).to(self.fdt)
        else:
            out['v'] = self._nonzero(w[0], self.interval_v)
        return out


def plain_worldline_sweeps(m, v, *, kappa, W, sweeps, draws):
    """``sweeps`` worldline local-update sweeps in plain PyTorch, on any device.

    ``draws(kind, index)`` supplies each pass's draws (index: the color, or μ
    of a wrapping pass), in the order of :func:`passes`: every plaquette color of the lattice (4 at odd N in D=2),
    in any D.  Returns ``(m, v, accepted, inline)`` like :func:`worldline_sweeps`."""
    L = lattice_of(m)
    u = residual(m, v, W)
    accepted = torch.zeros(m.shape[0], dtype=u.dtype, device=m.device)
    sS = torch.zeros_like(accepted)
    order = passes(L)
    for _ in range(sweeps):
        wrapping = []
        for kind, index, comp in order:
            if kind == 'vortex':
                v, u, acc = vortex_pass(v, u, index, draws(kind, index), kappa=kappa, W=W,
                                        comp=comp)
            elif kind == 'coexact':
                m, u, acc = coexact_pass(m, u, index, draws(kind, index), kappa=kappa, comp=comp)
            else:
                wrapping.append(draws(kind, index))
                continue
            accepted = accepted + acc
        m, u, acc = wrapping_pass(m, u, wrapping, kappa=kappa)
        accepted = accepted + acc
        sS = sS + (0.5 / kappa) * torch.sum(u * u, dim=tuple(range(1, L.D + 2))) / L.sites
    return m, v, accepted, {'ActionDensity': sS / sweeps}


#: The most chains one kernel call takes: the chain is the grid's y index.
MAX_CHAINS = 65535


def sweep_scratch(m, v):
    """Scratch of one kernel call on (m, v), in the kernel's layout of the call
    (at even N each field split by site color into two planes of N rows of N/2
    sites; at odd N the public one):
    v, T (the summed coexact changes of each plaquette, int32) and the
    residual u (float32); and per cycle (B, 2N), the summed wrapping shifts
    (int32) and Σu² (double)."""
    B, _, N, _ = m.shape
    dev = m.device
    return {'v': torch.empty_like(v), 't': torch.empty(v.shape, dtype=torch.int32, device=dev),
            'u': torch.empty(m.shape, dtype=torch.float32, device=dev),
            'shifts': torch.empty((B, 2 * N), dtype=torch.int32, device=dev),
            'squares': torch.empty((B, 2 * N), dtype=torch.float64, device=dev)}


def worldline_sweeps(m, v, *, kappa, W, interval_v=1, interval_t=1, interval_w=1, sweeps,
                     generator, chain0=None):
    """Run ``sweeps`` fused worldline local-update sweeps on a chain batch.

    Parameters
    ----------
    m: (B, 2, N, N) int; v: (B, 1, N, N) int (finite W) or float (W = inf); any N >= 2
    interval_v: Δv range (a float width at W = inf); interval_t, interval_w: Δm ranges
    generator: ``torch.Generator`` or a shard's :class:`.shard.ShardGenerator`
        — the draws on the CPU, the kernel seed on a GPU
    chain0: the global index of the batch's first chain, which the kernel's
        stream counts from (default: the generator's, 0 for a ``torch.Generator``)

    Returns
    -------
    (m, v, accepted, inline): updated fields, accepted proposals per chain (B,)
    out of 2·N² + 2N per sweep, and the inline ``ActionDensity``
    (1/2κ)Σ(m − δv/_W)²/Λ per chain (B,), taken after each sweep's wrapping pass
    and averaged over the sweeps.
    """
    winf = W == float('inf')
    interval_v = float(interval_v) if winf else int(interval_v)
    chain0 = shard.resolve_chain0(generator, chain0, m.device)
    if m.device.type == 'cpu':
        B, N = m.shape[0], m.shape[-1]
        draws = WorldlineSweepDraws(generator, B=B, N=N, interval_v=interval_v,
                                    interval_t=int(interval_t), interval_w=int(interval_w),
                                    winf=winf, fdt=float_dtype_of(v), idt=m.dtype, device=m.device)
        return plain_worldline_sweeps(m, v, kappa=kappa, W=W, sweeps=sweeps, draws=draws)
    if m.device.type != 'cuda':
        raise ValueError(f'worldline_sweeps runs on the CPU or a CUDA device, not {m.device}')

    B, N = kernels.require_worldline_fields(m, v, W)
    if B > MAX_CHAINS:
        raise ValueError(f'worldline_sweeps takes at most {MAX_CHAINS} chains per call, got {B}')
    sweeps = int(sweeps)
    if sweeps < 1:
        raise ValueError(f'sweeps must be >= 1, got {sweeps}')
    lib = kernels.library()
    m_out = torch.empty_like(m)
    v_out = torch.empty_like(v)
    scratch = sweep_scratch(m, v)
    accepted = torch.empty(B, dtype=torch.int32, device=m.device)
    sums = torch.empty(B, dtype=torch.float64, device=m.device)
    colors = color_table(N, m.device) if N % 2 else None
    entry = lib.sv_worldline_sweeps_winf if winf else lib.sv_worldline_sweeps
    seed = kernels.seed_from(generator)
    with torch.cuda.device(m.device):
        code = entry(m.data_ptr(), v.data_ptr(), m_out.data_ptr(), v_out.data_ptr(),
                     *(scratch[k].data_ptr() for k in ('v', 't', 'u', 'shifts', 'squares')),
                     accepted.data_ptr(), sums.data_ptr(),
                     None if colors is None else colors.data_ptr(), lattice(N).n_colors,
                     B, N, sweeps, float(0.5 / kappa),
                     float(inverse_w(W)), float(interval_v), int(interval_t), int(interval_w),
                     seed, kernels.chain_word(chain0, B), kernels.stream_handle(m.device))
    kernels.check(code, 'worldline_sweeps')
    worldline_sweeps.launches += 1
    inline = {'ActionDensity': ((0.5 / kappa) * sums / (N * N * sweeps)).float()}
    return m_out, v_out, accepted.float(), inline


#: Calls that launched the CUDA kernel (the CPU path never counts).
worldline_sweeps.launches = 0
