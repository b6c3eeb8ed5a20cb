"""Fused Worldline local-update sweeps: the CUDA kernel and its plain PyTorch twin.

Counterpart of :func:`supervillain_tpu.ops.pallas_worldline.worldline_sweeps`.
:func:`worldline_sweeps` dispatches by device: a CPU batch runs
:func:`plain_worldline_sweeps` with draws from a ``torch.Generator``, a CUDA
batch runs the kernel of ``csrc/worldline.cu`` (seeded from the same
generator), and any other device raises.

One sweep is the reference's local-update stack: checkerboarded VortexUpdate
passes (Δv on the plaquettes of color 0, then 1), CoexactUpdate passes (Δm = δt
on the plaquettes of each color), then a WrappingUpdate pass (a shift of m along
whole torus cycles, μ = 0 and 1).  The plain version is the same transition
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
from . import kernels, philox
from .sweep import lattice
from ..device import float_dtype_of
from ..generators.base import metropolis, uniform_nonzero_int

#: The per-sweep order of the passes; a pass's index in it counts the kernel's draws.
PASSES = (('vortex', 0), ('vortex', 1), ('coexact', 0), ('coexact', 1),
          ('wrapping', 0), ('wrapping', 1))


def inverse_w(W):
    """1/_W, with _W = W at finite W and 2π at W=∞.  The kernels and the plain
    versions both multiply by it, so that their residuals agree bit for bit."""
    return 1.0 / (2 * np.pi if W == float('inf') else float(W))


def residual(m, v, W):
    """The link residual u = m − δv/_W in the fields' float dtype."""
    fdt = float_dtype_of(v)
    return m.to(fdt) - calc.delta(lattice(m.shape[-1]), 2, v).to(fdt) * inverse_w(W)


def action_density(m, v, kappa, W):
    """(1/2κ)Σu²/Λ per chain: the fused Worldline kernels' inline ActionDensity
    (1 minus the registry observable of that name, in D=2)."""
    u = residual(m, v, W)
    return (0.5 / kappa) * torch.sum(u * u, dim=(-3, -2, -1)) / (m.shape[-1] ** 2)


def _link_terms(kappa, u, du):
    """Per-link ΔS = (1/2κ)·du·(2u + du) of a change du of the residual."""
    return (0.5 / kappa) * du * (2 * u + du)


def vortex_pass(v, u, color, draws, *, kappa, W):
    """Δv on the plaquettes of ``color``: the links change by −δ(Δv)/_W.
    Returns ``(v, u, accepted)`` with the accepted count per chain."""
    L = lattice(u.shape[-1])
    mask = L.mask(color, u.device)
    change = torch.where(mask, draws['v'], 0)
    du = -(calc.delta(L, 2, change[:, None]).to(u.dtype) * inverse_w(W))
    dS = calc.coface_sum(L, 1, _link_terms(kappa, u, du))[:, 0]
    accept, _ = metropolis(draws['u'], dS)
    accept = accept & mask
    applied = torch.where(accept, change, 0)[:, None]
    v = v + applied
    u = u - calc.delta(L, 2, applied).to(u.dtype) * inverse_w(W)
    return v, u, accept.sum(dim=(-2, -1))


def coexact_pass(m, u, color, draws, *, kappa):
    """Δm = δt with t on the plaquettes of ``color`` (δ(Δm) = 0 keeps the
    constraint).  Returns ``(m, u, accepted)``."""
    L = lattice(u.shape[-1])
    mask = L.mask(color, u.device)
    t = torch.where(mask, draws['t'], 0)
    du = calc.delta(L, 2, t[:, None]).to(u.dtype)
    dS = calc.coface_sum(L, 1, _link_terms(kappa, u, du))[:, 0]
    accept, _ = metropolis(draws['u'], dS)
    accept = accept & mask
    dm = calc.delta(L, 2, torch.where(accept, t, 0)[:, None])
    return m + dm, u + dm.to(u.dtype), accept.sum(dim=(-2, -1))


def wrapping_pass(m, u, draws0, draws1, *, kappa):
    """Δm ∈ ±{1..interval_w} along whole cycles: for μ = 0 one proposal per
    column x (ΔS summed over t), for μ = 1 one per row t (summed over x).  Both
    read the residual from before the pass.  Returns ``(m, u, accepted)``."""
    B, _, N, _ = u.shape
    c0 = draws0['w'].to(u.dtype)[:, None, :]
    c1 = draws1['w'].to(u.dtype)[:, :, None]
    accept0, _ = metropolis(draws0['u'], _link_terms(kappa, u[:, 0], c0).sum(dim=-2))
    accept1, _ = metropolis(draws1['u'], _link_terms(kappa, u[:, 1], c1).sum(dim=-1))
    shift = torch.stack([torch.where(accept0, draws0['w'], 0)[:, None, :].expand(B, N, N),
                         torch.where(accept1, draws1['w'], 0)[:, :, None].expand(B, N, N)], dim=1)
    return m + shift, u + shift.to(u.dtype), accept0.sum(dim=-1) + accept1.sum(dim=-1)


class WorldlineSweepDraws:
    """Draws of one pass from a ``torch.Generator`` on the fields' device.

    ``draws(kind, index)`` for a pass of :data:`PASSES`: ``{'v', 'u'}`` (vortex:
    Δv in ±{1..interval_v}, or U(±interval_v) at W=∞), ``{'t', 'u'}`` (coexact)
    over the plaquettes (B, N, N), and ``{'w', 'u'}`` (wrapping) over the cycles
    (B, N); ``u`` are the Metropolis uniforms."""

    def __init__(self, generator, *, B, N, interval_v, interval_t, interval_w, winf,
                 fdt, idt, device):
        self.generator, self.B, self.N = generator, B, N
        self.interval_v, self.interval_t, self.interval_w = interval_v, interval_t, interval_w
        self.winf, self.fdt, self.idt, self.device = winf, fdt, idt, device

    def _uniform(self, shape):
        return torch.rand(shape, generator=self.generator, dtype=self.fdt, device=self.device)

    def _nonzero(self, shape, interval):
        return uniform_nonzero_int(self.generator, shape, interval, dtype=self.idt,
                                   device=self.device)

    def __call__(self, kind, index):
        plaquettes = (self.B, self.N, self.N)
        if kind == 'vortex':
            if self.winf:
                change = (2 * self._uniform(plaquettes) - 1) * self.interval_v
            else:
                change = self._nonzero(plaquettes, self.interval_v)
            return {'v': change, 'u': self._uniform(plaquettes)}
        if kind == 'coexact':
            return {'t': self._nonzero(plaquettes, self.interval_t), 'u': self._uniform(plaquettes)}
        return {'w': self._nonzero((self.B, self.N), self.interval_w),
                'u': self._uniform((self.B, self.N))}


class KernelWorldlineSweepDraws:
    """The draws of one CUDA worldline-sweep call seeded with ``seed``, as a
    draw source of :func:`plain_worldline_sweeps`: Philox-4x32-10 keyed by the
    seed's Worldline key and countered by (plaquette or cycle, chain, pass, 0),
    pass = 6·sweep + the index in :data:`PASSES`, with the kernel's float32
    conversions (``csrc/worldline.cu``).  Fed these, the plain version repeats
    the kernel call; they can differ only where float rounding of ΔS flips a
    Metropolis decision."""

    def __init__(self, seed, *, B, N, interval_v, interval_t, interval_w, winf, fdt, idt, device):
        self.key = philox.worldline_key(seed)
        self.interval_v, self.interval_t, self.interval_w = interval_v, interval_t, interval_w
        self.winf, self.fdt, self.idt, self.device = winf, fdt, idt, device
        self.plaquette = torch.arange(N * N, device=device).reshape(1, N, N)
        self.cycle = torch.arange(N, device=device).reshape(1, N)
        self.chain = torch.arange(B, device=device)
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

    ``draws(kind, index)`` supplies each pass's draws, in the order of
    :data:`PASSES`.  Returns ``(m, v, accepted, inline)`` like
    :func:`worldline_sweeps`."""
    L = lattice(m.shape[-1])
    u = residual(m, v, W)
    accepted = torch.zeros(m.shape[0], dtype=u.dtype, device=m.device)
    sS = torch.zeros_like(accepted)
    for _ in range(sweeps):
        for color in range(2):
            v, u, acc = vortex_pass(v, u, color, draws('vortex', color), kappa=kappa, W=W)
            accepted = accepted + acc
        for color in range(2):
            m, u, acc = coexact_pass(m, u, color, draws('coexact', color), kappa=kappa)
            accepted = accepted + acc
        m, u, acc = wrapping_pass(m, u, draws('wrapping', 0), draws('wrapping', 1), kappa=kappa)
        accepted = accepted + acc
        sS = sS + (0.5 / kappa) * torch.sum(u * u, dim=(1, 2, 3)) / L.sites
    return m, v, accepted, {'ActionDensity': sS / sweeps}


#: The most chains one kernel call takes: the chain is the grid's y index.
MAX_CHAINS = 65535


def sweep_scratch(m, v):
    """Scratch of one kernel call on (m, v), in the kernel's private layout
    (each field split by site color into two planes of N rows of N/2 sites):
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
                     generator):
    """Run ``sweeps`` fused worldline local-update sweeps on a chain batch.

    Parameters
    ----------
    m: (B, 2, N, N) int; v: (B, 1, N, N) int (finite W) or float (W = inf)
    interval_v: Δv range (a float width at W = inf); interval_t, interval_w: Δm ranges
    generator: ``torch.Generator`` — the draws on the CPU, the kernel seed on a GPU

    Returns
    -------
    (m, v, accepted, inline): updated fields, accepted proposals per chain (B,)
    out of 2·N² + 2N per sweep, and the inline ``ActionDensity``
    (1/2κ)Σ(m − δv/_W)²/Λ per chain (B,), taken after each sweep's wrapping pass
    and averaged over the sweeps.
    """
    winf = W == float('inf')
    interval_v = float(interval_v) if winf else int(interval_v)
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
    entry = lib.sv_worldline_sweeps_winf if winf else lib.sv_worldline_sweeps
    code = entry(m.data_ptr(), v.data_ptr(), m_out.data_ptr(), v_out.data_ptr(),
                 *(scratch[k].data_ptr() for k in ('v', 't', 'u', 'shifts', 'squares')),
                 accepted.data_ptr(), sums.data_ptr(), B, N, sweeps, float(0.5 / kappa),
                 float(inverse_w(W)), float(interval_v), int(interval_t), int(interval_w),
                 kernels.seed_from(generator), kernels.stream_handle(m.device))
    kernels.check(code, 'worldline_sweeps')
    worldline_sweeps.launches += 1
    inline = {'ActionDensity': ((0.5 / kappa) * sums / (N * N * sweeps)).float()}
    return m_out, v_out, accepted.float(), inline


#: Calls that launched the CUDA kernel (the CPU path never counts).
worldline_sweeps.launches = 0
