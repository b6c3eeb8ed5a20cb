"""Fused Villain neighborhood sweeps: the CUDA kernel and its plain PyTorch twin.

Counterpart of :func:`supervillain_tpu.ops.pallas_sweep.neighborhood_sweeps`.
:func:`neighborhood_sweeps` dispatches by device: a CPU batch runs
:func:`plain_sweeps` with draws from a ``torch.Generator``, a CUDA batch runs
the kernel of ``csrc/sweep.cu`` (seeded from the same generator), and any
other device raises.

The plain version is the same transition kernel as
:class:`supervillain_tpu.generators.villain.NeighborhoodUpdate` (and, at
``W = inf``, ``ExactNeighborhoodUpdate``), batched over chains and vectorised
over sites, with the random draws of each color pass as an input: from a
``torch.Generator`` (:class:`SweepDraws`), the JAX package's own (tests), or the
kernel's own Philox stream (:class:`KernelSweepDraws`), which makes it replay a
kernel call.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import calculus as calc
from . import kernels, philox
from .lattice import Lattice2D
from ..generators.base import metropolis, uniform_int_with_zero, zero_inflated_int

TWO_PI = 2 * np.pi


@lru_cache(maxsize=None)
def lattice(N: int) -> Lattice2D:
    return Lattice2D(N)


class SweepDraws:
    """Draws of one color pass from a ``torch.Generator`` on the fields' device:
    ``{'phi', 'fwd', 'bwd', 'u'}`` or, in z-mode, ``{'phi', 'z', 'u'}``.

    ``phi`` is the Δφ proposal in ±interval_phi, ``fwd``/``bwd`` the integer
    Δn/W draws on each site's forward links and on the backward links indexed
    by link position, ``z`` the Δz draw, ``u`` the Metropolis uniforms."""

    def __init__(self, generator, *, B, N, interval_phi, interval_n, p_n, zmode,
                 fdt, idt, device):
        self.generator = generator
        self.B, self.N = B, N
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
        site = (self.B, self.N, self.N)
        link = (self.B, 2, self.N, self.N)
        out = {'phi': (2 * torch.rand(site, generator=g, dtype=fdt, device=dev) - 1)
               * self.interval_phi}
        if self.zmode:
            out['z'] = self._ints(site)
        else:
            out['fwd'] = self._ints(link)
            out['bwd'] = self._ints(link)
        out['u'] = torch.rand(site, generator=g, dtype=fdt, device=dev)
        return out


class KernelSweepDraws:
    """The draws of one CUDA sweep-kernel call seeded with ``seed``, as a draw
    source of :func:`plain_sweeps`: Philox-4x32-10 keyed by the seed and
    countered by (site, chain, color pass, k), with the kernel's float32
    conversions (``csrc/sweep.cu``).  Fed these, the plain version repeats the
    kernel call; they can differ only where float rounding of ΔS flips a
    Metropolis decision.  Draws are made for every site; a pass uses its
    color's."""

    def __init__(self, seed, *, B, N, interval_phi, interval_n, p_n, zmode, fdt, idt, device):
        self.key = philox.key_of(seed)
        self.interval_phi, self.interval_n, self.p_n = interval_phi, interval_n, p_n
        self.zmode = zmode
        self.fdt, self.idt, self.device = fdt, idt, device
        self.site = torch.arange(N * N, device=device).reshape(1, N, N)
        self.chain = torch.arange(B, device=device).reshape(B, 1, 1)
        self.passes = 0

    def _int(self, a, b):
        """``draw_int`` of the kernel: uniform in {-i..i}, or zero-inflated."""
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


def color_pass(phi, n, r, color, draws, *, kappa, W):
    """One checkerboard color pass on a chain batch.

    ``phi`` (B, 1, N, N), ``n`` and the residual ``r = dφ - 2πn`` (B, 2, N, N),
    ``draws`` as produced by :class:`SweepDraws`.  ``W = inf`` selects z-mode.
    Returns the updated ``(phi, n, r)`` and the accepted count per chain."""
    L = lattice(phi.shape[-1])
    fdt = phi.dtype
    mask = L.mask(color, phi.device)
    change_phi = torch.where(mask, draws['phi'], 0)[:, None]

    if W == float('inf'):
        change_z = torch.where(mask, draws['z'], 0)[:, None]
        change_n = calc.d(L, 0, change_z)
    else:
        fwd = W * draws['fwd']
        bwd = W * draws['bwd']
        change_n_fwd = torch.stack(
            [torch.where(mask, fwd[:, mu], 0) for mu in range(2)], dim=1)
        change_n_bwd = torch.stack(
            [torch.where(torch.roll(mask, -1, dims=mu - 2), bwd[:, mu], 0) for mu in range(2)],
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
             + torch.where(torch.roll(accept, -1, dims=mu - 2), change_n_bwd[:, mu], 0)
             for mu in range(2)], dim=1)

    phi = phi + applied_phi
    n = n + applied_n
    r = r + calc.d(L, 0, applied_phi) - TWO_PI * applied_n.to(fdt)
    return phi, n, r, accept.sum(dim=(-2, -1)).to(fdt)


def plain_sweeps(phi, n, *, kappa, W, sweeps, draws):
    """``sweeps`` neighborhood sweeps in plain PyTorch, on any device.

    ``draws(color)`` supplies each color pass's draws, in order.  Returns
    ``(phi, n, accepted, inline)`` like :func:`neighborhood_sweeps`."""
    L = lattice(phi.shape[-1])
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
        sS = sS + (kappa / 2) * torch.sum(r * r, dim=(1, 2, 3)) / L.sites
        dn = calc.d(L, 1, n).to(fdt)
        sw2 = sw2 + torch.sum(dn * dn, dim=(1, 2, 3)) / L.sites
    return phi, n, accepted, {'ActionDensity': sS / sweeps, 'WindingSquared': sw2 / sweeps}


def neighborhood_sweeps(phi, n, *, kappa, W, interval_phi, interval_n, sweeps,
                        p_n=None, generator):
    """Run ``sweeps`` fused neighborhood sweeps on a chain batch.

    Parameters
    ----------
    phi: (B, 1, N, N) float; n: (B, 2, N, N) int
    W: int or ``float('inf')`` (z-mode: Δn = d(Δz), dn preserved exactly)
    generator: ``torch.Generator`` — the draws on the CPU, the kernel seed on a GPU

    Returns
    -------
    (phi, n, accepted, inline): updated fields, accepted site updates per chain
    (B,), and the inline ``ActionDensity`` and ``WindingSquared`` per chain
    (B,), each averaged over the call's sweeps.
    """
    if phi.device.type == 'cpu':
        B, N = phi.shape[0], phi.shape[-1]
        draws = SweepDraws(generator, B=B, N=N, interval_phi=interval_phi,
                           interval_n=interval_n, p_n=p_n, zmode=W == float('inf'),
                           fdt=phi.dtype, idt=n.dtype, device=phi.device)
        return plain_sweeps(phi, n, kappa=kappa, W=W, sweeps=sweeps, draws=draws)
    if phi.device.type != 'cuda':
        raise ValueError(f'neighborhood_sweeps runs on the CPU or a CUDA device, not {phi.device}')

    B, N = kernels.require_fields(phi, n)
    sweeps = int(sweeps)
    if sweeps < 1:
        raise ValueError(f'sweeps must be >= 1, got {sweeps}')
    lib = kernels.library()
    phi_out = torch.empty_like(phi)
    n_out = torch.empty_like(n)
    r = torch.empty(n.shape, dtype=torch.float32, device=phi.device)
    accepted = torch.empty(B, dtype=torch.int32, device=phi.device)
    sums = torch.empty((B, 2), dtype=torch.float64, device=phi.device)
    code = lib.sv_sweeps(
        phi.data_ptr(), n.data_ptr(), phi_out.data_ptr(), n_out.data_ptr(), r.data_ptr(),
        accepted.data_ptr(), sums.data_ptr(), B, N, sweeps, float(kappa),
        0 if W == float('inf') else int(W), float(interval_phi), int(interval_n),
        -1.0 if p_n is None else float(p_n), kernels.seed_from(generator),
        kernels.stream_handle(phi.device))
    kernels.check(code, 'neighborhood_sweeps')
    neighborhood_sweeps.launches += 1
    per_site = sums / (N * N * sweeps)
    inline = {'ActionDensity': ((kappa / 2) * per_site[:, 0]).float(),
              'WindingSquared': per_site[:, 1].float()}
    return phi_out, n_out, accepted.float(), inline


#: Calls that launched the CUDA kernel (the CPU path never counts).
neighborhood_sweeps.launches = 0
