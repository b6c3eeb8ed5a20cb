"""The plain reference of the Worldline fleet: local-update sweeps and site worms.

A straightforward implementation of one Worldline record of the fused fleet,
D = 2 and even N, for any set of chains of the fleet.  A sweep is the dual
action's local updates, S = (1/2κ) Σ (m − δv/W)²: a vortex pass (Δv on the
plaquettes of each checkerboard color), a coexact pass (Δm = δt on the
plaquettes of each color) and a wrapping pass (a shift of m along whole torus
cycles), each accepted by Metropolis.  After the sweeps each chain runs its
worms, a walk of the m-defect from a random site that closes with probability
1/5 at its tail and tallies the ``Spin_Spin`` histogram.  The sweeps are
PyTorch operations over the chains; the worm is a scalar walk, one chain at a
time in Python, whose draws are made ahead in NumPy: a worm of a million moves
would cost a launch-bound tensor walk minutes.  The random numbers are the
program's kernels' own Philox stream (:mod:`.philox`), counted by each chain's
global index.  ``dtype`` is the float type of the residual and of every float
operation: float32 as the configuration states, bfloat16 for the control.
"""

from __future__ import annotations

import numpy as np
import torch

from . import philox

#: Passes whose draws are made in one Philox evaluation, at most, and the
#: draws' elements it may hold (each int64 word 8 bytes).
PASS_CHUNK = 60
DRAW_ELEMENTS = 2 ** 25
#: Worm moves drawn in one NumPy Philox evaluation.
MOVE_CHUNK = 1 << 16
CLOSE = 1 / 5


def mask(N, color, device):
    i = torch.arange(N, device=device)
    return ((i[:, None] + i[None, :]) % 2) == color


def delta2(v):
    """δv of a plaquette field (B, 1, N, N): (B, 2, N, N) with
    (δv)₀[t,x] = v[t,x] − v[t,x−1] and (δv)₁[t,x] = −(v[t,x] − v[t−1,x])."""
    p = v[:, 0]
    return torch.stack([p - torch.roll(p, 1, dims=-1), -(p - torch.roll(p, 1, dims=-2))], dim=1)


def coface_sum(f):
    """Per-link values (B, 2, N, N) summed onto each plaquette: ℓ₁[t,x] + ℓ₁[t+1,x]
    + ℓ₀[t,x] + ℓ₀[t,x+1]."""
    return ((f[:, 1] + torch.roll(f[:, 1], -1, dims=-2))
            + (f[:, 0] + torch.roll(f[:, 0], -1, dims=-1)))[:, None]


def inverse_w(W):
    return 1.0 / float(W)


def residual(m, v, W, dtype):
    return m.to(dtype) - delta2(v).to(dtype) * inverse_w(W)


def _link_terms(kappa, u, du):
    return (0.5 / kappa) * du * (2 * u + du)


def _nonzero(word, interval, idt):
    """±{1..i}: floor(u·2i) − i, shifted past 0."""
    r = torch.floor(philox.u24(word) * float(2 * interval)).to(idt) - interval
    return torch.where(r < 0, r, r + 1)


#: The passes of a sweep: every color's vortex pass, every color's coexact
#: pass, then a wrapping pass per direction.
PASSES = (('vortex', 0), ('vortex', 1), ('coexact', 0), ('coexact', 1),
          ('wrapping', 0), ('wrapping', 1))


def pass_draws(seed, chains, N, first, count, dtype, idt):
    """The draws of passes ``first`` .. ``first + count − 1`` of one sweep call
    keyed by ``seed``: Philox countered by (plaquette or cycle, chain, pass, 0).
    A list of (word0, uniform) pairs over plaquettes (B, N, N) and cycles (B, N)."""
    dev = chains.device
    key = philox.worldline_key(seed)
    passes = (first + torch.arange(count, device=dev)).reshape(1, count, 1, 1)
    w = philox.philox((torch.arange(N * N, device=dev).reshape(1, 1, N, N),
                       chains.reshape(-1, 1, 1, 1), passes, 0), key, dev)
    c = philox.philox((torch.arange(N, device=dev).reshape(1, 1, N),
                       chains.reshape(-1, 1, 1), passes[..., 0], 0), key, dev)
    out = []
    for p in range(count):
        if PASSES[(first + p) % 6][0] == 'wrapping':
            out.append((c[0][:, p], philox.u24(c[1][:, p]).to(dtype)))
        else:
            out.append((w[0][:, p], philox.u24(w[1][:, p]).to(dtype)))
    return out


def sweeps(m, v, seed, chains, *, kappa, W, sweeps, dtype, interval=1):
    """``sweeps`` worldline sweeps of one kernel call keyed by ``seed``.
    Returns (m, v, accepted, {'ActionDensity'})."""
    if W == float('inf'):
        raise ValueError('the reference sweeps finite W only')
    B, N = m.shape[0], m.shape[-1]
    idt = m.dtype
    u = residual(m, v, W, dtype)
    accepted = torch.zeros(B, dtype=dtype, device=m.device)
    sS = torch.zeros_like(accepted)
    draws = []
    for p in range(6 * sweeps):
        if not draws:
            count = max(1, min(PASS_CHUNK, 6 * sweeps - p, DRAW_ELEMENTS // (B * N * N)))
            draws = pass_draws(seed, chains, N, p, count, dtype, idt)
        word, uniform = draws.pop(0)
        kind, index = PASSES[p % 6]
        if kind == 'vortex':
            msk = mask(N, index, m.device)
            change = torch.where(msk, _nonzero(word, interval, idt), 0)[:, None]
            du = -(delta2(change).to(dtype) * inverse_w(W))
            dS = coface_sum(_link_terms(kappa, u, du))[:, 0]
            accept = (uniform < torch.clamp(torch.exp(-dS), max=1.0)) & msk
            applied = torch.where(accept, change[:, 0], 0)[:, None]
            v = v + applied
            u = u - delta2(applied).to(dtype) * inverse_w(W)
            accepted = accepted + accept.sum(dim=(-2, -1))
        elif kind == 'coexact':
            msk = mask(N, index, m.device)
            t = torch.where(msk, _nonzero(word, interval, idt), 0)[:, None]
            du = delta2(t).to(dtype)
            dS = coface_sum(_link_terms(kappa, u, du))[:, 0]
            accept = (uniform < torch.clamp(torch.exp(-dS), max=1.0)) & msk
            dm = delta2(torch.where(accept, t[:, 0], 0)[:, None])
            m, u = m + dm, u + dm.to(dtype)
            accepted = accepted + accept.sum(dim=(-2, -1))
        elif index == 0:
            wrapping = [(word, uniform)]
        else:
            # Both directions read the residual from before the pass.
            wrapping.append((word, uniform))
            shifts = []
            for mu, (w, un) in enumerate(wrapping):
                perp = (B, 1, N) if mu == 0 else (B, N, 1)
                change = _nonzero(w, interval, idt).reshape(perp)
                dS = _link_terms(kappa, u[:, mu], change.to(dtype)).sum(dim=1 + mu)
                accept = un < torch.clamp(torch.exp(-dS.reshape(B, -1)), max=1.0)
                shifts.append(torch.where(accept.reshape(perp), change, 0).expand(B, N, N))
                accepted = accepted + accept.sum(dim=-1)
            shift = torch.stack(shifts, dim=1)
            m, u = m + shift, u + shift.to(dtype)
            sS = sS + (0.5 / kappa) * torch.sum(u * u, dim=(1, 2, 3)) / (N * N)
    return m, v, accepted, {'ActionDensity': sS / sweeps}


class _Walk:
    """The scalar worm walk of one chain: the fields as Python lists, the draws
    made ahead in NumPy, and each ΔS's acceptance computed once in ``dtype``
    on the chain's device and remembered (a site worm's ΔS takes few values)."""

    def __init__(self, m, dvw, kappa, dtype, device):
        self.m = m                      # flat list: link (mu, t, x) at (mu·N + t)·N + x
        self.dvw = dvw
        self.kappa, self.dtype, self.device = kappa, dtype, device
        self.acceptance = {}

    def accept_probability(self, link_m, dvw, dm):
        key = (link_m, dvw, dm)
        p = self.acceptance.get(key)
        if p is None:
            t = torch.tensor([float(link_m)], dtype=self.dtype, device=self.device)
            link = t - torch.tensor([dvw], dtype=self.dtype, device=self.device)
            dmf = torch.tensor([float(dm)], dtype=self.dtype, device=self.device)
            dS = (0.5 / self.kappa) * dmf * (2 * link + dmf)
            p = float(torch.clamp(torch.exp(-dS), max=1.0)[0])
            self.acceptance[key] = p
        return p


def _move_draws(key, chain, worm, first, count, dtype):
    t = np.arange(first, first + count, dtype=np.uint64)
    w = philox.philox_np((chain, worm, t & np.uint64(philox.MASK),
                          np.uint64(2) * (t >> np.uint64(32)) + np.uint64(1)), key)
    u_close, u_accept = philox.u24_np(w[0]), philox.u24_np(w[2])
    if dtype != torch.float32:
        u_close = torch.tensor(u_close, dtype=torch.float32).to(dtype).double().numpy()
        u_accept = torch.tensor(u_accept, dtype=torch.float32).to(dtype).double().numpy()
    return u_close.tolist(), (w[1] & np.uint64(3)).astype(np.int64).tolist(), u_accept.tolist()


def worms(m, v, seed, chains, *, kappa, W, worms, max_worm_moves, dtype):
    """``worms`` worms a chain of one worm-kernel call keyed by ``seed``.  A
    worm still open at the cap is rolled back.  Returns (m, Spin_Spin,
    Worm_Length, Worm_Truncated)."""
    B, _, N, _ = m.shape
    key = philox.worldline_key(seed)
    close = float(torch.tensor(CLOSE, dtype=dtype))
    dvw_all = (delta2(v).to(dtype) * inverse_w(W)).double().cpu().numpy()
    m_all = m.cpu().numpy()
    hists = np.zeros((B, N, N), dtype=np.float64)
    truncated = np.zeros(B)
    m_out = m_all.copy()
    chain_ids = chains.cpu().tolist()
    for b in range(B):
        walk = _Walk(m_all[b].reshape(-1).tolist(), dvw_all[b].reshape(-1).tolist(), kappa,
                     dtype, m.device)
        hist = hists[b]
        for worm in range(worms):
            s = philox.philox_np((chain_ids[b], worm, 0, 2), key)
            orientation = 1 if int(s[0]) >> 31 == 1 else -1
            tail = ((int(s[1]) * N) >> 32, (int(s[2]) * N) >> 32)
            ht, hx = tail
            start = list(walk.m) if max_worm_moves is not None else None
            mm, dvw = walk.m, walk.dvw
            is_open, t = True, 0
            u_close = []
            while is_open and (max_worm_moves is None or t < max_worm_moves):
                if t % MOVE_CHUNK == 0:
                    count = MOVE_CHUNK if max_worm_moves is None else min(MOVE_CHUNK,
                                                                          max_worm_moves - t)
                    u_close, choice, u_accept = _move_draws(key, chain_ids[b], worm, t, count,
                                                            dtype)
                k = t % MOVE_CHUNK
                t += 1
                if ht == tail[0] and hx == tail[1] and u_close[k] < close:
                    is_open = False
                    continue
                c = choice[k]
                if c == 0:
                    nt, nx, mu, lt, lx = (ht + 1) % N, hx, 0, ht, hx
                elif c == 1:
                    nt, nx, mu, lt, lx = ht, (hx + 1) % N, 1, ht, hx
                elif c == 2:
                    nt, nx = (ht - 1) % N, hx
                    mu, lt, lx = 0, nt, nx
                else:
                    nt, nx = ht, (hx - 1) % N
                    mu, lt, lx = 1, nt, nx
                dm = orientation if c < 2 else -orientation
                at = (mu * N + lt) * N + lx
                if u_accept[k] < walk.accept_probability(mm[at], dvw[at], dm):
                    mm[at] += dm
                    ht, hx = nt, nx
                hist[(ht - tail[0]) % N, (hx - tail[1]) % N] += 1
            if is_open and max_worm_moves is not None:
                walk.m[:] = start
                truncated[b] += 1
        m_out[b] = np.asarray(walk.m, dtype=m_all.dtype).reshape(m_all.shape[1:])
    hist = torch.as_tensor(hists, dtype=torch.float32, device=m.device)
    return (torch.as_tensor(m_out, device=m.device), hist, hist.sum(dim=(1, 2)),
            torch.as_tensor(truncated, dtype=torch.float32, device=m.device))


def cold(B, N, device, dtype):
    """The fleet's cold start at finite W: m = 0 and v = 0."""
    return (torch.zeros((B, 2, N, N), dtype=torch.int32, device=device),
            torch.zeros((B, 1, N, N), dtype=torch.int32, device=device))


def record(state, seeds, chains, traffic, dtype):
    """One record of the fused fleet from ``state`` (m, v): the sweep call and
    the worm call, keyed by the next of ``seeds`` each."""
    m, v = state
    t = traffic
    m, v, _, inline = sweeps(m, v, next(seeds), chains, kappa=t['kappa'], W=t['W'],
                             sweeps=t['thin'], dtype=dtype)
    if t['worms'] > 0:
        m, hist, length, truncated = worms(m, v, next(seeds), chains, kappa=t['kappa'], W=t['W'],
                                           worms=t['worms'], max_worm_moves=t['max_worm_moves'],
                                           dtype=dtype)
        inline = inline | {'Spin_Spin': hist, 'Worm_Length': length, 'Worm_Truncated': truncated}
    return (m, v), inline


FIELDS = ('m', 'v')
