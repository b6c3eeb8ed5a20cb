"""The plain reference of the general Worldline fleet: ``Hammer(S, fleet=True)`` on any D.

A straightforward PyTorch replay of one call of ``sample_fleet`` with the
Worldline Hammer for a fleet, on a torus of any dimension D and even side N
at finite W, for any sample of the fleet's chains, from the cold start (m = 0
on the links, v = 0 on the plaquettes).  S = (1/2κ) Σ_links (m − δv/W)², and
each Hammer step runs, in this order:

1. the vortex update: for each checkerboard color and each plaquette
   component (a, b), a < b, Δv = ±1 on the color's plaquettes of that
   component, the links changing by −δΔv/W, accepted by Metropolis on ΔS
   summed over the plaquette's four links from the residual u = m − δv/W,
   kept up to date through the passes;
2. the coexact update: likewise Δm = δt with t = ±1 on one color's plaquettes
   of one component, so that δΔm = 0;
3. the wrapping update: for each direction μ, Δm_μ = ±1 along every whole
   straight cycle in μ, one proposal a cycle, ΔS summed along it, every
   direction reading the residual from before the pass;
4. the site worm: from a random tail with a random orientation, the head
   moves to one of the 2D neighbouring sites (+e_k for choice k < D, −e_k
   for choice D + k), changing the crossed link by ±orientation under
   Metropolis; at the tail a move closes the worm with probability 1/(2D+1);
   every other move tallies (head − tail) mod N into ``Spin_Spin``.  A worm
   still open after the fleet's cap is rolled back.

A record is ``thin`` steps; its inline ``Spin_Spin`` and ``Worm_Length``
(the moves tallied) are their sums over the record's steps over ``thin``.

The fleet's worm cap is this configuration's rule, written here and not read
from the program: :func:`worm_cap`, 8 moves a site in D=2 and
``CAP_PER_SITE`` at D >= 3.  A program that caps lower rolls back worms that
the reference closes, and parts those chains.

Random numbers, as the program draws them: one ``torch.Generator`` on the
device, seeded with the call's fleet seed, draws every proposal and uniform
over the whole fleet (the chains its leading axis), pass by pass in the order
above (a pass's proposals, then its uniforms), and the replay keeps the rows
of its sampled chains; each worm call takes a 63-bit kernel seed drawn from
it after the wrapping draws, and its moves come from Philox-4x32-10
(:mod:`.philox`) keyed by that seed ⊕ ``WORLDLINE_SALT`` and countered by
(the chain's index in the fleet, worm 0, move, odd) for a move and (chain,
0, j, 2) for the start.  ``dtype`` is the float type of the residual and of
every float operation: float32 as the configuration states, bfloat16 for the
control; the uniforms are drawn in float32 either way, so that the control
draws what the program draws.  The worm is a scalar walk, one chain at a time
in Python, with its draws made ahead in NumPy and each ΔS's acceptance
computed once in ``dtype`` on the device and remembered.

Departures from upstream (``supervillain/generator/worldline/`` of
evanberkowitz/supervillain v1.0.0):

- upstream draws from a NumPy ``default_rng`` a generator, in float64; here
  the fleet's one generator draws in the program's order, in float32, and the
  worm draws from the kernels' Philox stream;
- upstream runs one configuration; here each chain of the fleet proposes and
  accepts on its own;
- upstream's worm is unbounded; the fleet's is capped, and a capped worm is
  rolled back whole (its tallies kept).
"""

from __future__ import annotations

import numpy as np
import torch

from . import philox

INTERVAL = 1            # Δv, t and the wrapping shift are ±1
#: The fleet's worm cap at D >= 3, in moves a site (8 in D=2).
CAP_PER_SITE = 64
#: Worm moves drawn in one NumPy Philox evaluation.
MOVE_CHUNK = 1 << 16
FIELDS = ('m', 'v')


def components(D):
    """The plaquette components (a, b), a < b, in lexicographic order."""
    return [(a, b) for a in range(D) for b in range(a + 1, D)]


def worm_cap(D, N):
    """The configuration's worm cap of the fleet on N^D sites."""
    return (8 if D == 2 else CAP_PER_SITE) * N ** D


def roll(x, shift, axis, D):
    """``x`` (B, N, ..., N) or (B, C, N, ..., N) rolled along spatial axis ``axis``."""
    return torch.roll(x, shift, dims=axis - D)


def codifferential(v, D):
    """δv of a 2-form (B, C(D,2), N, ..., N), components (a, b) with a < b in
    lexicographic order, as a 1-form (B, D, N, ..., N):
    (δv)_μ[x] = Σ_{e≠μ} ± (v_{μe}[x] − v_{μe}[x − e_e]), + where μ < e."""
    comps = components(D)
    out = []
    for mu in range(D):
        total = 0
        for e in range(D):
            if e == mu:
                continue
            f = v[:, comps.index((min(mu, e), max(mu, e)))]
            diff = f - roll(f, 1, e, D)
            total = total + (diff if mu < e else -diff)
        out.append(total)
    return torch.stack(out, dim=1)


def plaquette_sum(terms, a, b, D):
    """Per-link values (B, D, N, ..., N) summed onto plaquettes of component
    (a, b): ℓ_b[x] + ℓ_b[x + e_a] + ℓ_a[x] + ℓ_a[x + e_b], in that grouping."""
    fb, fa = terms[:, b], terms[:, a]
    return (fb + roll(fb, -1, a, D)) + (fa + roll(fa, -1, b, D))


def on_component(values, comp, C):
    """A 2-form (B, C, N, ..., N) holding ``values`` on component ``comp``."""
    return torch.stack([values if k == comp else torch.zeros_like(values) for k in range(C)],
                       dim=1)


def link_terms(kappa, u, du):
    return (0.5 / kappa) * du * (2 * u + du)


def accept(uniform, dS):
    return uniform < torch.clamp(torch.exp(-dS), max=1.0)


def residual(m, v, W, dtype):
    return m.to(dtype) - codifferential(v, m.dim() - 2).to(dtype) * (1.0 / float(W))


def colors(N, D, device):
    """The two checkerboard colors of an even torus, by the parity of x's sum."""
    grid = torch.stack(torch.meshgrid(*[torch.arange(N, device=device)] * D, indexing='ij'))
    parity = grid.sum(dim=0) % 2
    return [parity == c for c in (0, 1)]


class FleetDraws:
    """The draws of a fleet of ``chains`` chains on one generator seeded with
    ``seed`` on ``device``, each made over the whole fleet; ``rows`` are the
    sampled chains whose draws are kept."""

    def __init__(self, seed, chains, rows, device):
        self.generator = torch.Generator(device=device).manual_seed(int(seed))
        self.chains, self.rows, self.device = chains, rows, device

    def nonzero(self, shape):
        """Uniform over ±{1..INTERVAL}, int32."""
        r = torch.randint(0, 2 * INTERVAL, (self.chains,) + shape, generator=self.generator,
                          dtype=torch.int32, device=self.device)[self.rows]
        return torch.where(r < INTERVAL, r - INTERVAL, r - INTERVAL + 1)

    def uniform(self, shape, dtype):
        u = torch.rand((self.chains,) + shape, generator=self.generator, dtype=torch.float32,
                       device=self.device)
        return u[self.rows].to(dtype)

    def kernel_seed(self):
        return int(torch.randint(0, 2 ** 63 - 1, (), generator=self.generator,
                                 device=self.device))


def plaquette_update(kind, m, v, draws, masks, kappa, W, dtype):
    """Every color's and component's pass of the vortex (Δv) or the coexact
    (Δm = δt) update."""
    D = m.dim() - 2
    comps = components(D)
    sites = tuple(m.shape[2:])
    u = residual(m, v, W, dtype)
    for mask in masks:
        for comp, (a, b) in enumerate(comps):
            change = torch.where(mask, draws.nonzero(sites), 0)
            uniform = draws.uniform(sites, dtype)
            delta = codifferential(on_component(change, comp, len(comps)), D).to(dtype)
            du = -(delta * (1.0 / float(W))) if kind == 'vortex' else delta
            dS = plaquette_sum(link_terms(kappa, u, du), a, b, D)
            ok = accept(uniform, dS) & mask
            applied = on_component(torch.where(ok, change, 0), comp, len(comps))
            if kind == 'vortex':
                v = v + applied
                u = u - codifferential(applied, D).to(dtype) * (1.0 / float(W))
            else:
                dm = codifferential(applied, D)
                m, u = m + dm, u + dm.to(dtype)
    return m, v


def wrapping_update(m, v, draws, kappa, W, dtype):
    B, D, N = m.shape[0], m.dim() - 2, m.shape[-1]
    u = residual(m, v, W, dtype)
    shifts = []
    for mu in range(D):
        cycles = (N ** (D - 1),)
        change = draws.nonzero(cycles)
        uniform = draws.uniform(cycles, dtype)
        perp = (B,) + tuple(1 if i == mu else N for i in range(D))
        dS = link_terms(kappa, u[:, mu], change.reshape(perp).to(dtype)).sum(dim=1 + mu)
        ok = accept(uniform, dS.reshape(B, -1))
        shifts.append(torch.where(ok, change, 0).reshape(perp).expand((B,) + (N,) * D))
    return m + torch.stack(shifts, dim=1)


class Walk:
    """The scalar worm walk of one chain: m as a flat Python list (link (μ, x)
    at μ·N^D + x, x the site's flat index, axis 0 most significant), δv/W
    beside it, and each ΔS's acceptance computed once in ``dtype`` on the
    device and remembered (a site worm's ΔS takes few values)."""

    def __init__(self, m, dvw, kappa, dtype, device):
        self.m, self.dvw = m, dvw
        self.kappa, self.dtype, self.device = kappa, dtype, device
        self.acceptance = {}

    def accept_probability(self, link_m, dvw, dm):
        key = (link_m, dvw, dm)
        p = self.acceptance.get(key)
        if p is None:
            link = (torch.tensor([float(link_m)], dtype=self.dtype, device=self.device)
                    - torch.tensor([dvw], dtype=self.dtype, device=self.device))
            dmf = torch.tensor([float(dm)], dtype=self.dtype, device=self.device)
            dS = (0.5 / self.kappa) * dmf * (2 * link + dmf)
            p = float(torch.clamp(torch.exp(-dS), max=1.0)[0])
            self.acceptance[key] = p
        return p


def neighbours(N, D):
    """Per axis k, the flat index one step forward and one step back of every site."""
    site = np.arange(N ** D).reshape((N,) * D)
    return ([np.roll(site, -1, axis=k).reshape(-1).tolist() for k in range(D)],
            [np.roll(site, 1, axis=k).reshape(-1).tolist() for k in range(D)])


def as_dtype(values, dtype):
    """Exact float32 uniforms as Python floats, rounded to ``dtype`` where it is narrower."""
    if dtype != torch.float32:
        values = torch.tensor(values, dtype=torch.float32).to(dtype).double().numpy()
    return values.tolist()


def move_draws(key, chain, first, count, D, dtype):
    t = np.arange(first, first + count, dtype=np.uint64)
    w = philox.philox_np((chain, 0, t & np.uint64(philox.MASK),
                          np.uint64(2) * (t >> np.uint64(32)) + np.uint64(1)), key)
    return (as_dtype(philox.u24_np(w[0]), dtype),
            (w[1] % np.uint64(2 * D)).astype(np.int64).tolist(),
            as_dtype(philox.u24_np(w[2]), dtype))


def start_draws(key, chain, N, D):
    """(orientation, tail as a flat site) of worm 0 of a call."""
    s = philox.philox_np((chain, 0, 0, 2), key)
    words = [int(w) for w in s[1:]]
    for j in range(1, 1 + max(0, -(-(D - 3) // 4))):
        words += [int(w) for w in philox.philox_np((chain, 0, j, 2), key)]
    tail = 0
    for word in words[:D]:
        tail = tail * N + ((word * N) >> 32)
    return (1 if int(s[0]) >> 31 == 1 else -1), tail


def worms(m, v, seed, chains, *, kappa, W, cap, dtype):
    """One worm a chain of one worm call keyed by ``seed``.  Returns (m,
    Spin_Spin, Worm_Length) of the chains."""
    B, D, N = m.shape[0], m.dim() - 2, m.shape[-1]
    V = N ** D
    key = philox.worldline_key(seed)
    close = float(torch.tensor(1 / (2 * D + 1), dtype=dtype))
    forward, backward = neighbours(N, D)
    dvw_all = (codifferential(v, D).to(dtype) * (1.0 / float(W))).double().cpu().numpy()
    m_all = m.cpu().numpy()
    m_out = m_all.copy()
    hists = np.zeros((B, V), dtype=np.float64)
    chain_ids = chains.cpu().tolist()
    for b in range(B):
        walk = Walk(m_all[b].reshape(-1).tolist(), dvw_all[b].reshape(-1).tolist(), kappa,
                    dtype, m.device)
        mm, dvw, hist = walk.m, walk.dvw, hists[b]
        orientation, tail = start_draws(key, chain_ids[b], N, D)
        start = list(mm)
        head, disp, is_open, t = tail, 0, True, 0
        while is_open and t < cap:
            if t % MOVE_CHUNK == 0:
                u_close, choice, u_accept = move_draws(key, chain_ids[b], t,
                                                       min(MOVE_CHUNK, cap - t), D, dtype)
            k = t % MOVE_CHUNK
            t += 1
            if disp == 0 and u_close[k] < close:
                is_open = False
                continue
            c = choice[k]
            if c < D:
                nxt, at, dm, step = forward[c][head], c * V + head, orientation, forward[c]
            else:
                axis = c - D
                nxt = backward[axis][head]
                at, dm, step = axis * V + nxt, -orientation, backward[axis]
            if u_accept[k] < walk.accept_probability(mm[at], dvw[at], dm):
                mm[at] += dm
                head, disp = nxt, step[disp]
            hist[disp] += 1
        if is_open:
            mm[:] = start
        m_out[b] = np.asarray(mm, dtype=m_all.dtype).reshape(m_all.shape[1:])
    hist = torch.as_tensor(hists, dtype=torch.float32, device=m.device).reshape((B,) + (N,) * D)
    return (torch.as_tensor(m_out, device=m.device), hist,
            hist.sum(dim=tuple(range(1, D + 1))))


def replay(seed, chains, traffic, device, dtype):
    """The columns (records, chains, ...) and final fields (chains, ...) of the
    fleet's chains ``chains`` in the call with fleet seed ``seed``, as NumPy
    arrays (float columns as float32)."""
    t = traffic
    D, N, W, kappa = t['D'], t['L'], t['W'], t['kappa']
    if W == float('inf') or N % 2:
        raise ValueError('the reference replays the Worldline Hammer at finite W and even N only')
    index = torch.tensor(chains, dtype=torch.int64, device=device)
    draws = FleetDraws(seed, t['chains'], index, device)
    masks = colors(N, D, device)
    B = len(chains)
    m = torch.zeros((B, D) + (N,) * D, dtype=torch.int32, device=device)
    v = torch.zeros((B, D * (D - 1) // 2) + (N,) * D, dtype=torch.int32, device=device)
    cap = worm_cap(D, N)
    columns = {'Spin_Spin': [], 'Worm_Length': []}
    for _ in range(t['records_per_call']):
        hist = length = 0
        for _ in range(t['thin']):
            m, v = plaquette_update('vortex', m, v, draws, masks, kappa, W, dtype)
            m, v = plaquette_update('coexact', m, v, draws, masks, kappa, W, dtype)
            m = wrapping_update(m, v, draws, kappa, W, dtype)
            m, h, moves = worms(m, v, draws.kernel_seed(), index, kappa=kappa, W=W, cap=cap,
                                dtype=dtype)
            hist, length = hist + h, length + moves
        columns['Spin_Spin'].append((hist / t['thin']).cpu().numpy())
        columns['Worm_Length'].append((length / t['thin']).cpu().numpy())
    final = {'m': m.cpu().numpy(), 'v': v.cpu().numpy()}
    return {k: np.stack(v) for k, v in columns.items()}, final
