"""Shared fixtures of the benchmark's CPU tests."""

import pytest
import torch


@pytest.fixture
def card_on_cpu(monkeypatch):
    """The program's fleet on the CPU as it runs on the card: float32 and
    int32 fields, and every sweep drawing the kernels' Philox stream (the
    worms already do on the CPU), so that the plain versions stand in for the
    kernels and the reference can judge them."""
    from supervillain_tpu_torch.ops import kernels, shard, sweep, worldline
    from supervillain_tpu_torch.parallel import fused_fleet

    monkeypatch.setattr(fused_fleet, 'field_dtypes', lambda device: (torch.float32, torch.int32))

    def sweep_draws(generator, *, B, N, interval_phi, interval_n, p_n, zmode, fdt, idt, device,
                    D=2):
        return sweep.KernelSweepDraws(kernels.seed_from(generator), B=B, N=N,
                                      interval_phi=interval_phi, interval_n=interval_n, p_n=p_n,
                                      zmode=zmode, fdt=fdt, idt=idt, device=device,
                                      chain0=shard.chain0_of(generator))

    def worldline_draws(generator, *, B, N, interval_v, interval_t, interval_w, winf, fdt, idt,
                        device, D=2):
        return worldline.KernelWorldlineSweepDraws(
            kernels.seed_from(generator), B=B, N=N, interval_v=interval_v,
            interval_t=interval_t, interval_w=interval_w, winf=winf, fdt=fdt, idt=idt,
            device=device, chain0=shard.chain0_of(generator))

    monkeypatch.setattr(sweep, 'SweepDraws', sweep_draws)
    monkeypatch.setattr(worldline, 'WorldlineSweepDraws', worldline_draws)


#: Tiny shapes of each cell for the CPU: the cell's traffic at a size a test holds.
TINY = {
    'villain-l256-w1': dict(L=8, chains=6, thin=3, records_per_call=4, check_chains=4),
    'worldline-l256-w2': dict(L=8, chains=6, thin=3, records_per_call=4, check_chains=4),
    'villain-l1024-w2': dict(L=8, chains=6, thin=3, records_per_call=4, check_chains=4),
    'villain-pod-l64-4card': dict(L=8, chains=16, thin=3, records_per_call=4, check_chains=8,
                                  shards=4),
}
