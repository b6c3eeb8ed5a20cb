"""``python -m supervillain_tpu_torch`` prints a banner with version and capabilities."""

from . import meta

BANNER = f'''
supervillain-tpu-torch {meta.version} ({meta.nickname})
Lattice Monte Carlo for the Villain model of the compact boson, in PyTorch and CUDA
on one NVIDIA GPU: Villain (φ, n) and Worldline (m, v) dual formulations with a
Z_W vortex constraint; hand-written CUDA kernels for the fused sweeps and worms,
plain PyTorch versions of each on the CPU.  The port of supervillain_tpu.
'''

if __name__ == '__main__':
    # Route argv through the metadata parser so that `--version`, `--copyright`
    # and `--license` print and exit before the banner.
    from . import cli
    cli.ArgumentParser(description=__doc__).parse_args()
    print(BANNER)
