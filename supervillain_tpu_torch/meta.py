"""Package metadata.  ``version`` equals the JAX package's, so HDF5 payloads
written by either package pass the other's strict version check."""

version = '0.3.0'
nickname = 'butte'

author = 'supervillain-tpu developers'
description = (
    'PyTorch and CUDA port of supervillain_tpu: lattice Monte Carlo for the Villain '
    'model of the compact boson, in the Villain and Worldline dual formulations with '
    'a Z_W vortex constraint, on one NVIDIA GPU.'
)
