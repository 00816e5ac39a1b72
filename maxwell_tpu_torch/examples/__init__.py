"""Runnable examples of the port, one module each (the ports of examples/,
which import the JAX package and stay as they are):

    python -m maxwell_tpu_torch.examples.cavity_modes [--device cpu]
    python -m maxwell_tpu_torch.examples.dielectric_cavity
    python -m maxwell_tpu_torch.examples.matrix_free_interior_modes
    python -m maxwell_tpu_torch.examples.distributed_solve

Each runs on the card unless --device cpu is given; its `main(device=...,
**sizes)` returns what it prints.
"""
