"""intersection-v0 in the reference's decision order against the JAX package, on the CPU.

The case of tests/test_torch_sequential.py at intersection-v0 (no spawns),
in a file of its own because the JAX package's sequential step compiles
for about a minute on the CPU: the regulated road's frames, the reset's
45-frame warm-up on the plain sequential frames, three policy steps of
``step_batched`` from a port reset batch of 4 against the JAX package's
``step_batched``, each from the JAX state of the step before; discrete
fields exact, pos within 2e-4 m, other state within 1e-4 of its magnitude,
reward within 1e-5, and no kernel launched.
"""

import torch

from tests.test_torch_sequential import held_to_jax

torch.set_num_threads(1)


def test_sequential_intersection_steps_match_jax():
    held_to_jax("intersection-v0")
