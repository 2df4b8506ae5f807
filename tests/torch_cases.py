"""Shared instances and fixtures of the ``test_torch_*`` files.

The instances are the shapes of ``tests/test_fused.py`` (random, degree-zero
nodes, a skewed hub), made with numpy from a seed so that the JAX package
and the PyTorch port get the same inputs.
"""

import numpy as np
import pytest
import torch

#: the device of every CPU test: the port's entry points default to "cuda"
CPU = torch.device("cpu")


def random_kkt(rng, m=700, p=300):
    u = rng.integers(0, p, m).astype(np.int32)
    v = ((u + 1 + rng.integers(0, p - 1, m)) % p).astype(np.int32)
    d = rng.uniform(1.0, 3.0, m).astype(np.float32)
    return d, u, v, p


def degree_zero_kkt(rng, m=50, p=40):
    u = rng.integers(0, 10, m).astype(np.int32)  # only nodes 0..9 as tails
    v = ((u + 1 + rng.integers(0, p - 1, m)) % p).astype(np.int32)
    d = rng.uniform(1.0, 2.0, m).astype(np.float32)
    return d, u, v, p


def hub_kkt(rng, m=900, p=150):
    u = np.where(rng.random(m) < 0.6, 0, rng.integers(0, p, m)).astype(np.int32)
    v = ((u + 1 + rng.integers(0, p - 1, m)) % p).astype(np.int32)
    d = rng.uniform(0.5, 4.0, m).astype(np.float32)
    return d, u, v, p


CASES = {"random": random_kkt, "degree_zero": degree_zero_kkt, "hub": hub_kkt}


def breakdown_kkt():
    """All arcs share their endpoints, so the Krylov space of b = e_1 is
    tiny and pass one breaks down after a few steps: (d, u, v, p, b)."""
    m, p = 130, 130
    b = np.zeros(m + p, np.float32)
    b[0] = 1.0
    return (np.full(m, 2.0, np.float32), np.zeros(m, np.int32),
            np.ones(m, np.int32), p, b)


@pytest.fixture
def cuda_device():
    """A CUDA device, or a skip: the kernels in ``csrc/`` run only on a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")
