"""The benchmark's traffic generator: the block keys of every call, from
`--seed` and a workload file's parameters alone.

A call i of a cell covers `rounds` rounds of `blocks` coherence blocks,
the global block ids [i R B, (i + 1) R B), each folded under the cell's
SNR index of PRNGKey(seed): jax.random's key stream, which the program's
and the reference's draws both follow (the program's `e2e_keys` and
`detect_keys`). Every call gets fresh blocks; the same seed gives the same
keys. The keys are made on the device by the benchmark's own plain
threefry (reference/chain/utils/rng.py), not by the program.
"""
from __future__ import annotations

import torch

from .reference.chain.utils import rng


def call_keys(seed: int, snr_index: int, rounds: int, blocks: int, i: int,
              device) -> torch.Tensor:
    """Call i's keys, (rounds, blocks, 2) int64 on `device`."""
    n = rounds * blocks
    ids = torch.arange(i * n, (i + 1) * n, device=device)
    keys = rng.block_keys(rng.prng_key(seed, device), snr_index, ids)
    return keys.reshape(rounds, blocks, 2)
