"""Seed derivation for the port's explicit random streams.

The JAX package derives every key with ``jax.random.fold_in``; torch has
no counterpart and cannot reproduce JAX's bits. The port derives integer
seeds instead: :func:`derive_seed` hashes a tuple of integers to a 63-bit
seed, and :func:`generator` seeds a ``torch.Generator`` on a device with
it. The same tuple gives the same stream on every run, which is what a
sample-exact resume and a gradient-checkpoint recompute need.
"""

from __future__ import annotations

import hashlib

import torch


def derive_seed(*parts: int) -> int:
    """A 63-bit seed from integers, stable across runs and platforms."""
    h = hashlib.blake2b(digest_size=8)
    for p in parts:
        h.update(int(p).to_bytes(16, "little", signed=True))
    return int.from_bytes(h.digest(), "little") >> 1


def generator(seed: int, device: torch.device | str) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    return torch.Generator(device=device).manual_seed(seed)
