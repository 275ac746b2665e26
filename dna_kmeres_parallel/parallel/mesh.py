"""Device mesh construction.

The reference is single-GPU, single-process; its only "communication" is CUDA
unified-memory paging (SURVEY.md §2.5). Here parallelism is a
``jax.sharding.Mesh`` + shard_map with XLA collectives (NCCL over NVLink
between the cards of one host) — no hand-written transport. Every card
reaches every other at the same rate, so the mesh is flat.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


DATA_AXIS = "data"
BUCKET_AXIS = "bucket"


def make_mesh(
    n_devices: int | None = None, axis_names: tuple[str, ...] = (DATA_AXIS,)
) -> Mesh:
    """1-D (or reshaped N-D) mesh over the first n_devices devices."""
    devices = jax.devices()
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"requested {n} devices, have {len(devices)}")
    devs = np.asarray(devices[:n])
    if len(axis_names) == 1:
        return Mesh(devs, axis_names)
    # Factor n across the requested axes as evenly as possible (data-major).
    shape = _factor(n, len(axis_names))
    return Mesh(devs.reshape(shape), axis_names)


def _factor(n: int, ndims: int) -> tuple[int, ...]:
    """Greedy near-square factorization of n into ndims factors."""
    dims = [1] * ndims
    rem = n
    for i in range(ndims - 1):
        target = round(rem ** (1 / (ndims - i)))
        f = max(1, target)
        while rem % f:
            f -= 1
        dims[i] = f
        rem //= f
    dims[-1] = rem
    return tuple(dims)
