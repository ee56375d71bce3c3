"""Device-mesh helpers.

The device replacement for the reference's ThreadPool-based parallelism
(``ortools/base/threadpool.h:26``, ``ortools/pdlp/sharder.h``): solvers
partition work over a named ``jax.sharding.Mesh`` axis and combine partial
results with XLA collectives (NCCL between GPUs; SURVEY §2.15 table).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("shards",),
    devices: Optional[Sequence[jax.Device]] = None,
) -> jax.sharding.Mesh:
    """Build a mesh over the available devices.

    Default: a 1-D mesh named "shards" over all devices (the PDLP block
    sharding axis).  Multi-axis shapes (e.g. (rows, cols, batch)) are for
    the 2-D SpMV and scenario-batch layouts.
    """
    devices = list(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (len(devices),)
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh shape {shape} needs {n} devices, have {len(devices)}")
    arr = np.asarray(devices[:n]).reshape(shape)
    return jax.sharding.Mesh(arr, tuple(axis_names[: len(shape)]))
