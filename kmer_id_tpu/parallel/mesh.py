"""Device-mesh construction for multi-chip/multi-host runs.

Axes (scaling-book style — annotate shardings, let XLA place collectives):

* ``data`` — read batches shard across this axis (pure data parallelism;
  the per-read pipeline is embarrassingly parallel, SURVEY.md §2.4);
* ``db``   — the sorted probe-key array shards by contiguous key range
  across this axis (the "tensor-parallel" analog for the lookup table:
  a 25 GiB-class DB stops fitting one chip's HBM, so each chip owns a
  range and queries combine with a psum — exact, because every key lives
  on exactly one shard).

On one host both axes ride NVLink (every card reaches every other at the
same rate); across hosts put ``data`` outermost so the slower inter-host
network only carries per-sample count merges.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def make_mesh(data: int = 0, db: int = 1, devices=None) -> Mesh:
    """Build a (data, db) mesh; data=0 means "use all remaining devices"."""
    devices = list(devices if devices is not None else jax.devices())
    if db < 1:
        raise ValueError("db axis must be >= 1")
    if data <= 0:
        data = len(devices) // db
    need = data * db
    if need > len(devices):
        raise ValueError(f"mesh {data}x{db} needs {need} devices, have {len(devices)}")
    arr = np.array(devices[:need]).reshape(data, db)
    return Mesh(arr, ("data", "db"))
