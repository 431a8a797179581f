"""Device-mesh construction for multi-device serving.

The reference is single-process/single-device (SURVEY.md §2 parallelism
inventory). Here scale-out is a ``jax.sharding.Mesh`` with named axes:

- ``dp``  data parallel: independent utterances (batched serving)
- ``tp``  tensor parallel: attention heads / FFN intermediate / vocab shards,
          with the all-reduces GSPMD inserts

At 0.6B one card is compute-rich; dp is the throughput axis and tp the
latency axis. Both compose: mesh ("dp", "tp"). The cards of one host are
joined all to all, so the mesh takes ``jax.devices()`` in order.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(dp: int = 1, tp: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    if dp * tp > len(devices):
        raise ValueError(f"mesh {dp}x{tp} needs {dp * tp} devices, have {len(devices)}")
    grid = np.array(devices[: dp * tp]).reshape(dp, tp)
    return Mesh(grid, ("dp", "tp"))


def single_device_mesh() -> Mesh:
    return make_mesh(1, 1)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def spans_devices(*trees) -> bool:
    """True when any concrete array leaf is placed on more than one device
    (sharded or replicated over a mesh). Tracers and host arrays carry no
    placement and count as local."""
    for x in jax.tree.leaves(trees):
        if isinstance(x, jax.core.Tracer):
            continue
        s = getattr(x, "sharding", None)
        if s is not None and len(s.device_set) > 1:
            return True
    return False
