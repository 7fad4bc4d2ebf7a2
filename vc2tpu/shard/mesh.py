"""Device mesh construction for vc2tpu.

Two mesh axes (SURVEY.md §2 parallelism table):

* ``data``  — frame parallelism (intra-only codec: frames are independent);
  spans hosts when there are several.
* ``space`` — row-band parallelism within one picture; the separable DWT
  exchanges boundary rows per lifting pass between neighbouring devices
  (vc2tpu.shard.halo).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(data: int = 1, space: int | None = None, devices=None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    if space is None:
        space = len(devices) // data
    if space < 1 or data * space > len(devices):
        raise ValueError(f"mesh {data}x{space} needs more than "
                         f"{len(devices)} devices")
    devices = devices[: data * space]
    return Mesh(np.array(devices).reshape(data, space), ("data", "space"))


def frame_sharding(mesh: Mesh) -> NamedSharding:
    """(B, H, W) planes: frames over data, row bands over space."""
    return NamedSharding(mesh, P("data", "space", None))


def picture_sharding(mesh: Mesh) -> NamedSharding:
    """(H, W) single picture: row bands over space."""
    return NamedSharding(mesh, P("space", None))
