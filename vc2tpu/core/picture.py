"""Picture pytree: three int32 planes + static geometry.

Array-native replacement for the reference's ``Picture``/``Frame`` classes
(/root/reference/src/Library/Picture.h:53-70, src/Frame.cpp:40-110).
Planes are plain arrays (jnp or np); geometry travels as aux data so a
Picture can cross a ``jax.jit`` boundary.

Interlaced fields are stride-2 row views: ``top = plane[0::2]``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import numpy as np

from vc2tpu.core.config import ColourFormat, PictureGeometry


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class Picture:
    y: Any
    c1: Any
    c2: Any
    chroma_format: ColourFormat = ColourFormat.CF444

    def tree_flatten(self):
        return (self.y, self.c1, self.c2), self.chroma_format

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, chroma_format=aux)

    @property
    def geometry(self) -> PictureGeometry:
        return PictureGeometry(
            int(self.y.shape[0]), int(self.y.shape[1]),
            int(self.c1.shape[0]), int(self.c1.shape[1]),
            self.chroma_format,
        )

    def map(self, fn_luma, fn_chroma=None) -> "Picture":
        fn_chroma = fn_chroma or fn_luma
        return Picture(fn_luma(self.y), fn_chroma(self.c1), fn_chroma(self.c2),
                       self.chroma_format)

    # --- interlace field views (reference src/Library/src/Frame.cpp:40-110) ---

    def top_field(self) -> "Picture":
        return self.map(lambda p: p[0::2])

    def bottom_field(self) -> "Picture":
        return self.map(lambda p: p[1::2])

    def first_field(self, top_field_first: bool) -> "Picture":
        return self.top_field() if top_field_first else self.bottom_field()

    def second_field(self, top_field_first: bool) -> "Picture":
        return self.bottom_field() if top_field_first else self.top_field()


def interleave_fields(first: Picture, second: Picture, top_field_first: bool) -> Picture:
    """Weave two fields back into a frame (numpy or jnp planes)."""
    top, bottom = (first, second) if top_field_first else (second, first)

    def weave(t, b):
        xp = np if isinstance(t, np.ndarray) else jax.numpy
        return xp.stack([t, b], axis=1).reshape(t.shape[0] * 2, t.shape[1])

    return Picture(weave(top.y, bottom.y), weave(top.c1, bottom.c1),
                   weave(top.c2, bottom.c2), first.chroma_format)


def clip(picture: Picture, luma_min: int, luma_max: int,
         chroma_min: int, chroma_max: int) -> Picture:
    """Clip planes to signal range (reference src/Library/src/Picture.cpp:284-292)."""

    def cl(lo, hi):
        def f(p):
            xp = np if isinstance(p, np.ndarray) else jax.numpy
            return xp.clip(p, lo, hi)
        return f

    return picture.map(cl(luma_min, luma_max), cl(chroma_min, chroma_max))


def signal_clip(picture: Picture, luma_depth: int, chroma_depth: int) -> Picture:
    """Clip to [-2^(d-1), 2^(d-1)-1] as DecodeStream does
    (/root/reference/src/DecodeStream/DecodeStream.cpp:591-598)."""
    return clip(
        picture,
        -(1 << (luma_depth - 1)), (1 << (luma_depth - 1)) - 1,
        -(1 << (chroma_depth - 1)), (1 << (chroma_depth - 1)) - 1,
    )


# Standard frame resolutions for format guessing
# (reference src/Library/FrameResolutions.h:14-34).
FRAME_RESOLUTIONS = (
    (1080, 1920), (1080, 1440), (1080, 960),
    (720, 1280), (720, 960), (720, 640),
    (576, 720), (576, 704), (576, 540), (576, 360),
    (486, 720), (486, 704), (486, 540), (486, 360),
    (480, 720), (480, 704), (480, 540), (480, 360),
)


def _samples(g) -> int:
    return g.luma_height * g.luma_width + 2 * g.chroma_height * g.chroma_width


def guess_geometry(image_samples: int, height: int = 0, width: int = 0,
                   chroma_format=None):
    """Infer a PictureGeometry from a sample count, mirroring the reference
    PictureFormat guessing constructor (src/Library/src/Picture.cpp:120-150):
    explicit dims are validated against the count; a missing colour format
    tries 4:4:4 then 4:2:2 then 4:2:0; missing dims search the standard
    resolution table. Returns None when nothing matches."""
    from vc2tpu.core.config import ColourFormat, PictureGeometry

    formats = ([chroma_format] if chroma_format else
               [ColourFormat.CF444, ColourFormat.CF422, ColourFormat.CF420])
    if height and width:
        for fmt in formats:
            g = PictureGeometry.of(height, width, fmt)
            if _samples(g) == image_samples:
                return g
        return None
    for fmt in formats:
        for (h, w) in FRAME_RESOLUTIONS:
            g = PictureGeometry.of(h, w, fmt)
            if _samples(g) == image_samples:
                return g
    return None
