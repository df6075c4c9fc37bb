"""Texture file loading — parity with Image::Load (image.cpp:38-61):
forced RGBA, auto-downscale so max dimension ≤ 1024, u8 → float p/255.
Failed loads return None (the reference's Image keeps a null buffer whose
tex2D yields vec4(0) — loaders map that to a 1×1 zero texture)."""

from __future__ import annotations

import numpy as np

from ..utils.constants import MAX_TEXTURE_DIM


def load_texture(path: str):
    """Load an image file → f32[H,W,4] in [0,1], or None when the file is
    missing or unreadable. Decoding needs Pillow; without it this raises
    ImportError rather than returning a black texture."""
    from PIL import Image
    try:
        with Image.open(path) as im:
            im = im.convert("RGBA")
            w, h = im.size
            if w > MAX_TEXTURE_DIM or h > MAX_TEXTURE_DIM:
                scale = MAX_TEXTURE_DIM / float(max(w, h))
                # int truncation parity (image.cpp:50-51)
                im = im.resize((int(w * scale), int(h * scale)),
                               Image.BILINEAR)
            arr = np.asarray(im, np.uint8).astype(np.float32) / 255.0
            return arr
    except OSError:
        return None


ZERO_TEXTURE = np.zeros((1, 1, 4), np.float32)


class TextureCache:
    """Deduplicating texture registry (mirrors PathTracer::mLoadedTextures
    sharing, pathtracer.cpp:147-241). Maps path → stack index."""

    def __init__(self):
        self.images = []
        self.by_path = {}

    def add(self, path: str) -> int:
        if path in self.by_path:
            return self.by_path[path]
        img = load_texture(path)
        if img is None:
            img = ZERO_TEXTURE
        idx = len(self.images)
        self.images.append(img)
        self.by_path[path] = idx
        return idx
