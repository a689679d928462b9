"""Material / shading-program registry.

Analog of the reference's named GLSL program store + texture
manager (src/graphics/ShaderManager.h:37, TexManager, GLSurface; programs
loaded from data/shaders/ at src/main.cpp:675). GLSL programs don't exist
here — shading is jitted JAX math — so a "shader" becomes a named set of
shading PARAMETERS (a `Material`) consumed by both renderers:

  * the differentiable sphere tracer (render.sphere_trace.shade and
    render.deformed.shade_deformed take `material=`),
  * the host rasterizer (graphics.raster.rasterize).

Registries can be populated programmatically or from an INI folder the
way the reference scans data/shaders/ (one [MATERIAL] section per file —
utils.ini.IniFile is the SettingsScript analog).

Image textures (r5, closes the TexManager/GLSurface/lodepng gap —
src/graphics/TexManager.*, assets in data/textures/): `Texture` loads
PNG/JPG via PIL and samples bilinearly; since implicit surfaces carry no
UV atlas, the default mapping is world-space TRIPLANAR projection
(sample the three axis planes, blend by |normal| weights). Both
renderers consume it: graphics.raster.rasterize(texture=...) modulates
the flat shade per pixel (NumPy path), and render shading can modulate
albedo with `triplanar_sample_jax` inside the jitted graph.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

import jax


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Material:
    """Blinn-Phong shading parameters (the phong.{vsh,fsh} analog)."""

    ambient: float = 0.25
    diffuse: float = 0.75
    specular: float = 0.3
    shininess: float = 32.0

    @classmethod
    def from_ini(cls, path) -> "Material":
        from ..utils.ini import SettingsScript

        ini = SettingsScript.load(path)
        sec = "MATERIAL"
        return cls(
            ambient=ini.read_float(sec, "ambient", cls.ambient),
            diffuse=ini.read_float(sec, "diffuse", cls.diffuse),
            specular=ini.read_float(sec, "specular", cls.specular),
            shininess=ini.read_float(sec, "shininess", cls.shininess),
        )


# The reference's stock programs, as parameter presets.
PHONG = Material()
FLAT = Material(ambient=1.0, diffuse=0.0, specular=0.0)          # "green"
EDGES = Material(ambient=0.6, diffuse=0.4, specular=0.0)  # "avataredges"


@dataclasses.dataclass(frozen=True)
class Texture:
    """Image texture (TheTexManager/lodepng analog,
    src/graphics/TexManager.*): [H, W, 3] float image in [0, 1],
    bilinearly sampled with wrap addressing."""

    image: np.ndarray
    name: str = ""

    @classmethod
    def load(cls, path) -> "Texture":
        from PIL import Image

        img = Image.open(path).convert("RGB")
        arr = np.asarray(img, np.float32) / 255.0
        return cls(image=arr, name=Path(path).stem)

    def sample(self, u, v) -> np.ndarray:
        """Bilinear sample at wrap-addressed UVs (arrays ok) -> [..., 3]."""
        h, w, _ = self.image.shape
        x = (np.asarray(u) % 1.0) * (w - 1)
        y = (np.asarray(v) % 1.0) * (h - 1)
        x0 = np.floor(x).astype(np.int64)
        y0 = np.floor(y).astype(np.int64)
        x1 = np.minimum(x0 + 1, w - 1)
        y1 = np.minimum(y0 + 1, h - 1)
        fx = (x - x0)[..., None]
        fy = (y - y0)[..., None]
        im = self.image
        top = im[y0, x0] * (1 - fx) + im[y0, x1] * fx
        bot = im[y1, x0] * (1 - fx) + im[y1, x1] * fx
        return top * (1 - fy) + bot * fy


def triplanar_sample(tex: Texture, pts, normals, scale: float = 1.0):
    """World-space triplanar projection -> [N, 3] albedo: sample the
    three axis-aligned planes at `scale` texels per world unit and
    blend by the squared normal components (the standard UV-free
    mapping for implicit surfaces)."""
    p = np.asarray(pts) * scale
    n = np.asarray(normals)
    w = n * n
    w = w / np.maximum(w.sum(-1, keepdims=True), 1e-12)
    cx = tex.sample(p[..., 1], p[..., 2])   # YZ plane (x normal)
    cy = tex.sample(p[..., 0], p[..., 2])   # XZ plane
    cz = tex.sample(p[..., 0], p[..., 1])   # XY plane
    return (cx * w[..., 0:1] + cy * w[..., 1:2] + cz * w[..., 2:3])


def triplanar_sample_jax(image, pts, normals, scale: float = 1.0):
    """Jitted triplanar sample for the tracers: `image` is a [H, W, 3]
    jnp array; pts/normals [N, 3]. Same math as triplanar_sample."""
    import jax.numpy as jnp

    h, w = image.shape[0], image.shape[1]

    def samp(u, v):
        x = (u % 1.0) * (w - 1)
        y = (v % 1.0) * (h - 1)
        x0 = jnp.floor(x).astype(jnp.int32)
        y0 = jnp.floor(y).astype(jnp.int32)
        x1 = jnp.minimum(x0 + 1, w - 1)
        y1 = jnp.minimum(y0 + 1, h - 1)
        fx = (x - x0)[..., None]
        fy = (y - y0)[..., None]
        top = image[y0, x0] * (1 - fx) + image[y0, x1] * fx
        bot = image[y1, x0] * (1 - fx) + image[y1, x1] * fx
        return top * (1 - fy) + bot * fy

    p = pts * scale
    n2 = normals * normals
    wgt = n2 / jnp.maximum(jnp.sum(n2, -1, keepdims=True), 1e-12)
    cx = samp(p[..., 1], p[..., 2])
    cy = samp(p[..., 0], p[..., 2])
    cz = samp(p[..., 0], p[..., 1])
    return (cx * wgt[..., 0:1] + cy * wgt[..., 1:2]
            + cz * wgt[..., 2:3])


class MaterialRegistry:
    """Named material + texture store (TheShaderManager/TheTexManager
    analog)."""

    def __init__(self):
        self._store: dict[str, Material] = {
            "phong": PHONG, "flat": FLAT, "edges": EDGES,
        }
        self._textures: dict[str, Texture] = {}

    def add_texture(self, name: str, tex: Texture) -> None:
        self._textures[name] = tex

    def get_texture(self, name: str) -> Texture:
        return self._textures[name]

    def texture_names(self) -> list[str]:
        return sorted(self._textures)

    def add_textures_from_folder(self, folder) -> int:
        """Load every png/jpg in `folder` (the reference loads
        data/textures/ assets via lodepng). Returns the count."""
        n = 0
        for p in sorted(Path(folder).iterdir()):
            if p.suffix.lower() in (".png", ".jpg", ".jpeg"):
                self.add_texture(p.stem, Texture.load(p))
                n += 1
        return n

    def add(self, name: str, mat: Material) -> None:
        self._store[name] = mat

    def get(self, name: str) -> Material:
        return self._store[name]

    def __contains__(self, name: str) -> bool:
        return name in self._store

    def names(self) -> list[str]:
        return sorted(self._store)

    def add_from_folder(self, folder) -> int:
        """Load every *.mat INI in `folder` (addFromFolder analog,
        src/main.cpp:675). Returns the number loaded."""
        n = 0
        for p in sorted(Path(folder).glob("*.mat")):
            self.add(p.stem, Material.from_ini(p))
            n += 1
        return n


the_materials = MaterialRegistry()
