"""ResourceManager: path-keyed caches for textures, materials, meshes.

A copy of ``banggameengine_tpu/scene/resources.py`` (numpy only; the JAX
package cannot be imported without JAX), with two differences: meshes load
through the Python OBJ loader only (the native loader, ``native/``, is not
ported), and textures decode through the port's own PNG decoder
(:mod:`banggameengine_tpu_torch.scene.textures`; the JAX package uses PIL).

Same public surface as the reference's ``ResourceManager`` (load texture,
material and mesh, the checker and default material fallbacks, cache
statistics of hits, misses and approximate bytes, reload, the assets
root).  Assets-root discovery order: ``BANG_ASSETS_DIR`` env -> explicit
constructor argument -> ``./assets`` -> the repository's ``assets/``.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import numpy as np

from banggameengine_tpu_torch.scene import obj_loader, textures as tex_mod
from banggameengine_tpu_torch.scene.obj_loader import MeshData
from banggameengine_tpu_torch.scene.schema import MaterialDesc

log = logging.getLogger("RES")

_DEFAULT_SEARCH = (
    "assets",
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "assets"),
)


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    approx_bytes: int = 0


class ResourceManager:
    """Caches decoded assets keyed by normalized path."""

    def __init__(self, assets_root: str | None = None):
        self._assets_root = self._discover_root(assets_root)
        self._textures: dict[str, np.ndarray] = {}
        self._meshes: dict[str, MeshData] = {}
        self._materials: dict[str, MaterialDesc] = {}
        self.tex_stats = CacheStats()
        self.mesh_stats = CacheStats()
        self.mat_stats = CacheStats()
        self._checker = tex_mod.make_checker_rgba8()
        self._white = tex_mod.make_white_rgba8()
        self._default_material = MaterialDesc(name="__default")

    # -- lifecycle -----------------------------------------------------------
    @staticmethod
    def _discover_root(explicit: str | None) -> str:
        env = os.environ.get("BANG_ASSETS_DIR")
        for cand in ([env] if env else []) + ([explicit] if explicit else []):
            if cand and os.path.isdir(cand):
                return os.path.abspath(cand)
        for cand in _DEFAULT_SEARCH:
            if os.path.isdir(cand):
                return os.path.abspath(cand)
        return os.path.abspath(".")

    def get_assets_root(self) -> str:
        return self._assets_root

    def shutdown(self) -> None:
        self._textures.clear()
        self._meshes.clear()
        self._materials.clear()

    # -- path resolution (the reference's SceneLoader order) -----------------
    def resolve_path(self, path: str) -> str | None:
        if os.path.isabs(path) and os.path.exists(path):
            return path
        cands = [
            path,
            os.path.join(self._assets_root, path),
        ]
        if path.startswith("assets/") or path.startswith("assets\\"):
            cands.append(os.path.join(self._assets_root, path[len("assets/"):]))
        for c in cands:
            if os.path.exists(c):
                return os.path.abspath(c)
        return None

    # -- textures ------------------------------------------------------------
    def get_checker_texture(self) -> np.ndarray:
        return self._checker

    def get_white_texture(self) -> np.ndarray:
        return self._white

    def load_texture(self, path: str) -> np.ndarray:
        resolved = self.resolve_path(path)
        key = resolved or path
        if key in self._textures:
            self.tex_stats.hits += 1
            return self._textures[key]
        self.tex_stats.misses += 1
        if resolved is None:
            log.warning("[TEX] '%s' not found, using checker fallback", path)
            return self._checker
        try:
            tex = tex_mod.load_texture_rgba8(resolved)
        except Exception as e:  # degrade, never crash the loop
            log.warning("[TEX] failed to decode '%s' (%s), checker fallback", path, e)
            return self._checker
        self._textures[key] = tex
        self.tex_stats.approx_bytes += tex_mod.approx_bytes(tex)
        return tex

    # -- materials -----------------------------------------------------------
    def get_default_material(self) -> MaterialDesc:
        return self._default_material

    def load_material(self, desc: MaterialDesc) -> MaterialDesc:
        if desc.name in self._materials:
            self.mat_stats.hits += 1
            return self._materials[desc.name]
        self.mat_stats.misses += 1
        self._materials[desc.name] = desc
        return desc

    # -- meshes --------------------------------------------------------------
    def load_mesh(self, obj_path: str, mtl_path: str | None = None) -> MeshData | None:
        resolved = self.resolve_path(obj_path)
        key = f"{resolved or obj_path}|{mtl_path or ''}"
        if key in self._meshes:
            self.mesh_stats.hits += 1
            return self._meshes[key]
        self.mesh_stats.misses += 1
        if resolved is None:
            log.warning("[MESH] '%s' not found", obj_path)
            return None
        mtl_resolved = self.resolve_path(mtl_path) if mtl_path else None
        try:
            mesh = obj_loader.load_obj(resolved, mtl_resolved)
        except Exception as e:
            log.warning("[MESH] failed to load '%s': %s", obj_path, e)
            return None
        self._meshes[key] = mesh
        self.mesh_stats.approx_bytes += mesh.approx_bytes()
        return mesh

    # -- maintenance ---------------------------------------------------------
    def reload(self, path: str) -> bool:
        """Evict a cached asset so the next load re-reads it."""
        resolved = self.resolve_path(path)
        if resolved is None:
            return False
        evicted = False
        if resolved in self._textures:
            del self._textures[resolved]
            evicted = True
        for k in [k for k in self._meshes if k.startswith(resolved)]:
            del self._meshes[k]
            evicted = True
        return evicted

    def print_stats(self) -> str:
        lines = [
            "[RES] cache stats:",
            f"  textures: {len(self._textures)} cached, "
            f"{self.tex_stats.hits} hits / {self.tex_stats.misses} misses, "
            f"~{self.tex_stats.approx_bytes} bytes",
            f"  meshes:   {len(self._meshes)} cached, "
            f"{self.mesh_stats.hits} hits / {self.mesh_stats.misses} misses, "
            f"~{self.mesh_stats.approx_bytes} bytes",
            f"  materials:{len(self._materials)} cached, "
            f"{self.mat_stats.hits} hits / {self.mat_stats.misses} misses",
        ]
        text = "\n".join(lines)
        log.info(text)
        return text
