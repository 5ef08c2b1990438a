"""Structure-of-arrays scene (port of `tinypathtracer_tpu/models/scene.py`).

`FlatScene` holds the same fields as the JAX package's `FlatScene`, as
torch tensors (float32 / int32). `FlatScene.from_numpy` takes those
fields as numpy arrays, which is how a scene built by either package
moves to the other. glTF loading is not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tinypathtracer_tpu_torch.utils.math3d import rsqrt, vdot

_INT_FIELDS = ("indices", "obj_face_begin", "obj_mtl_idx", "face_mtl",
               "vert_obj", "light_kind", "mtl_tex_id")


@dataclasses.dataclass
class FlatScene:
    """Device-side SoA scene; every field is a tensor on one device."""

    # Geometry (local space)
    vertices: torch.Tensor       # [V, 3] f32
    normals: torch.Tensor        # [V, 3] f32
    texcoords: torch.Tensor      # [V, 2] f32
    indices: torch.Tensor        # [F, 3] i32 (into the shared vertex buffer)
    # Per-object tables
    vert_mats: torch.Tensor      # [O, 4, 4] f32 local->world
    normal_mats: torch.Tensor    # [O, 4, 4] f32 inverse-transpose
    obj_face_begin: torch.Tensor  # [O] i32
    obj_mtl_idx: torch.Tensor    # [O] i32
    # Dense per-element maps
    face_mtl: torch.Tensor       # [F] i32 material id per face
    vert_obj: torch.Tensor       # [V] i32 object id per vertex
    # Materials
    mtl_base_color: torch.Tensor  # [M, 3] f32
    mtl_emission: torch.Tensor   # [M] f32 (scalar emission)
    mtl_eta: torch.Tensor        # [M] f32 (0 = non-dielectric)
    mtl_metallic: torch.Tensor   # [M] f32
    mtl_roughness: torch.Tensor  # [M] f32
    mtl_specular: torch.Tensor   # [M] f32
    # Delta lights
    light_kind: torch.Tensor     # [L] i32: 0 point, 1 directional, 2 spot
    light_color: torch.Tensor    # [L, 3] f32
    light_intensity: torch.Tensor  # [L] f32
    light_pos: torch.Tensor      # [L, 3] f32
    light_dir: torch.Tensor      # [L, 3] f32
    light_cos_outer: torch.Tensor  # [L] f32
    light_inv_cone: torch.Tensor  # [L] f32
    # Equirect environment map, row 0 = zenith side
    env_radiance: torch.Tensor   # [He, We, 3] f32
    # Camera
    cam_to_world: torch.Tensor   # [4, 4] f32
    cam_yfov: torch.Tensor       # [] f32 radians
    cam_aspect: torch.Tensor     # [] f32
    cam_znear: torch.Tensor      # [] f32
    # Base-color texture atlas ([1, 1, 1, 3] = no textures)
    tex_atlas: torch.Tensor      # [T, Ht, Wt, 3] f32
    mtl_tex_id: torch.Tensor     # [M] i32, -1 = none

    @classmethod
    def from_numpy(cls, arrays: dict, device) -> "FlatScene":
        """Build from a dict of the JAX FlatScene's fields as numpy arrays."""
        fields = {}
        for f in dataclasses.fields(cls):
            dtype = np.int32 if f.name in _INT_FIELDS else np.float32
            a = np.array(arrays[f.name], dtype=dtype, order="C")
            fields[f.name] = torch.from_numpy(a).to(device)
        return cls(**fields)

    def to(self, device) -> "FlatScene":
        return FlatScene(**{f.name: getattr(self, f.name).to(device)
                            for f in dataclasses.fields(self)})

    @property
    def device(self) -> torch.device:
        return self.vertices.device

    @property
    def has_textures(self) -> bool:
        return self.tex_atlas.shape[0] > 1 or self.tex_atlas.shape[1] > 1 \
            or self.tex_atlas.shape[2] > 1

    def world_geometry(self):
        """Per-object local->world transform of vertices and normals, as
        per-row dot products (utils/math3d.vdot): no matmul, so no matmul
        precision setting enters, and the roundings are the JAX package's."""
        vm = self.vert_mats[self.vert_obj.long()]       # [V, 4, 4]
        nm = self.normal_mats[self.vert_obj.long()]
        wv = vdot(vm[:, :3, :3], self.vertices[:, None, :]) + vm[:, :3, 3]
        wn = vdot(nm[:, :3, :3], self.normals[:, None, :])
        return wv, wn * rsqrt(vdot(wn, wn))[:, None]
