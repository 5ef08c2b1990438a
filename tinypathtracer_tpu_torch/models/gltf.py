"""Minimal glTF 2.0 reader (port of `tinypathtracer_tpu/models/gltf.py`).

Host-side numpy, the JAX package's parser line for line. It covers
exactly the subset the reference consumes via tinygltf (mesh.cu:80-307):

  * nodes with TRS transforms (mesh.cu:103-139)
  * perspective cameras (mesh.cu:143-152)
  * mesh primitive 0 with POSITION / NORMAL / TEXCOORD_0 attributes and
    indices in any of the six glTF component types (mesh.cu:158-222)
  * pbrMetallicRoughness materials plus the KHR_materials_transmission /
    emissive_strength / ior extensions (mesh.cu:224-261)
  * KHR_lights_punctual point / directional / spot lights with the
    reference's photometric watts-per-lumen scaling (mesh.cu:267-305)

No external glTF dependency: buffers are decoded from base64 data URIs
(utils/native.b64_decode, the C++ decoder, with no fallback) or read
from sidecar .bin files.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
from typing import Dict, List, Optional

import numpy as np

from tinypathtracer_tpu_torch.utils.math3d import trs_to_mat4
from tinypathtracer_tpu_torch.utils.native import b64_decode

# glTF componentType -> numpy dtype (all six accepted, mesh.cu:177-206)
_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5124: np.int32,
    5125: np.uint32,
    5126: np.float32,
}

_TYPE_NCOMP = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}

WATTS_PER_LUMEN = 1.0 / 683.0  # reference delta_light.h:6-7


@dataclasses.dataclass
class GltfMesh:
    positions: np.ndarray        # [V, 3] f32
    normals: np.ndarray          # [V, 3] f32
    texcoords: np.ndarray        # [V, 2] f32
    indices: np.ndarray          # [F * 3] u32
    material: str                # material name key
    translation: np.ndarray      # [3]
    rotation: np.ndarray         # [4] (x, y, z, w)
    scale: np.ndarray            # [3]
    name: str = ""


@dataclasses.dataclass
class GltfMaterial:
    name: str
    base_color: np.ndarray       # [3]
    metallic: float = 0.0
    roughness: float = 0.5
    emission_factor: float = 0.0
    eta: float = 0.0
    specular: float = 0.5
    base_color_texture: Optional[int] = None


@dataclasses.dataclass
class GltfLight:
    kind: str                    # "point" | "directional" | "spot"
    color: np.ndarray            # [3]
    intensity: float
    position: np.ndarray         # [3] world (point/spot)
    direction: np.ndarray        # [3] world (directional/spot)
    cos_outer: float = 0.0
    inv_cos_cone_diff: float = 0.0
    name: str = ""


@dataclasses.dataclass
class GltfCamera:
    yfov: float                  # radians (glTF spec; used directly, mesh.cu:148)
    aspect: float
    znear: float
    translation: np.ndarray
    rotation: np.ndarray
    scale: np.ndarray


@dataclasses.dataclass
class GltfDocument:
    meshes: List[GltfMesh]
    materials: Dict[str, GltfMaterial]
    lights: List[GltfLight]
    camera: Optional[GltfCamera]
    # decoded texture images, indexed by glTF TEXTURE index (already
    # resolved through textures[].source): [H, W, 3] f32 in [0, 1].
    # The reference parses baseColorTexture but never uploads it
    # (TODOs mesh.cu:155, mesh.cuh:114); we finish the job.
    images: List[np.ndarray] = dataclasses.field(default_factory=list)


def _load_buffers(doc: dict, base_dir: str) -> List[bytes]:
    bufs = []
    for b in doc.get("buffers", []):
        uri = b.get("uri", "")
        if uri.startswith("data:"):
            _, payload = uri.split(",", 1)
            bufs.append(b64_decode(payload))
        elif uri:
            with open(os.path.join(base_dir, uri), "rb") as f:
                bufs.append(f.read())
        else:
            raise ValueError("glTF buffer without uri (GLB not supported)")
    return bufs


def _read_accessor(doc: dict, buffers: List[bytes], accessor_idx: int) -> np.ndarray:
    acc = doc["accessors"][accessor_idx]
    view = doc["bufferViews"][acc["bufferView"]]
    buf = buffers[view["buffer"]]
    dtype = np.dtype(_COMPONENT_DTYPES[acc["componentType"]])
    ncomp = _TYPE_NCOMP[acc["type"]]
    count = acc["count"]
    offset = acc.get("byteOffset", 0) + view.get("byteOffset", 0)
    stride = view.get("byteStride") or dtype.itemsize * ncomp
    if stride == dtype.itemsize * ncomp:
        arr = np.frombuffer(buf, dtype=dtype, count=count * ncomp, offset=offset)
        arr = arr.reshape(count, ncomp)
    else:  # interleaved
        raw = np.frombuffer(buf, dtype=np.uint8)
        rows = np.stack(
            [raw[offset + i * stride: offset + i * stride + dtype.itemsize * ncomp]
             for i in range(count)]
        )
        arr = rows.view(dtype).reshape(count, ncomp)
    return np.array(arr)  # copy out of the shared buffer


def _node_trs(node: dict):
    t = np.asarray(node.get("translation", [0.0, 0.0, 0.0]), dtype=np.float64)
    # Default quaternion is the reference's zero-initialized Quat, which
    # its RotateFromQuat maps to identity (quat.h:10, 52-69).
    r = np.asarray(node.get("rotation", [0.0, 0.0, 0.0, 0.0]), dtype=np.float64)
    s = np.asarray(node.get("scale", [1.0, 1.0, 1.0]), dtype=np.float64)
    return t, r, s


def _parse_material(mat: dict) -> GltfMaterial:
    pbr = mat.get("pbrMetallicRoughness", {})
    base = np.asarray(pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0]))[:3]
    out = GltfMaterial(
        name=mat.get("name", ""),
        base_color=base.astype(np.float64),
        metallic=float(pbr.get("metallicFactor", 1.0)),
        roughness=float(pbr.get("roughnessFactor", 1.0)),
    )
    tex = pbr.get("baseColorTexture")
    if tex is not None:
        out.base_color_texture = int(tex.get("index"))
    ext = mat.get("extensions", {})
    if "KHR_materials_transmission" in ext:
        # Reference maps transmissionFactor into the (otherwise unused)
        # specular slot as 1 - f/5 (mesh.cu:245-248).
        out.specular = 1.0 - float(
            ext["KHR_materials_transmission"].get("transmissionFactor", 0.0)) / 5.0
    if "KHR_materials_emissive_strength" in ext:
        out.emission_factor = float(
            ext["KHR_materials_emissive_strength"].get("emissiveStrength", 0.0))
    if "KHR_materials_ior" in ext:
        out.eta = float(ext["KHR_materials_ior"].get("ior", 0.0))
    return out


def _load_texture_images(doc: dict, buffers, base_dir: str) -> List[np.ndarray]:
    """One decoded [H, W, 3] image per glTF TEXTURE (not per image)."""
    from PIL import Image

    def decode(img):
        uri = img.get("uri")
        if uri is not None:
            if uri.startswith("data:"):
                _, payload = uri.split(",", 1)
                raw = io.BytesIO(b64_decode(payload))
            else:
                raw = os.path.join(base_dir, uri)
        else:
            view = doc["bufferViews"][img["bufferView"]]
            buf = buffers[view.get("buffer", 0)]
            off = view.get("byteOffset", 0)
            raw = io.BytesIO(buf[off:off + view["byteLength"]])
        pil = Image.open(raw).convert("RGB")
        return np.asarray(pil, dtype=np.float32) / 255.0

    images = [decode(i) for i in doc.get("images", [])]
    out = []
    for tex in doc.get("textures", []):
        src_i = tex.get("source")
        out.append(images[src_i] if src_i is not None and src_i < len(images)
                   else np.ones((1, 1, 3), np.float32))
    return out


def read_gltf(path: str) -> GltfDocument:
    """Parse a .gltf file into host-side numpy structures."""
    with open(path, "r") as f:
        doc = json.load(f)
    base_dir = os.path.dirname(os.path.abspath(path))
    buffers = _load_buffers(doc, base_dir)

    materials: Dict[str, GltfMaterial] = {}
    meshes: List[GltfMesh] = []
    lights: List[GltfLight] = []
    camera: Optional[GltfCamera] = None

    punctual = (
        doc.get("extensions", {})
        .get("KHR_lights_punctual", {})
        .get("lights", [])
    )

    for node in doc.get("nodes", []):
        t, r, s = _node_trs(node)
        if "camera" in node:
            cam = doc["cameras"][node["camera"]]
            if cam.get("type") == "perspective":
                p = cam["perspective"]
                camera = GltfCamera(
                    yfov=float(p["yfov"]),
                    aspect=float(p.get("aspectRatio", 16.0 / 9.0)),
                    znear=float(p.get("znear", 0.1)),
                    translation=t, rotation=r, scale=s,
                )
            # orthographic: unsupported in the reference too (mesh.cu:153-156)
        elif "mesh" in node:
            mesh = doc["meshes"][node["mesh"]]
            prim = mesh["primitives"][0]  # reference reads primitive 0 only
            attrs = prim["attributes"]
            positions = _read_accessor(doc, buffers, attrs["POSITION"]).astype(np.float32)
            normals = _read_accessor(doc, buffers, attrs["NORMAL"]).astype(np.float32)
            if "TEXCOORD_0" in attrs:
                texcoords = _read_accessor(doc, buffers, attrs["TEXCOORD_0"]).astype(np.float32)
            else:
                texcoords = np.zeros((positions.shape[0], 2), dtype=np.float32)
            indices = _read_accessor(doc, buffers, prim["indices"])
            indices = indices.reshape(-1).astype(np.uint32)

            mat_name = ""
            if "material" in prim and doc.get("materials"):
                mat = doc["materials"][prim["material"]]
                mat_name = mat.get("name", f"material_{prim['material']}")
                if mat_name not in materials:
                    parsed = _parse_material(mat)
                    parsed.name = mat_name
                    materials[mat_name] = parsed
            meshes.append(GltfMesh(
                positions=positions, normals=normals, texcoords=texcoords,
                indices=indices, material=mat_name,
                translation=t, rotation=r, scale=s,
                name=node.get("name", ""),
            ))
        elif "extensions" in node and "KHR_lights_punctual" in node["extensions"]:
            li = punctual[node["extensions"]["KHR_lights_punctual"]["light"]]
            l2w = trs_to_mat4(t, r, s)
            world_pos = l2w[:3, 3].copy()
            world_dir = (l2w[:3, :3] @ np.array([0.0, 0.0, -1.0])).copy()
            kind = li["type"]
            color = np.asarray(li.get("color", [1.0, 1.0, 1.0]), dtype=np.float64)
            intensity = float(li.get("intensity", 1.0))
            light = GltfLight(
                kind=kind, color=color, intensity=intensity,
                position=world_pos, direction=world_dir,
                name=node.get("name", ""),
            )
            if kind == "point":
                # candela -> watts (reference mesh.cu:276)
                light.intensity = intensity * WATTS_PER_LUMEN
            elif kind == "directional":
                light.intensity = intensity  # lux kept as-is (mesh.cu:283)
            elif kind == "spot":
                light.intensity = intensity * WATTS_PER_LUMEN
                spot = li.get("spot", {})
                inner = float(spot.get("innerConeAngle", 0.0))
                outer = float(spot.get("outerConeAngle", np.pi / 4.0))
                light.cos_outer = float(np.cos(outer))
                denom = np.cos(inner) - np.cos(outer)
                light.inv_cos_cone_diff = float(1.0 / denom) if denom != 0 else 0.0
            else:
                raise ValueError(f"unsupported light type {kind!r}")
            lights.append(light)

    return GltfDocument(meshes=meshes, materials=materials, lights=lights,
                        camera=camera,
                        images=_load_texture_images(doc, buffers, base_dir))
