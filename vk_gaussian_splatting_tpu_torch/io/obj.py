"""Minimal OBJ/MTL loader (ObjLoader, obj_loader.cpp:1-205); a copy of
``vk_gaussian_splatting_tpu/io/obj.py``, which is pure numpy.

Produces triangle soup with per-vertex position/normal plus per-triangle
material indices — the ObjVertex{pos,nrm} + ObjMaterial model of
shaders/wavefront.h:28-50. Pure numpy; polygons are fan-triangulated.
``render/mesh_raster.mesh_buffers_from_obj`` puts an ObjMesh on a device.
``octa_sphere`` (not in the JAX module) builds a sphere mesh in code in the
loader's form.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass
class ObjMaterial:
    """wavefront.h ObjMaterial subset (Phong + transmission)."""

    name: str = "default"
    ambient: tuple = (0.1, 0.1, 0.1)
    diffuse: tuple = (0.7, 0.7, 0.7)
    specular: tuple = (1.0, 1.0, 1.0)
    emission: tuple = (0.0, 0.0, 0.0)
    transmittance: tuple = (0.0, 0.0, 0.0)
    shininess: float = 0.0
    ior: float = 1.0
    dissolve: float = 1.0
    illum: int = 0


@dataclasses.dataclass
class ObjMesh:
    positions: np.ndarray   # (V, 3) f32
    normals: np.ndarray     # (V, 3) f32
    indices: np.ndarray     # (F, 3) i32
    mat_indices: np.ndarray  # (F,) i32
    materials: list


def _load_mtl(path: str) -> dict[str, ObjMaterial]:
    mats: dict[str, ObjMaterial] = {}
    cur = None
    with open(path) as f:
        for line in f:
            t = line.split()
            if not t or t[0].startswith("#"):
                continue
            if t[0] == "newmtl":
                cur = ObjMaterial(name=t[1])
                mats[t[1]] = cur
            elif cur is not None:
                if t[0] == "Ka":
                    cur.ambient = tuple(map(float, t[1:4]))
                elif t[0] == "Kd":
                    cur.diffuse = tuple(map(float, t[1:4]))
                elif t[0] == "Ks":
                    cur.specular = tuple(map(float, t[1:4]))
                elif t[0] == "Ke":
                    cur.emission = tuple(map(float, t[1:4]))
                elif t[0] == "Kt" or t[0] == "Tf":
                    cur.transmittance = tuple(map(float, t[1:4]))
                elif t[0] == "Ns":
                    cur.shininess = float(t[1])
                elif t[0] == "Ni":
                    cur.ior = float(t[1])
                elif t[0] == "d":
                    cur.dissolve = float(t[1])
                elif t[0] == "illum":
                    cur.illum = int(t[1])
    return mats


def load_obj(path: str) -> ObjMesh:
    positions: list = []
    normals: list = []
    faces: list = []
    face_mats: list = []
    materials: list[ObjMaterial] = [ObjMaterial()]
    mat_by_name = {"default": 0}
    cur_mat = 0

    with open(path) as f:
        for line in f:
            t = line.split()
            if not t or t[0].startswith("#"):
                continue
            if t[0] == "v":
                positions.append([float(x) for x in t[1:4]])
            elif t[0] == "vn":
                normals.append([float(x) for x in t[1:4]])
            elif t[0] == "mtllib":
                mtl_path = os.path.join(os.path.dirname(path), t[1])
                if os.path.exists(mtl_path):
                    for name, mat in _load_mtl(mtl_path).items():
                        mat_by_name[name] = len(materials)
                        materials.append(mat)
            elif t[0] == "usemtl":
                cur_mat = mat_by_name.get(t[1], 0)
            elif t[0] == "f":
                verts = []
                for v in t[1:]:
                    parts = v.split("/")
                    vi = int(parts[0])
                    ni = int(parts[2]) if len(parts) >= 3 and parts[2] else 0
                    verts.append((vi, ni))
                for k in range(1, len(verts) - 1):  # fan triangulation
                    faces.append((verts[0], verts[k], verts[k + 1]))
                    face_mats.append(cur_mat)

    pos = np.asarray(positions, np.float32).reshape(-1, 3)
    nrm_src = np.asarray(normals, np.float32).reshape(-1, 3)

    # expand to per-corner vertices (positions+normals welded per corner)
    out_pos, out_nrm, out_idx = [], [], []
    vert_cache: dict = {}
    tri_indices = []
    for tri in faces:
        idxs = []
        for vi, ni in tri:
            key = (vi, ni)
            if key not in vert_cache:
                vert_cache[key] = len(out_pos)
                out_pos.append(pos[vi - 1 if vi > 0 else vi])
                out_nrm.append(nrm_src[ni - 1] if ni > 0 and nrm_src.size else np.zeros(3, np.float32))
            idxs.append(vert_cache[key])
        tri_indices.append(idxs)

    p = np.asarray(out_pos, np.float32).reshape(-1, 3)
    nrm = np.asarray(out_nrm, np.float32).reshape(-1, 3)
    idx = np.asarray(tri_indices, np.int32).reshape(-1, 3)

    # compute face normals where missing
    if idx.size:
        missing = np.linalg.norm(nrm, axis=1) < 1e-8
        if missing.any():
            fn = np.cross(p[idx[:, 1]] - p[idx[:, 0]], p[idx[:, 2]] - p[idx[:, 0]])
            fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-12)
            acc = np.zeros_like(nrm)
            for c in range(3):
                np.add.at(acc, idx[:, c], fn)
            acc /= np.maximum(np.linalg.norm(acc, axis=1, keepdims=True), 1e-12)
            nrm[missing] = acc[missing]

    return ObjMesh(
        positions=p, normals=nrm, indices=idx,
        mat_indices=np.asarray(face_mats, np.int32), materials=materials,
    )


def octa_sphere(subdiv: int, radius: float, material: ObjMaterial | None = None) -> ObjMesh:
    """An octahedron subdivided ``subdiv`` times onto a sphere of ``radius``
    at the origin (8 * 4**subdiv faces, each edge split at its midpoint
    pushed out to the unit sphere in float64), with exact per-vertex
    normals and one material: the sphere of the JAX package's mesh tests
    (tests/test_mesh.py ``_octa_sphere``), as an ObjMesh."""
    verts = [np.array(v, np.float64) for v in
             [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)]]
    faces = [(0, 2, 4), (2, 1, 4), (1, 3, 4), (3, 0, 4), (2, 0, 5), (1, 2, 5), (3, 1, 5),
             (0, 3, 5)]
    for _ in range(subdiv):
        cache, new = {}, []

        def mid(a, b):
            k = (min(a, b), max(a, b))
            if k not in cache:
                cache[k] = len(verts)
                m = verts[a] + verts[b]
                verts.append(m / np.linalg.norm(m))
            return cache[k]

        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new += [(a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca)]
        faces = new
    unit = np.asarray(verts, np.float32)
    return ObjMesh(unit * np.float32(radius), unit, np.asarray(faces, np.int32),
                   np.zeros(len(faces), np.int32), [material or ObjMaterial()])
