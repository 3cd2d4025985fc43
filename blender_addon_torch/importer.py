"""Mesh/material construction from the port's CLI output directory (the
JAX add-on's `blender_addon/importer.py`, reading through
`command.read_result`):

  - VERTS: one mesh vertex per point
  - DUPLI: a small tetrahedron per point ("DupliVerts")
  - POINT_CLOUD: vertices with point-cloud viewport display
  - FLOAT_COLOR point-domain attribute "Color"
  - Principled-BSDF material wired to the Color attribute including emission
  - one camera per pose of c2w.npy
"""

import bpy
import numpy as np

from .command import read_result

_TETRA = np.array([  # unit tetrahedron (reference importer.py:70-77)
    [0.0, 0.0, 1.0],
    [0.943, 0.0, -0.333],
    [-0.471, 0.816, -0.333],
    [-0.471, -0.816, -0.333],
], np.float32)
_TETRA_FACES = [(0, 1, 2), (0, 2, 3), (0, 3, 1), (1, 3, 2)]


def import_result(out_dir, props):
    pts, cols, c2w = read_result(out_dir)
    if cols is None:
        cols = np.full_like(pts, 0.8)

    mesh = bpy.data.meshes.new("StarsterTorchPoints")
    if props.import_as == "DUPLI":
        s = props.dupli_size
        verts = (pts[:, None, :] + _TETRA[None] * s).reshape(-1, 3)
        faces = [tuple(i * 4 + v for v in face)
                 for i in range(len(pts)) for face in _TETRA_FACES]
        mesh.from_pydata(verts.tolist(), [], faces)
        col_per_vert = np.repeat(cols, 4, axis=0)
    else:  # VERTS / POINT_CLOUD
        mesh.from_pydata(pts.tolist(), [], [])
        col_per_vert = cols

    attr = mesh.attributes.new(name="Color", type="FLOAT_COLOR",
                               domain="POINT")
    rgba = np.concatenate(
        [col_per_vert, np.ones((len(col_per_vert), 1), np.float32)], axis=1)
    attr.data.foreach_set("color", rgba.reshape(-1))
    mesh.update()

    obj = bpy.data.objects.new("StarsterTorch", mesh)
    bpy.context.collection.objects.link(obj)

    if props.import_as == "DUPLI":
        for poly in mesh.polygons:
            poly.use_smooth = True
    if props.make_material:
        obj.data.materials.append(_make_material())
    if c2w is not None:
        _import_cameras(c2w)
    return obj


def _make_material():
    """Principled BSDF fed by the Color attribute, incl. emission."""
    mat = bpy.data.materials.new("StarsterTorchMat")
    mat.use_nodes = True
    nodes = mat.node_tree.nodes
    links = mat.node_tree.links
    bsdf = nodes.get("Principled BSDF")
    attr = nodes.new("ShaderNodeAttribute")
    attr.attribute_name = "Color"
    links.new(attr.outputs["Color"], bsdf.inputs["Base Color"])
    if "Emission Color" in bsdf.inputs:        # Blender 4.x naming
        links.new(attr.outputs["Color"], bsdf.inputs["Emission Color"])
        bsdf.inputs["Emission Strength"].default_value = 1.0
    elif "Emission" in bsdf.inputs:
        links.new(attr.outputs["Color"], bsdf.inputs["Emission"])
    return mat


def _import_cameras(c2w):
    # OpenCV cam (+z forward, +y down) -> Blender (-z forward, +y up)
    flip = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    for i, m in enumerate(c2w):
        cam = bpy.data.cameras.new(f"StarsterTorchCam{i}")
        obj = bpy.data.objects.new(f"StarsterTorchCam{i}", cam)
        obj.matrix_world = [list(r) for r in (m @ flip)]
        bpy.context.collection.objects.link(obj)
