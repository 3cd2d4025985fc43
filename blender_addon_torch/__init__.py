"""Starst3r Blender add-on for the PyTorch/CUDA port (`starst3r_tpu_torch`).

The JAX package's add-on (`blender_addon/`) written for the port: the same
panel, properties, confirm dialog and import modes, with one more field,
the device (cuda or cpu) the reconstruction runs on. Reconstruction runs
in a subprocess, `python -m starst3r_tpu_torch --device <device>
reconstruct ...` (`command.py`), and the add-on imports the exported
points.ply and c2w.npy, so Blender stays responsive and its bundled Python
needs neither torch nor the port.

Its ids are its own (`starster_torch.*`, `STARSTER_TORCH_PT_Panel`,
`Scene.starster_torch`), so it can be enabled beside the JAX add-on.

Install: zip this directory and use Blender's "Install Add-on", or copy it
into the addons folder. The external Python named in the panel needs the
port importable (installed, or the repository on its PYTHONPATH) and, for
device cuda, an NVIDIA GPU with the CUDA toolkit.
"""

bl_info = {
    "name": "Starst3r (PyTorch/CUDA)",
    "author": "starst3r-tpu",
    "version": (0, 1, 0),
    "blender": (2, 80, 0),
    "location": "3D Viewport > Sidebar > Starst3r Torch",
    "description": "Ultra fast 3D reconstruction (MASt3R-style + 3DGS) "
                   "via the starst3r_tpu_torch CLI, on an NVIDIA GPU",
    "category": "Import-Export",
}

try:
    import bpy  # noqa: F401
    _HAVE_BPY = True
except Exception:  # pragma: no cover - outside Blender
    _HAVE_BPY = False

if _HAVE_BPY:
    from . import interface

    def register():
        interface.register()

    def unregister():
        interface.unregister()
else:  # importable for tests/linting outside Blender
    def register():  # pragma: no cover
        raise RuntimeError("bpy not available")

    def unregister():  # pragma: no cover
        raise RuntimeError("bpy not available")
