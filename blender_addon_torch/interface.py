"""Props / operators / panel (the JAX add-on's, `blender_addon/interface.py`,
for the port): model path, image directory, resolution (default 224),
preset, import-as enum, dupli size, make-material toggle, the external
Python, and the device the port runs on. The command and its checks are in
`command.py`.
"""

import tempfile

import bpy

from . import command, importer


class StarsterTorchProps(bpy.types.PropertyGroup):
    python_path: bpy.props.StringProperty(
        name="Python", subtype="FILE_PATH", default="python3",
        description="External python with starst3r_tpu_torch importable")
    device: bpy.props.EnumProperty(
        name="Device",
        items=[("cuda", "cuda", "The NVIDIA GPU (needs the CUDA toolkit)"),
               ("cpu", "cpu", "The CPU (slow; for small tests)")],
        default="cuda")
    model_path: bpy.props.StringProperty(
        name="Model", subtype="FILE_PATH", default="",
        description="Model checkpoint (.npz); empty = random weights of "
                    "the preset (debug)")
    preset: bpy.props.EnumProperty(
        name="Preset", items=[(p, p, "") for p in command.PRESETS],
        default="tiny")
    directory: bpy.props.StringProperty(
        name="Images", subtype="DIR_PATH", default="",
        description="Directory of jpg/png input images")
    resolution: bpy.props.IntProperty(
        name="Resolution", default=224, min=32,
        description="Longest-edge working resolution "
                    "(reference default 224)")
    import_as: bpy.props.EnumProperty(
        name="Import as",
        items=[("VERTS", "Vertices", "One mesh vertex per point"),
               ("DUPLI", "DupliVerts", "Tetrahedron per point"),
               ("POINT_CLOUD", "Point cloud", "Vertices + point-cloud "
                "viewport display")],
        default="VERTS")
    dupli_size: bpy.props.FloatProperty(
        name="Dupli size", default=0.003, min=1e-5)
    make_material: bpy.props.BoolProperty(name="Make material", default=True)


class STARSTER_TORCH_OT_ReconstructConfirm(bpy.types.Operator):
    """Confirmation dialog before the (long) reconstruction."""

    bl_idname = "starster_torch.reconstruct_confirm"
    bl_label = "Reconstruct scene (PyTorch/CUDA)?"

    def invoke(self, context, event):
        return context.window_manager.invoke_props_dialog(self)

    def draw(self, context):
        self.layout.label(
            text="Runs reconstruction in a background process; "
                 "may take a few minutes.")

    def execute(self, context):
        return bpy.ops.starster_torch.reconstruct()


class STARSTER_TORCH_OT_Reconstruct(bpy.types.Operator):
    """Run the port's CLI and import the result."""

    bl_idname = "starster_torch.reconstruct"
    bl_label = "Starst3r reconstruct (PyTorch/CUDA)"

    def execute(self, context):
        props = context.scene.starster_torch
        err = self._verify(props)
        if err:
            self.report({"ERROR"}, err)
            return {"CANCELLED"}
        out = tempfile.mkdtemp(prefix="starster_torch_blender_")
        cmd = command.build_command(
            bpy.path.abspath(props.python_path),
            bpy.path.abspath(props.directory), out, props.resolution,
            props.preset, props.device,
            bpy.path.abspath(props.model_path) if props.model_path else "")
        try:
            res = command.run(cmd)
        except Exception as e:  # noqa: BLE001
            self.report({"ERROR"}, f"failed to launch CLI: {e}")
            return {"CANCELLED"}
        if res.returncode != 0:
            self.report({"ERROR"},
                        f"reconstruction failed: {res.stderr[-400:]}")
            return {"CANCELLED"}
        importer.import_result(out, props)
        self.report({"INFO"}, f"imported reconstruction from {out}")
        return {"FINISHED"}

    @staticmethod
    def _verify(props):
        model = bpy.path.abspath(props.model_path) if props.model_path \
            else ""
        return command.verify(bpy.path.abspath(props.directory), model)


class STARSTER_TORCH_PT_Panel(bpy.types.Panel):
    """N-panel."""

    bl_idname = "STARSTER_TORCH_PT_Panel"
    bl_label = "Starst3r (PyTorch/CUDA)"
    bl_space_type = "VIEW_3D"
    bl_region_type = "UI"
    bl_category = "Starst3r Torch"

    def draw(self, context):
        layout = self.layout
        props = context.scene.starster_torch
        for name in ("python_path", "device", "model_path", "preset",
                     "directory", "resolution", "import_as", "dupli_size",
                     "make_material"):
            layout.prop(props, name)
        layout.operator("starster_torch.reconstruct_confirm",
                        text="Reconstruct")


_CLASSES = (StarsterTorchProps, STARSTER_TORCH_OT_ReconstructConfirm,
            STARSTER_TORCH_OT_Reconstruct, STARSTER_TORCH_PT_Panel)


def register():
    for c in _CLASSES:
        bpy.utils.register_class(c)
    bpy.types.Scene.starster_torch = bpy.props.PointerProperty(
        type=StarsterTorchProps)


def unregister():
    del bpy.types.Scene.starster_torch
    for c in reversed(_CLASSES):
        bpy.utils.unregister_class(c)
