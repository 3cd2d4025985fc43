"""The Blender add-on for the port (`blender_addon_torch/`), outside Blender:
`bpy` is stubbed in `sys.modules` (it is never installed).

  - `command.build_command`'s argv for every preset, with and without a
    model, on cuda and cpu; unknown presets and devices refused;
  - the checks made before a run (`command.verify`, the operator's
    `_verify`) and their messages;
  - the add-on's ids (operators, panel, scene property, `bl_info` name)
    differ from the JAX add-on's, by an AST scan of both;
  - the package imports outside Blender, as `blender_addon/` does;
  - the operator's `execute` with the stub runs the command it builds for
    real: `python -m starst3r_tpu_torch --device cpu reconstruct --preset
    tiny` on three 48 x 64 PNGs at resolution 48, with the CLI's default
    GA (500 + 200 steps; ~7 s on one CPU thread), then imports the result:
    the mesh gets points.ply's points, one camera per pose of c2w.npy
    (3, 4, 4).
"""

import ast
import importlib
import os
import sys
import tempfile
import types
from unittest import mock

import numpy as np
import pytest
from PIL import Image
from torch_threads import one_torch_thread  # noqa: F401

from starst3r_tpu_torch.io.ply import load_ply

from blender_addon_torch import command

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("preset", ["tiny", "small", "base", "large"])
@pytest.mark.parametrize("model", ["", "/m/model.npz"])
def test_build_command(device, preset, model):
    cmd = command.build_command("/usr/bin/python3", "/imgs", "/out", 224,
                                preset, device, model)
    want = ["/usr/bin/python3", "-m", "starst3r_tpu_torch", "--device",
            device, "reconstruct", "--imgdir", "/imgs", "--out", "/out",
            "--res", "224", "--preset", preset]
    assert cmd == want + (["--model", model] if model else [])


def test_build_command_refuses_unknown_values():
    with pytest.raises(ValueError, match="preset"):
        command.build_command("python3", "/i", "/o", 224, "huge", "cuda")
    with pytest.raises(ValueError, match="device"):
        command.build_command("python3", "/i", "/o", 224, "tiny", "tpu")


def _pngs(d, n, size=(48, 64)):
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, size + (3,)).astype(
            np.uint8)).save(os.path.join(d, f"view_{i}.png"))
    return d


def test_verify_messages(tmp_path):
    assert command.verify(str(tmp_path / "nope")) == \
        "image directory does not exist"
    assert command.verify("") == "image directory does not exist"
    one = _pngs(str(tmp_path / "one"), 1)
    assert command.verify(one) == "need at least two jpg/png images"
    two = _pngs(str(tmp_path / "two"), 2)
    (tmp_path / "two" / "notes.txt").write_text("not an image")
    assert command.verify(two) is None
    assert command.verify(two, str(tmp_path / "missing.npz")) == \
        "model checkpoint not found"
    (tmp_path / "m.npz").write_bytes(b"")
    assert command.verify(two, str(tmp_path / "m.npz")) is None


def _ids(folder):
    """Operator and panel ids, class names, Scene properties and the
    bl_info name an add-on folder defines, by AST."""
    ids = set()
    for name in ("__init__.py", "interface.py"):
        with open(os.path.join(ROOT, folder, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                ids.add(("class", node.name))
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name) and t.id == "bl_idname":
                        ids.add(("bl_idname", node.value.value))
                    if isinstance(t, ast.Attribute) and isinstance(
                            t.value, ast.Attribute) and t.value.attr == \
                            "Scene":
                        ids.add(("scene", t.attr))
                    if isinstance(t, ast.Name) and t.id == "bl_info":
                        info = ast.literal_eval(node.value)
                        ids.add(("bl_info", info["name"]))
    return ids


def test_ids_differ_from_the_jax_addon():
    jax_ids, port_ids = _ids("blender_addon"), _ids("blender_addon_torch")
    for kind in ("class", "bl_idname", "scene", "bl_info"):
        assert any(k == kind for k, _ in port_ids), kind
    assert jax_ids & port_ids == set()
    assert ("bl_idname", "starster_torch.reconstruct") in port_ids
    assert ("scene", "starster_torch") in port_ids


def test_imports_outside_blender():
    assert "bpy" not in sys.modules
    pkg = importlib.import_module("blender_addon_torch")
    assert pkg.bl_info["name"] != importlib.import_module(
        "blender_addon").bl_info["name"]
    with pytest.raises(RuntimeError, match="bpy"):
        pkg.register()


class _Operator:
    def report(self, level, message):
        self.reports = getattr(self, "reports", []) + [(level, message)]


def _prop(**kw):
    return ("prop", kw)


@pytest.fixture
def addon(monkeypatch):
    """The add-on's interface and importer, imported against a stub bpy
    (and bmesh); removed from sys.modules afterwards."""
    bpy = types.ModuleType("bpy")
    bpy.types = types.SimpleNamespace(
        Operator=_Operator, PropertyGroup=object, Panel=object,
        Scene=types.SimpleNamespace())
    bpy.props = types.SimpleNamespace(
        StringProperty=_prop, EnumProperty=_prop, IntProperty=_prop,
        FloatProperty=_prop, BoolProperty=_prop, PointerProperty=_prop)
    bpy.path = types.SimpleNamespace(abspath=lambda p: p)
    bpy.utils = mock.MagicMock()
    bpy.data = mock.MagicMock()
    bpy.context = mock.MagicMock()
    bpy.ops = mock.MagicMock()
    monkeypatch.setitem(sys.modules, "bpy", bpy)
    monkeypatch.setitem(sys.modules, "bmesh", types.ModuleType("bmesh"))
    pkg = importlib.import_module("blender_addon_torch")

    def forget():     # both the module and the package's attribute
        for name in ("interface", "importer"):
            sys.modules.pop(f"{pkg.__name__}.{name}", None)
            if hasattr(pkg, name):
                delattr(pkg, name)

    forget()
    yield bpy, importlib.import_module("blender_addon_torch.interface")
    forget()


def _props(directory, **kw):
    base = dict(python_path=sys.executable, device="cpu", model_path="",
                preset="tiny", directory=directory, resolution=48,
                import_as="VERTS", dupli_size=0.003, make_material=True)
    return types.SimpleNamespace(**{**base, **kw})


def test_register_and_panel(addon):
    bpy, interface = addon
    interface.register()
    assert bpy.utils.register_class.call_count == 4
    assert bpy.types.Scene.starster_torch[0] == "prop"
    ann = interface.StarsterTorchProps.__annotations__
    assert ann["device"][1]["default"] == "cuda"
    assert [i[0] for i in ann["device"][1]["items"]] == ["cuda", "cpu"]
    assert [i[0] for i in ann["preset"][1]["items"]] == list(command.PRESETS)
    interface.unregister()
    assert not hasattr(bpy.types.Scene, "starster_torch")


def test_operator_refuses_bad_inputs(addon, tmp_path):
    _, interface = addon
    op = interface.STARSTER_TORCH_OT_Reconstruct()
    scene = types.SimpleNamespace(starster_torch=_props(
        str(tmp_path / "nope")))
    assert op.execute(types.SimpleNamespace(scene=scene)) == {"CANCELLED"}
    assert op.reports == [({"ERROR"}, "image directory does not exist")]
    imgs = _pngs(str(tmp_path / "imgs"), 2)
    props = _props(imgs, model_path=str(tmp_path / "missing.npz"))
    assert op._verify(props) == "model checkpoint not found"


def test_operator_runs_the_cli_and_imports(addon, tmp_path, monkeypatch):
    bpy, interface = addon
    imgs = _pngs(str(tmp_path / "imgs"), 3)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    ran = []
    real_run = command.run
    monkeypatch.setattr(command, "run",
                        lambda cmd, **kw: ran.append(cmd) or real_run(cmd))
    op = interface.STARSTER_TORCH_OT_Reconstruct()
    scene = types.SimpleNamespace(starster_torch=_props(imgs))
    assert op.execute(types.SimpleNamespace(scene=scene)) == {"FINISHED"}, \
        op.reports
    (cmd,) = ran
    out = cmd[cmd.index("--out") + 1]
    assert os.path.dirname(out) == str(tmp_path)
    assert cmd == command.build_command(sys.executable, imgs, out, 48,
                                        "tiny", "cpu")
    pts, cols, c2w = command.read_result(out)
    want_pts, want_cols = load_ply(os.path.join(out, "points.ply"))
    np.testing.assert_array_equal(pts, want_pts)
    np.testing.assert_array_equal(np.round(cols * 255), want_cols)
    assert c2w.shape == (3, 4, 4) and np.isfinite(c2w).all()
    mesh = bpy.data.meshes.new.return_value
    (args, _), = mesh.from_pydata.call_args_list
    np.testing.assert_array_equal(np.asarray(args[0], np.float32), want_pts)
    assert bpy.data.cameras.new.call_count == 3
    assert op.reports[-1][0] == {"INFO"}
