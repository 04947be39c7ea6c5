"""The PyTorch port stands alone: no module of ``renderengine_tpu_torch``
and nothing in ``chip_smoke.py`` imports JAX or the JAX package, and the
entry points refuse to fall back to the CPU when CUDA is absent."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
import renderengine_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "renderengine_tpu" or m.startswith("renderengine_tpu."))
print(len(names))
print(",".join(bad))
print(",".join(names))
"""

# the modules of the second slice (shadows, sky, translucency), the
# third (texture-space shading), the fifth (the apps and the runtime
# under them), the sixth (the sharded renderer) and the seventh (the
# captured frame program)
SLICE_MODULES = ("shading.shadow", "shading.fitting", "shading.skybox",
                 "shading.sampling", "graph.frame", "raster.cuda_raster",
                 "tools.goldens", "tools.profile_frame", "shading.lightchart",
                 "scene.scene",
                 "core.args", "core.asset_path", "core.engine",
                 "graph.render_loop", "utils.log", "utils.profiling",
                 "utils.hud", "utils.image", "utils.exr", "native",
                 "scene.input", "scene.camera_controller", "scene.loader",
                 "scene.loader_obj", "scene.loader_gltf", "scene.loader_dae",
                 "scene.loader_fbx", "shading.grid", "shading.textured_quad",
                 "shading.ibl", "apps.main_sample", "apps.live_viewer",
                 "apps.project", "apps.editor", "parallel",
                 "parallel.sharded", "tools.sharded_run", "graph.program",
                 "tools.sync_sites")


def test_port_modules_import_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n_mods, bad, names = out.stdout.rstrip("\n").split("\n")
    assert int(n_mods) >= 50, "module walk found too few port modules"
    assert bad == "", f"port pulled in {bad}"
    for m in SLICE_MODULES:
        assert f"renderengine_tpu_torch.{m}" in names.split(","), m


def _imported_modules(path: Path) -> set:
    tree = ast.parse(path.read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module)
    return mods


@pytest.mark.parametrize("path", ["chip_smoke.py", "bench_torch.py"] + sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "renderengine_tpu_torch").rglob(
        "*.py")))
def test_no_jax_import_statement(path):
    for mod in _imported_modules(ROOT / path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "renderengine_tpu"), (
            f"{path} imports {mod}")


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, where):
    """Without CUDA (and alone, without the package) the smoke test exits
    non-zero and prints no result line."""
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_frame_renderer_without_cuda_raises(monkeypatch):
    from renderengine_tpu_torch.core.config import RenderConfig
    from renderengine_tpu_torch.graph.frame import FrameRenderer
    from renderengine_tpu_torch.scene import procedural

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc = procedural.cube_scene(width=32, height=24)
    cfg = RenderConfig(width=32, height=24, shadows=False, skybox=False,
                       translucency=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FrameRenderer(sc, cfg)


def test_non_cpu_tensor_never_takes_the_plain_path():
    """Only a CPU tensor runs K1's plain version; any other tensor goes to
    the kernel's checks (and, off a CUDA device, is refused)."""
    from renderengine_tpu_torch.raster import cuda_raster

    pd = torch.zeros((4, 44), device="meta")
    st = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_raster.raster_tiles(pd, st, st, 1, 32, 8, n_attrs=8)
    bounds = torch.zeros((1, 2, 256), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_raster.raster_tiles(pd, st, st, 1, 32, 8, n_attrs=8,
                                 bounds=bounds, tile_map=st, dual=True)
    p32 = torch.zeros((4, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_raster.raster_tiles(p32, st, st, 1, 32, 8, n_attrs=4)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_raster.merged_tiles(p32, st, st, p32, st, st, 1, 32, 8,
                                 n_attrs_b=2)


def test_tss_frame_renderer_without_cuda_raises(monkeypatch):
    """The texture-space entry point defaults to the card as well."""
    from renderengine_tpu_torch.core.config import RenderConfig
    from renderengine_tpu_torch.graph.frame import FrameRenderer
    from renderengine_tpu_torch.scene import procedural

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = RenderConfig(width=32, height=24, debug_views=False,
                       texture_space=True, tss_preshaded_blend=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FrameRenderer(procedural.cube_scene(width=32, height=24), cfg)
