import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from portbench import checks, harness

HERE = Path(__file__).resolve().parents[1]
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())


def test_every_cell_config_traffic_and_metric_loads_by_name():
    for w in BENCH["workloads"]:
        spec = harness.load_cell(w["name"])
        assert spec["config"]["name"] == w["config"]
        assert spec["traffic"]["name"] == w["traffic"]
        assert spec["config"]["render_config"]["width"] == 1920
    for m in BENCH["per_layer"]:
        mod = harness.load_module("metrics", m["name"])
        assert callable(mod.read)
    for c in BENCH["configs"]:
        cfg = json.loads((HERE.parent / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in
               harness.cell_metrics(BENCH, w["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(BENCH, w["name"], "per_layer")


def _drop_in(tmp_path, monkeypatch):
    """A copy of the benchmark's data in ``tmp_path`` with a new traffic
    mix (a keyframed walk, shadows re-rendered every third frame, its own
    settling), a new cell and a new metric added as files and entries:
    the harness points at the copy, no module changes."""
    pb = tmp_path / "portbench"
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(HERE / d, pb / d)
    walk = {"name": "walk", "camera": "keyframes", "frames_per_key": 5,
            "keys": [{"eye": [-12, 3, 0], "look_at": [0, 2, 0]},
                     {"eye": [-12, 3, 3], "look_at": [0, 2, 1]},
                     {"eye": [-8, 4, -2], "look_at": [0, 2, 0]}],
            "shadows_dirty_every": 3, "settle_frames": 7, "why": "test"}
    (pb / "traffic" / "walk.json").write_text(json.dumps(walk))
    (pb / "metrics" / "new.frames.py").write_text(
        "def read(readings):\n    return readings['window']['presented']\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "tss.walk",
                               "config": "sponza1080_tss",
                               "traffic": "walk", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "new.frames", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "render loop and entry point",
                               "moves": "frame_ms",
                               "workloads": ["tss.walk"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(harness, "HERE", pb)
    monkeypatch.setattr(harness, "ROOT", tmp_path)


def test_a_cell_and_a_metric_added_as_files_are_found(tmp_path,
                                                      monkeypatch):
    _drop_in(tmp_path, monkeypatch)
    spec = harness.load_cell("tss.walk")
    assert spec["traffic"]["camera"] == "keyframes"
    names = [m["name"] for m in
             harness.cell_metrics(spec["bench"], "tss.walk", "per_layer")]
    assert "new.frames" in names and "shadow.device_ms" not in names
    mod = harness.load_module("metrics", "new.frames")
    assert mod.read({"window": {"presented": 7}}) == 7


def test_a_traffic_mix_added_as_a_file_runs(tmp_path, monkeypatch):
    """A whole run of the new cell on the CPU at a tiny size: its poses,
    its shadow-dirty frames and its settling come from the file alone,
    and the reference follows them."""
    _drop_in(tmp_path, monkeypatch)
    harness.set_cache_env()
    out = harness.run("tss.walk", 2**31 + 7, 1.0, False, device="cpu",
                      require_card=False,
                      scene_overrides=dict(width=96, height=64,
                                           n_textures=16, target_tris=3000),
                      config_overrides=dict(width=96, height=64,
                                            shadow_extent=96))
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0


LAMP = (-6.0, 2.5, 1.5)
# a builder of the reference added as a file: the benchmark's scene with
# one more point lamp at ``%r``, casting cube shadows
REF_LAMP_SCENE = '''"""sponza_scene with a point lamp casting cube shadows (a test
scene)."""
import numpy as np

from portbench.reference.scene import procedural
from portbench.reference.scene.lights import Light, LightType


def build(seed, **scene):
    sc = procedural.sponza_scene(seed=seed, **scene)
    lamp = sc.lights.add_light(Light(
        type=LightType.POINT, color=np.array([0.6, 0.8, 1.0], np.float32),
        position=np.array(%r, np.float32), intensity=60.0,
        falloff_radius=10.0))
    sc.create_shadow_map(lamp)
    return sc
'''


def _port_lamp_scene(seed, **scene):
    """The port's twin of ``REF_LAMP_SCENE``."""
    from renderengine_tpu_torch.scene import procedural
    from renderengine_tpu_torch.scene.lights import Light, LightType

    sc = procedural.sponza_scene(seed=seed, **scene)
    lamp = sc.lights.add_light(Light(
        type=LightType.POINT, color=np.array([0.6, 0.8, 1.0], np.float32),
        position=np.array(LAMP, np.float32), intensity=60.0,
        falloff_radius=10.0))
    sc.create_shadow_map(lamp)
    return sc


def _drop_in_scene(tmp_path, monkeypatch, builder="sponza_lamp_scene",
                   ref_lamp=LAMP, port_twin=True):
    """``_drop_in`` plus a supersampled configuration (``ssaa: 2`` on the
    texture-space headline) whose scene builder the reference finds only
    as the file ``reference/scenes/<builder>.py`` (its lamp at
    ``ref_lamp``); the port's twin is patched into its ``procedural``."""
    from renderengine_tpu_torch.scene import procedural

    _drop_in(tmp_path, monkeypatch)
    pb = tmp_path / "portbench"
    cfg = json.loads((HERE / "configs" / "sponza1080_tss.json").read_text())
    cfg["name"] = "lamp_ssaa2"
    cfg["scene"]["builder"] = builder
    cfg["render_config"]["ssaa"] = 2
    cfg["settle_frames"] = 6
    (pb / "configs" / "lamp_ssaa2.json").write_text(json.dumps(cfg))
    scenes = pb / "reference" / "scenes"
    scenes.mkdir(parents=True)
    (scenes / f"{builder}.py").write_text(REF_LAMP_SCENE % (ref_lamp,))
    if port_twin:
        monkeypatch.setattr(procedural, builder, _port_lamp_scene,
                            raising=False)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "lamp_ssaa2", "source": "test",
                             "file": "portbench/configs/lamp_ssaa2.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "lamp_ssaa2.orbit",
                               "config": "lamp_ssaa2", "traffic": "orbit",
                               "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))


def _half_left_out(cell):
    """A fault: the lower half of each frame's rows not rendered."""
    render = cell.r.render

    def faulty(view_props=None):
        img, st = render(view_props)
        img = img.clone()
        img[img.shape[0] // 2:] = 0
        return img, st
    cell.r.render = faulty


@pytest.mark.parametrize("case", ["sound", "half_left_out", "light_moved"])
def test_a_supersampled_scene_added_as_files_runs(tmp_path, monkeypatch,
                                                  case):
    """A whole CPU run of a configuration with ``ssaa: 2`` whose builder
    the reference finds as a file: correct, its raster passes counted at
    the supersampled extent; with half of each frame left out, or with
    the reference's copy of the builder moving the lamp, not correct."""
    _drop_in_scene(tmp_path, monkeypatch, ref_lamp=(
        (LAMP[0], LAMP[1], LAMP[2] + 1.0) if case == "light_moved"
        else LAMP))
    counts = []
    compare = checks.compare

    def counted(**kw):
        # the pass counts of the first compared frame's pose, as a traced
        # run counts its profiled poses
        out = compare(**dict(kw, count_poses=sorted(kw["kept"])[:1]))
        counts.extend(out["pass_counts"])
        return out
    monkeypatch.setattr(checks, "compare", counted)
    harness.set_cache_env()
    out = harness.run("lamp_ssaa2.orbit", 2**31 + 7, 1.0, False,
                      device="cpu", require_card=False,
                      fault=_half_left_out if case == "half_left_out"
                      else None,
                      scene_overrides=dict(width=96, height=64,
                                           n_textures=16, target_tris=3000),
                      config_overrides=dict(width=96, height=64,
                                            shadow_extent=96))
    assert out["checks"]["inputs_differ"]["value"] == int(
        case == "light_moved")
    assert out["correct"] == (case == "sound"), out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert counts[0]["pixels"] == 4 * 96 * 64


@pytest.mark.parametrize("where", ["nowhere", "reference_only"])
def test_an_unknown_builder_is_refused_before_the_window(tmp_path,
                                                         monkeypatch,
                                                         where):
    """A builder that neither the reference's ``procedural`` nor a file
    of ``reference/scenes/`` holds, or that the port lacks, is a
    ``CellError`` before the window opens."""
    _drop_in_scene(tmp_path, monkeypatch, builder="no_such_scene",
                   port_twin=False)
    if where == "nowhere":
        (tmp_path / "portbench" / "reference" / "scenes"
         / "no_such_scene.py").unlink()

    def window(self, seconds):
        raise AssertionError("the window opened")
    monkeypatch.setattr(harness.Cell, "window", window)
    with pytest.raises(harness.CellError, match="no_such_scene"):
        harness.run("lamp_ssaa2.orbit", 3, 1.0, False, device="cpu",
                    require_card=False)
