import json
import shutil
from pathlib import Path

from portbench import harness

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
