"""``bench_torch.py``, the port's benchmark: on the CPU at a small size it
prints the cumulative record after each mode, the last line the whole
record, whose embedded golden gate passes, with every mode's fixed-pose
frame times, its orbit (settling, timed rounds with frames in flight, the
camera moving) and its config divergence; the device parity check of
``--quick`` passes; ``--budget 0`` skips every mode after the first; and
it refuses to run without a card unless a device is given. The runs pass
``--shadow-extent 64``: the parity check's ``reference`` renderer rasters
its shadow map by brute force, which at ``--quick``'s 256^2 takes most of
a minute a mode on the CPU."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _run(*args, env=None):
    env = dict(os.environ if env is None else env)
    env.pop("PYTHONPATH", None)
    # the suite runs several test files at once: a subprocess spinning up
    # a thread per core would slow every one of them down many times
    env.setdefault("OMP_NUM_THREADS", "2")
    return subprocess.run([sys.executable, str(ROOT / "bench_torch.py"),
                           *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)


def _lines(out):
    assert out.returncode == 0, out.stderr[-3000:]
    return [json.loads(ln) for ln in out.stdout.strip().splitlines()]


def test_quick_run_on_the_cpu_prints_one_record_with_the_gate():
    out = _run("--device", "cpu", "--quick", "--width", "64", "--height",
               "48", "--frames", "2", "--rounds", "2", "--shadow-extent",
               "64")
    lines = _lines(out)
    # one cumulative line after each mode; each holds the modes so far
    assert [list(ln["modes"]) for ln in lines] == [
        ["per_pixel"], ["per_pixel", "tss_headline"],
        ["per_pixel", "tss_headline", "tss_headline_ssaa2"]]
    rec = lines[-1]
    gate = rec["golden_gate"]
    assert gate["pass"] and gate["worst_max_diff"] <= 4
    assert gate["worst_frac_within_1"] >= 0.999
    assert gate["golden_sets"] == ["goldens", "goldens_torch"]
    assert rec["device"] == "cpu" and rec["card"] is None
    for tag, m in rec["modes"].items():
        assert len(m["frame_ms"]) == 2 and m["frame_ms_median"] > 0
        assert m["frame_shape"] == [48, 64, 4]
        assert not any(m["last_frame_counters"].values())
        ssaa = 2 if tag.endswith("ssaa2") else 1
        assert m["ssaa"] == ssaa and m["render_extent"] == [48 * ssaa,
                                                            64 * ssaa]
        o = m["orbit"]
        assert o["fps"] > 0 and len(o["round_ms"]) == 2
        assert o["fps"] == 2 / (min(o["round_ms"]) / 1e3)
        assert 1 <= o["settle_orbits"] <= 4
        assert isinstance(o["settled"], bool)
        assert o["settle_recaptures"] == 0 and o["recaptures_timed"] == 0
        assert not any(o["last_round_counters"].values())
        assert o["frames_0_1_differ"]          # the camera moved
        assert m["parity"]["pass"]
        assert "shadow_extent=64 (reference constant 4096)" in \
            m["config_divergence"]
        assert ("shading=texture-space charts" in m["config_divergence"]) \
            == tag.startswith("tss")
    assert rec["value"] == rec["modes"]["per_pixel"]["frame_ms_median"]


def test_budget_skips_every_mode_after_the_first():
    out = _run("--device", "cpu", "--quick", "--width", "64", "--height",
               "48", "--frames", "2", "--rounds", "1", "--shadow-extent",
               "64", "--texture-space", "--budget", "0")
    rec = _lines(out)[-1]
    assert list(rec["modes"]) == ["tss_headline", "tss_headline_ssaa2"]
    assert rec["modes"]["tss_headline"]["orbit"]["rounds"] == 1
    assert rec["modes"]["tss_headline_ssaa2"]["skipped"].startswith(
        "timeout (")
    assert rec["value"] == rec["modes"]["tss_headline"]["frame_ms_median"]


def test_gate_only_and_no_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run("--goldens", "--device", "cpu", env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout)
    assert rec["metric"] == "golden_gate" and rec["value"] == 1.0
    out = _run("--quick", env=env)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    assert out.stdout == ""
