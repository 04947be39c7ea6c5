"""``bench_torch.py``, the port's benchmark: on the CPU at golden scale it
prints one JSON line whose embedded golden gate passes, with both modes'
warm frame times, and refuses to run without a card unless a device is
given."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _run(*args, env=None):
    env = dict(os.environ if env is None else env)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, str(ROOT / "bench_torch.py"),
                           *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)


def test_quick_run_on_the_cpu_prints_one_record_with_the_gate():
    out = _run("--device", "cpu", "--quick", "--width", "128", "--height",
               "96", "--frames", "2")
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    gate = rec["golden_gate"]
    assert gate["pass"] and gate["worst_max_diff"] <= 4
    assert gate["worst_frac_within_1"] >= 0.999
    assert gate["golden_sets"] == ["goldens", "goldens_torch"]
    assert rec["device"] == "cpu" and rec["card"] is None
    assert sorted(rec["modes"]) == ["per_pixel", "tss_headline"]
    for m in rec["modes"].values():
        assert len(m["frame_ms"]) == 2 and m["frame_ms_median"] > 0
        assert m["frame_shape"] == [96, 128, 4]
        assert not any(m["last_frame_counters"].values())
    assert rec["value"] == rec["modes"]["per_pixel"]["frame_ms_median"]


def test_gate_only_and_no_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run("--goldens", "--device", "cpu", env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout)
    assert rec["metric"] == "golden_gate" and rec["value"] == 1.0
    out = _run("--quick", env=env)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    assert out.stdout == ""
