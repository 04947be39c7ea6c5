import subprocess
import sys
from pathlib import Path

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "renderengine_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert "renderengine_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "renderengine_tpu.fake", object())
    assert "renderengine_tpu" in harness.forbidden_modules()


def test_nothing_the_benchmark_loads_is_jax_or_the_jax_package():
    """Import every module of the benchmark and the port's modules a run
    loads, in a fresh interpreter, and list the top-level names."""
    code = """
import sys
sys.path.insert(0, %r)
from portbench import harness, checks, trace, schedule, stats, peaks
from portbench.reference.graph import frame
from portbench.reference.scene import procedural
from renderengine_tpu_torch.graph.render_loop import RenderLoop
from renderengine_tpu_torch.scene import procedural as p2
from renderengine_tpu_torch.tools import profile_frame
import json
for kind in ("metrics", "kernels"):
    import pathlib
    for f in sorted((pathlib.Path(%r) / "portbench" / kind).glob("*.py")):
        if f.name != "__init__.py":
            harness.load_module(kind, f.stem)
print(sorted({m.split(".")[0] for m in sys.modules}))
print(harness.forbidden_modules())
""" % (str(ROOT), str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr[-2000:]
    tops, bad = res.stdout.strip().splitlines()[-2:]
    assert bad == "[]", tops
    assert "'renderengine_tpu_torch'" in tops
