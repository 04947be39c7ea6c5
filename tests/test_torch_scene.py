"""The port's own copies of the scene modules produce the JAX package's
device dict exactly, key by key, and ``scene_to_device`` carries it onto a
torch device without changing a bit."""

import numpy as np
import pytest
import torch

import golden_configs
from renderengine_tpu.scene import procedural as jproc
from renderengine_tpu_torch.graph.frame import scene_to_device
from renderengine_tpu_torch.scene import procedural as tproc
from renderengine_tpu_torch.tools import goldens as tgold

torch.set_num_threads(2)

_JAX_CASES = {n: f for n, f, _ in golden_configs.golden_cases()}
_TORCH_CASES = {n: f for n, f, _ in tgold.golden_cases()}
NAMES = ["cube_phong", "multimesh_opaque", "bindless_textures", "normal_orm"]


def _pair(name):
    if name == "small_sponza":
        kw = dict(width=96, height=64, n_textures=12, target_tris=3_000)
        return jproc.sponza_scene(**kw), tproc.sponza_scene(**kw)
    return _JAX_CASES[name](), _TORCH_CASES[name]()


def _assert_same_dict(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype, k
        assert x.shape == y.shape, k
        assert np.array_equal(x, y), k


@pytest.mark.parametrize("name", NAMES + ["small_sponza"])
def test_upload_equals_jax_exactly(name):
    js, ts = _pair(name)
    _assert_same_dict(js.upload(), ts.upload())


def test_scene_to_device_round_trips_exactly():
    dev_np = tproc.sponza_scene(width=64, height=48, n_textures=8,
                                target_tris=1_500).upload()
    dev = scene_to_device(dev_np, "cpu")
    assert sorted(dev) == sorted(dev_np)
    for k, v in dev_np.items():
        v = np.asarray(v)
        t = dev[k].numpy()
        if v.dtype == np.uint32:
            assert dev[k].dtype == torch.int32, k
            t = t.view(np.uint32)
        assert t.dtype == v.dtype and np.array_equal(t, v), k


def test_int32_views_unpack_u32_words():
    """Arithmetic shift + mask is exact on the int32 view of a u32 word."""
    words = np.array([0x80FF0102, 0xFFFFFFFF, 0x7F000080, 0], np.uint32)
    t = torch.from_numpy(words.view(np.int32))
    for s in (0, 8, 16, 24):
        got = ((t >> s) & 255).numpy()
        np.testing.assert_array_equal(got, (words >> s) & 255)
    for s in (0, 16):
        got = ((t >> s) & 0xFFFF).numpy()
        np.testing.assert_array_equal(got, (words >> s) & 0xFFFF)


def test_chart_subdivision_waits_for_its_slice():
    """The texture-space slice has landed: ``upload(chart_subdiv=...)``
    subdivides the large triangles exactly as the JAX package does (the
    cube's faces at a density that splits them)."""
    from renderengine_tpu_torch.scene.camera import ViewProperties

    jsc, tsc = (m.cube_scene(width=32, height=24) for m in (jproc, tproc))
    vp = ViewProperties.from_camera(tsc.camera)
    sub = dict(viewproj=np.asarray(vp.proj) @ np.asarray(vp.view), width=32,
               height=24, density=16.0)
    out = tsc.upload(chart_subdiv=sub)
    assert int(out["n_tris"]) > int(tsc.upload()["n_tris"])
    _assert_same_dict(jsc.upload(chart_subdiv=sub), out)
