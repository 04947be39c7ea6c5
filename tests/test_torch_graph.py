"""A warm ``render()`` reads no device data on the host (the CPU guard of
the frame's CUDA graph), and the tensors a captured frame reads keep
their storage.

On the card a warm ``render()`` replays a captured CUDA graph, and a
capture cannot hold a host read: every place where the pass chain reads
tensor data on the host, or builds a tensor from Python data, is a
synchronizing call there (``torch.cuda.set_sync_debug_mode("error")``
raises on it; ``tests/test_torch_gpu.py`` runs that on the card). Here a
``TorchDispatchMode`` fails on the operators that do so. The kernels'
plain versions are exempt: on the card they are kernels.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from renderengine_tpu_torch.core.config import RenderConfig
from renderengine_tpu_torch.graph.frame import FrameRenderer
from renderengine_tpu_torch.raster import cuda_raster
from renderengine_tpu_torch.scene import procedural
from renderengine_tpu_torch.scene.camera import ViewProperties
from renderengine_tpu_torch.shading import lightchart

aten = torch.ops.aten

# operators that read tensor data on the host or size a result from it
_HOST_READS = {aten._local_scalar_dense.default, aten.nonzero.default,
               aten.bincount.default, aten.is_nonzero.default,
               aten.equal.default, aten.masked_select.default,
               # a tensor built from Python data (torch.tensor, a list
               # index, a Python scalar stored through advanced indexing)
               aten.lift_fresh.default}
_INDEXING = {aten.index.Tensor, aten.index_put.default,
             aten.index_put_.default, aten._index_put_impl_.default}


class HostReadGuard(TorchDispatchMode):
    """Records every operator call that would make the host wait on the
    device, with the port's frames of its stack; ``exempt`` > 0 turns the
    guard off (the kernels' plain versions)."""

    def __init__(self):
        super().__init__()
        self.hits = []
        self.exempt = 0

    @staticmethod
    def reads_host(func, args, kwargs) -> bool:
        name = func.__name__
        if func in _HOST_READS or name.startswith("unique") \
                or name.startswith("_unique"):
            return True
        if name.startswith("repeat_interleave"):
            return kwargs.get("output_size") is None
        if func in _INDEXING:
            # a boolean mask index is a nonzero() inside the operator
            return any(i is not None and i.dtype == torch.bool
                       for i in args[1])
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self.exempt and self.reads_host(func, args, kwargs):
            import traceback
            where = [f"{f.filename.rsplit('renderengine_tpu_torch', 1)[-1]}"
                     f":{f.lineno}" for f in traceback.extract_stack()
                     if "renderengine_tpu_torch" in f.filename]
            self.hits.append((str(func), where[-3:]))
        return func(*args, **kwargs)


@pytest.fixture
def guard(monkeypatch):
    g = HostReadGuard()

    def exempt(fn):
        def run(*a, **k):
            g.exempt += 1
            try:
                return fn(*a, **k)
            finally:
                g.exempt -= 1
        return run

    for name in ("_raster_tiles_plain", "_merged_tiles_plain"):
        monkeypatch.setattr(cuda_raster, name,
                            exempt(getattr(cuda_raster, name)))
    return g


@pytest.mark.parametrize("case", ["read_0d_index", "list_index",
                                  "scalar_store", "tensor_from_list",
                                  "mask_index", "nonzero", "item"])
def test_guard_catches_host_reads(guard, case):
    """Each kind of host read the frame had (or could grow) is caught."""
    t = torch.arange(12.0).reshape(3, 4)
    sel = torch.tensor([[0, 1], [1, 2], [2, 3]])
    rows = torch.arange(3)[:, None]
    have = torch.zeros(3, 4, dtype=torch.bool)
    idx = torch.zeros((), dtype=torch.int64)
    ops = {"read_0d_index": lambda: t[idx],
           "list_index": lambda: t[:, [0, 2]],
           "scalar_store": lambda: have.__setitem__((rows, sel), True),
           "tensor_from_list": lambda: torch.tensor([1.0, 2.0]),
           "mask_index": lambda: t[t > 3.0],
           "nonzero": lambda: torch.nonzero(t),
           "item": lambda: t.sum().item()}
    with guard:
        ops[case]()
    assert guard.hits
    # and the forms the frame uses instead read nothing
    guard.hits.clear()
    with guard:
        t.index_select(0, idx.reshape(1))[0]
        have[rows, sel] = torch.ones_like(sel, dtype=torch.bool)
        torch.cat([t[:, 0:1], t[:, 2:3]], 1)
        torch.where(t > 3.0, t, 0.0)
    assert not guard.hits


def _sponza():
    return procedural.sponza_scene(width=128, height=96, n_textures=8,
                                   target_tris=2_000)


_BASE = RenderConfig(width=128, height=96, shadow_extent=256)
_HEADLINE = _BASE.replace(debug_views=False, texture_space=True,
                          tss_preshaded_blend=True, dither_trilinear=True,
                          sky_halfres=True)
CONFIGS = {
    # the default per-pixel config (shadow maps cut for the CPU)
    "per_pixel": _BASE,
    # the apps' per-pixel frame: their maps are >= 1024^2, where the
    # two-stage PCF (penumbra segments) is on
    "per_pixel_penumbra": _BASE.replace(penumbra_tile_budget=8),
    "tss_headline": _HEADLINE,
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_warm_render_reads_nothing_on_the_host(guard, name):
    """A warm ``render()`` (the poll, the uniform upload, the frame and
    the queueing of its counters) makes no host read outside the kernels'
    plain versions."""
    r = FrameRenderer(_sponza(), CONFIGS[name], device="cpu")
    assert r._react_overflow
    for _ in range(2):
        r.render()
    with guard:
        img, st = r.render()
    assert not guard.hits, guard.hits
    assert img.shape == (96, 128, 4)
    assert not any(int(v) for k, v in st.items() if "overflow" in k)


def _storage(r):
    sd = r.scene_dev
    keys = [k for k in ("chart_vis", "chart_ld", "chart_base") if k in sd]
    return ({k: sd[k].data_ptr() for k in keys},
            tuple(t.data_ptr() for t in r._shadow_maps))


@pytest.mark.parametrize("name", ["per_pixel", "tss_headline"])
def test_baked_tables_and_shadow_pack_keep_their_storage(name):
    """An exposure change (TSS: the static tables re-bake) and
    ``mark_shadows_dirty()`` (the maps and, with TSS, the visibility bake
    render again) write into the tensors the frame reads, which a
    captured frame holds by address; each such frame equals a fresh
    renderer's frame byte for byte."""
    sc = _sponza()
    cfg = CONFIGS[name]
    r = FrameRenderer(sc, cfg, device="cpu")
    r.render()
    before = _storage(r)
    if cfg.texture_space:
        assert set(before[0]) == {"chart_vis", "chart_ld", "chart_base"}
    vp = ViewProperties.from_camera(sc.camera)
    vp.exposure = float(sc.camera.exposure) * 1.5
    bright, _ = r.render(vp)
    r.mark_shadows_dirty()
    again, _ = r.render()
    assert _storage(r) == before
    fresh = FrameRenderer(sc, cfg, device="cpu")
    np.testing.assert_array_equal(bright.numpy(), fresh.render(vp)[0].numpy())
    fresh = FrameRenderer(sc, cfg, device="cpu")
    np.testing.assert_array_equal(again.numpy(), fresh.render()[0].numpy())
    if cfg.texture_space:
        assert not np.array_equal(bright.numpy(), again.numpy())


# --- the texture-space bake programs (FrameRenderer.tss_bakes) -------------

def _tables(r):
    return {k: r.scene_dev[k].clone() for k in ("chart_ld", "chart_base")}


@pytest.fixture(scope="module")
def tss_renderer():
    r = FrameRenderer(_sponza(), _HEADLINE, device="cpu")
    r.render()
    return r


def test_bake_programs_read_nothing_on_the_host(guard, tss_renderer):
    """The functions the visibility and table programs capture (the JAX
    ``_vis_fn`` and ``_ld_fn``) make no host read, and they write into the
    tables the frame reads."""
    r = tss_renderer
    bakes = r.tss_bakes(visibility=True)
    assert [name for name, _, _ in bakes] == ["vis", "tables"]
    ptrs = {k: r.scene_dev[k].data_ptr()
            for k in ("chart_vis", "chart_ld", "chart_base")}
    with guard:
        for _, _, fn in bakes:
            assert fn() is None
    assert not guard.hits, guard.hits
    assert ptrs == {k: r.scene_dev[k].data_ptr() for k in ptrs}


def test_table_program_reads_the_exposure_on_the_device(tss_renderer):
    """One table function, built once, bakes the tables of a new exposure
    when only the uniform's device exposure is rewritten (a frozen Python
    float would bake the old ones), byte-equal to the float form."""
    r = tss_renderer
    (_, _, fn), = r.tss_bakes(visibility=False)
    e0 = float(r._u[35])
    fn()
    before = _tables(r)
    for e in (1.5 * e0, 0.25 * e0, e0):
        r._u[35] = e
        fn()
        want = lightchart.static_tables(r.scene_dev, r.config, e)
        for k, v in want.items():
            assert torch.equal(r.scene_dev[k], v), (k, e)
        if e != e0:
            assert not torch.equal(r.scene_dev["chart_base"],
                                   before["chart_base"])
    assert all(torch.equal(r.scene_dev[k], v) for k, v in before.items())


@pytest.mark.parametrize("scale", [1.0, 1.5, 0.3])
def test_tensor_exposure_tables_equal_the_float_form(tss_renderer, scale):
    """``static_tables`` at a 0-d float32 tensor exposure gives the bytes
    of the Python float (``f32(e) * ld``), in every table."""
    r = tss_renderer
    e = float(r.scene_host.camera.exposure) * scale
    got = lightchart.static_tables(r.scene_dev, r.config,
                                   torch.tensor(e, dtype=torch.float32))
    want = lightchart.static_tables(r.scene_dev, r.config, e)
    assert set(got) == {"chart_ld", "chart_base"}
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert torch.equal(got[k], want[k]), k


def test_workspace_of_an_indexless_cuda_device(monkeypatch):
    """A captured program keeps the split walk's workspace tensors
    (``cuda_raster.workspace_tensors``), which the launches file under
    their tensors' device index. A renderer's device is ``cuda`` with no
    index: the lookup must resolve it to the current device, or the
    program keeps nothing and a later growth frees memory its graph still
    launches on."""
    ws = cuda_raster._Workspace(None)
    ws.ints = torch.zeros(8, dtype=torch.int32)
    ws.keys = torch.zeros(4, dtype=torch.int64)
    monkeypatch.setattr(cuda_raster, "_workspaces", {0: ws})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    for dev in ("cuda", torch.device("cuda"), "cuda:0"):
        got = cuda_raster.workspace_tensors(dev)
        assert len(got) == 2 and got[0] is ws.ints and got[1] is ws.keys
    assert cuda_raster.workspace_tensors("cuda:1") == ()
    assert cuda_raster.workspace_tensors("cpu") == ()
