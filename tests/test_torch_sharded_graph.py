"""The sharded renderer's frame as a captured program would run it, on
the CPU in a one-rank gloo group in this process: a warm ``render()``
reads no device data on the host (the guard of ``test_torch_graph.py``;
the uniform's blocking upload was one such read), the re-bakes of an
exposure change and of ``mark_shadows_dirty()`` write into the tables the
frame reads (views included), and each such frame equals a fresh
``FrameRenderer``'s frame byte for byte. Over gloo the renderer stays
eager; the NCCL gather's layout is held here with a stand-in collective,
and the captured programs on the card (``tests/test_torch_gpu.py``)."""

import pytest
import torch
import torch.distributed as dist

from renderengine_tpu_torch.graph.frame import FrameRenderer
from renderengine_tpu_torch.parallel import sharded
from renderengine_tpu_torch.scene.camera import ViewProperties

from test_torch_graph import CONFIGS, _sponza, guard  # noqa: F401

torch.set_num_threads(2)


@pytest.fixture
def mesh(tmp_path):
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
        world_size=1, rank=0)
    try:
        yield sharded.make_mesh(1, device="cpu")
    finally:
        dist.destroy_process_group()


def _pair(name, mesh):
    """A fresh ``FrameRenderer`` and the sharded renderer at its budgets."""
    sc = _sponza()
    r = FrameRenderer(sc, CONFIGS[name], device="cpu")
    return sc, r, sharded.ShardedRenderer(
        sc, r.config, mesh, shadow_budget=r._shadow_budget_val)


@pytest.mark.parametrize("name", ["per_pixel", "tss_headline"])
def test_warm_sharded_render_reads_nothing_on_the_host(guard, mesh, name):
    """A warm ``ShardedRenderer.render()`` (the uniform's upload, the
    vertex gather, the band, the band gather, the stats' reductions) makes
    no host read outside the kernels' plain versions, and is the single
    card's frame."""
    _, r, sr = _pair(name, mesh)
    for _ in range(2):
        sr.render()
    with guard:
        img, st = sr.render()
    assert not guard.hits, guard.hits
    assert torch.equal(img, r.render()[0])
    assert not any(int(v) for k, v in st.items() if "overflow" in k)


def _ptrs(sr):
    sd = sr.scene_dev
    out = {k: sd[k].data_ptr() for k in ("chart_vis", "chart_ld",
                                         "chart_base")}
    out["local_chart_vis"] = sr._local["chart_vis"].data_ptr()
    out["pack"] = tuple(t.data_ptr() for t in sr.shadow_maps)
    return out


def test_sharded_rebakes_keep_their_storage(mesh):
    """An exposure change (the static tables re-bake) and
    ``mark_shadows_dirty()`` (the maps, the visibility and the tables)
    write into the tensors the frame reads, which a captured band frame
    holds by address: ``_local``'s atlas rows stay a view of
    ``chart_vis``. Each such frame equals a fresh ``FrameRenderer``'s."""
    sc, _, sr = _pair("tss_headline", mesh)
    sr.render()
    before = _ptrs(sr)
    assert before["local_chart_vis"] == before["chart_vis"]
    vp = ViewProperties.from_camera(sc.camera)
    vp.exposure = float(sc.camera.exposure) * 1.5
    bright, _ = sr.render(vp)
    assert _ptrs(sr) == before
    fresh = FrameRenderer(sc, CONFIGS["tss_headline"], device="cpu")
    assert torch.equal(bright, fresh.render(vp)[0])
    sr.mark_shadows_dirty()
    again, _ = sr.render()
    assert _ptrs(sr) == before
    fresh = FrameRenderer(sc, CONFIGS["tss_headline"], device="cpu")
    assert torch.equal(again, fresh.render()[0])
    assert not torch.equal(bright, again)


def test_sharded_program_stats_report_eager_on_gloo(mesh):
    """Over gloo the collectives run on the host: nothing is captured and
    ``program_stats()`` says so."""
    _, _, sr = _pair("per_pixel", mesh)
    sr.render()
    st = sr.program_stats()
    assert (st["mode"], st["transport"]) == ("eager", "gloo")
    assert not any(v for k, v in st.items()
                   if k.endswith(("_captures", "_replays")))
    assert not ({"frame", "shadow", "vis", "tables"} & set(st))


@pytest.mark.parametrize("dim", [0, 1])
def test_nccl_gather_stacks_in_rank_order(monkeypatch, dim):
    """The NCCL gather (one buffer, ranks along dim 0) gives the list
    gather's concatenation along ``dim``: a stand-in collective plays 3
    ranks, each sending its part plus 100 x its rank."""
    world = 3
    t = torch.arange(2 * 4 * 5, dtype=torch.float32).reshape(2, 4, 5)

    def fake(out, src):
        out.copy_(torch.cat([src + 100 * r for r in range(world)]))

    monkeypatch.setattr(sharded, "_gather_into", fake)
    got = sharded._all_gather(t, sharded.Mesh(world, 0, t.device, "nccl"),
                              dim)
    want = torch.cat([t + 100 * r for r in range(world)], dim)
    assert torch.equal(got, want)


class _StandInProgram:
    """A ``CapturedProgram`` that runs its function where the card would
    replay its graph (no capture, no launch record)."""

    def __init__(self, fn, device, stream, key=None):
        self.fn, self.key = fn, key
        self.outputs = fn()

    def replay(self):
        self.outputs = self.fn()
        return self.outputs

    def stats(self):
        return {}


def test_captured_mode_replays_each_program_when_due(mesh, monkeypatch):
    """The NCCL mode's control flow, with stand-in programs and a
    one-rank group whose gathers take the NCCL form: the programs are
    made at init in order (shadow, vis, tables, frame), nothing is made
    after; a dirty frame replays the shadow pass, the visibility and the
    tables, an exposure frame the tables, a warm frame the frame alone;
    every frame is the single card's."""
    from renderengine_tpu_torch.graph import program

    made = []

    class Recorded(_StandInProgram):
        def __init__(self, fn, device, stream, key=None):
            made.append(key)
            super().__init__(fn, device, stream, key)

    monkeypatch.setattr(program, "CapturedProgram", Recorded)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: None)
    nccl = sharded.Mesh(1, 0, mesh.device, "nccl")
    sc = _sponza()
    r = FrameRenderer(sc, CONFIGS["tss_headline"], device="cpu")
    sr = sharded.ShardedRenderer(sc, r.config, nccl,
                                 shadow_budget=r._shadow_budget_val)
    st = sr.program_stats()
    assert (st["mode"], st["transport"]) == ("captured", "nccl")
    assert [st[f"{n}_captures"] for n in ("shadow", "vis", "tables",
                                          "frame")] == [1, 1, 1, 1]
    assert made[-1] == r.config and len(made) == 4

    def replays():
        return {n: sr.program_stats()[f"{n}_replays"]
                for n in ("frame", "shadow", "vis", "tables")}

    vp = ViewProperties.from_camera(sc.camera)
    vp.exposure = float(sc.camera.exposure) * 1.5
    want = {"dirty": dict(frame=1, shadow=1, vis=1, tables=1),
            "warm": dict(frame=1, shadow=0, vis=0, tables=0),
            "exposure": dict(frame=1, shadow=0, vis=0, tables=1)}
    for kind, view, ref in (("dirty", None, r.render()[0]),
                            ("warm", None, r.render()[0]),
                            ("exposure", vp, r.render(vp)[0])):
        before = replays()
        img, _ = sr.render(view)
        after = replays()
        assert {n: after[n] - before[n] for n in after} == want[kind], kind
        assert torch.equal(img, ref), kind
    assert len(made) == 4


def test_sharded_renderer_is_a_frame_renderer_without_a_controller(
        mesh, monkeypatch):
    """``ShardedRenderer`` is ``FrameRenderer`` over a mesh with no budget
    controller: from a config with ``auto_tune_pairs`` no estimator runs,
    the frame program binds the config it was given, the shadow pass's
    budget is the per-triangle default of the padded upload, and frames
    change none of them."""
    from renderengine_tpu_torch.graph import frame as fgraph
    from renderengine_tpu_torch.graph import program

    def refuse(self, *a):
        raise AssertionError("an estimator ran")

    for name in ("_estimate_pair_budget", "_estimate_blend_budgets",
                 "_estimate_shadow_budget"):
        monkeypatch.setattr(FrameRenderer, name, refuse)
    monkeypatch.setattr(program, "CapturedProgram", _StandInProgram)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: None)
    cfg = CONFIGS["tss_headline"]
    assert cfg.raster.auto_tune_pairs
    nccl = sharded.Mesh(1, 0, mesh.device, "nccl")
    sr = sharded.ShardedRenderer(_sponza(), cfg, nccl)
    assert isinstance(sr, FrameRenderer) and not sr._react_overflow
    assert sr.config == cfg and sr._programs.progs["frame"].key == cfg
    n_tris = int(sr.scene_dev["tri_vidx"].shape[0])
    assert sr._shadow_budget_val == fgraph._pair_budget(
        n_tris, cfg.raster.pairs_per_tri)
    for _ in range(2):
        sr.render()
    assert sr.config == cfg and sr.program_counts["frame_captures"] == 1


def test_profiled_sharded_render_leaves_a_record(mesh):
    """Under ``torch.profiler`` a ``ShardedRenderer.render()`` leaves a
    ``profiling.frame_trace()`` record with the host spans of the
    renderer's host side, as ``FrameRenderer.render()`` does; with no
    poll its device ms stay unread."""
    from torch.profiler import ProfilerActivity, profile

    from renderengine_tpu_torch.utils import profiling

    _, _, sr = _pair("per_pixel", mesh)
    with profile(activities=[ProfilerActivity.CPU]):
        sr.render()
    sr.render()
    rec, = profiling.frame_trace()
    assert rec is sr.frame_records[0]
    assert rec["dirty"] and not rec["replayed"] and rec["syncs"] == 1
    assert {"host.shadow_fit", "host.upload",
            "host.shadow_read"} <= set(rec["host_ms"])
    assert "host.queue_stats" not in rec["host_ms"]
    assert rec["device_ms"] is None and sr.host_syncs == 1
