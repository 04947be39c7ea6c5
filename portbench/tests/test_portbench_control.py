"""The comparison that decides ``correct`` fails where it should: the
control (the reference in bfloat16) and faults planted in the timed path
of a whole run, driven on the CPU at a tiny size."""

import numpy as np
import pytest
import torch

from portbench import checks, harness

SMALL = dict(scene_overrides=dict(width=96, height=64, n_textures=16,
                                  target_tris=3000),
             config_overrides=dict(width=96, height=64, shadow_extent=96))
SEED = 2**31 + 99


def _run(fault=None, workload="tss.orbit", control=False):
    harness.set_cache_env()
    return harness.run(workload, SEED, 1.0, False, device="cpu",
                       require_card=False, control=control, fault=fault,
                       settle_frames=24, **SMALL)


def _wrap(transform):
    """A fault: ``transform(img, state)`` rewrites each frame the
    renderer produces."""
    def plant(cell):
        render = cell.r.render
        state = {}

        def faulty(view_props=None):
            img, st = render(view_props)
            return transform(img, state), st
        cell.r.render = faulty
    return plant


def _stale(img, state):
    """A step that returns its state unchanged: the first frame again."""
    state.setdefault("first", img.clone())
    return state["first"]


def _half(img, state):
    """Half of the work left out: the lower half of the rows not
    rendered."""
    out = img.clone()
    out[img.shape[0] // 2:] = 0
    return out


def _altered(img, state):
    """An answer altered where it is produced: a band of pixels
    inverted."""
    out = img.clone()
    out[:, : img.shape[1] // 8, :3] = 255 - out[:, : img.shape[1] // 8, :3]
    return out


def _control(cell):
    """The control in the program's place: every frame of the window is
    the reference's frame at its pose in bfloat16."""
    from portbench.reference.graph.frame import ReferenceRenderer
    from portbench.reference.scene.camera import ViewProperties

    scene = checks.reference_builder(cell.builder)(seed=SEED,
                                                   **cell.scene_kw)
    cam = scene.camera
    eye0 = np.asarray(cam.eye, np.float32).copy()
    look0 = np.asarray(cam.look_at, np.float32).copy()
    rcfg = checks.reference_config(cell.cfg_fields)
    rr = ReferenceRenderer(scene, rcfg, "cpu")
    fit0 = rr.shadow_fit()
    render = cell.r.render

    def lowp(view_props=None):
        img, st = render(view_props)
        if cell.rec.on:
            i = cell.rec.i - 1          # the pose this call was handed
            fit = checks.shadow_fit(rr, cell.sched, cam, eye0, look0, i,
                                    fit0)
            cell.sched.apply(cam, eye0, look0, i)
            img = rr.render(ViewProperties.from_camera(cam), rcfg, fit,
                            lowp=True)[0]
        return img, st
    cell.r.render = lowp


def test_a_sound_run_is_correct_and_its_control_readings_are_not():
    out = _run(control=True)
    assert out["correct"], out["checks"]
    lim = checks.LIMITS["frame_off_gt1"]
    assert out["checks"]["frame_off_gt1"]["value"] <= lim
    assert out["control"]["frame_off_gt1"] > 3 * lim
    assert out["failed"] == 0 and out["attempted"] > 3


def test_the_control_in_the_programs_place_is_not_correct():
    out = _run(fault=_control)
    assert not out["correct"], out["checks"]
    assert out["checks"]["frame_off_gt1"]["value"] > \
        checks.LIMITS["frame_off_gt1"]


@pytest.mark.parametrize("fault", [_stale, _half, _altered],
                         ids=["state_unchanged", "half_left_out",
                              "answer_altered"])
def test_a_fault_in_the_timed_path_is_not_correct(fault):
    out = _run(fault=_wrap(fault))
    assert not out["correct"], out["checks"]


def test_a_frame_with_dropped_work_is_not_correct():
    def drop(cell):
        render = cell.r.render

        def faulty(view_props=None):
            img, st = render(view_props)
            st = dict(st, pair_overflow=torch.ones((), dtype=torch.int64))
            return img, st
        cell.r.render = faulty
    out = _run(fault=drop, workload="pp.orbit")
    assert not out["correct"]
    assert out["checks"]["overflow_share"]["value"] == 1.0
    assert out["failed"] == out["attempted"]


def test_off_share_counts_bytes_off_by_more_than_one():
    a = np.zeros((2, 2, 4), np.uint8)
    b = a.copy()
    b[0, 0, 0] = 1
    b[0, 1, 1] = 2
    assert checks.off_share(a, b) == pytest.approx(1 / 16)
