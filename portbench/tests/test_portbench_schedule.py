import json
from pathlib import Path

import numpy as np
import pytest

from portbench import schedule

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"
EYE0 = np.array([-16.0, 3.0, 0.0], np.float32)
LOOK0 = np.array([0.0, 2.0, 0.0], np.float32)
WALK = {"name": "walk", "camera": "keyframes", "frames_per_key": 4,
        "keys": [{"eye": [0, 1, 0], "look_at": [1, 1, 0]},
                 {"eye": [4, 1, 0], "look_at": [5, 1, 0]},
                 {"eye": [4, 1, 4], "look_at": [4, 1, 8]}],
        "shadows_dirty_every": 3}


def _params(name):
    return json.loads((TRAFFIC / f"{name}.json").read_text())


@pytest.mark.parametrize("params", [_params("orbit"), _params("dirty_orbit"),
                                    WALK], ids=["orbit", "dirty_orbit",
                                                "keyframes"])
def test_a_schedule_repeats(params):
    a, b = schedule.Schedule(params), schedule.Schedule(params)
    for i in (0, 1, 17, 313, 1000):
        for x, y in zip(a.pose(EYE0, LOOK0, i), b.pose(EYE0, LOOK0, i)):
            assert np.array_equal(x, y)
        assert a.dirty(i) == b.dirty(i)
    # the cycle repeats
    for x, y in zip(a.pose(EYE0, LOOK0, 5), a.pose(EYE0, LOOK0, 5 + a.cycle)):
        assert np.array_equal(x, y)


def test_the_orbit_turns_about_the_y_axis_from_the_scenes_camera():
    s = schedule.Schedule(_params("orbit"))
    e, look = s.pose(EYE0, LOOK0, 0)
    assert np.array_equal(e, EYE0) and np.array_equal(look, LOOK0)
    e, look = s.pose(EYE0, LOOK0, 1)
    assert e[1] == EYE0[1] and np.array_equal(look, LOOK0)
    assert np.linalg.norm(e[[0, 2]]) == pytest.approx(16.0)
    assert np.arctan2(e[2], e[0]) - np.pi == pytest.approx(0.02 - 2 * np.pi)


def test_keyframes_interpolate_and_loop():
    s = schedule.Schedule(WALK)
    assert s.cycle == 12
    e, look = s.pose(EYE0, LOOK0, 2)
    assert np.allclose(e, [2, 1, 0]) and np.allclose(look, [3, 1, 0])
    e, _ = s.pose(EYE0, LOOK0, 10)          # from the last key back
    assert np.allclose(e, [2, 1, 2])
    s2 = schedule.Schedule(dict(WALK, start=4))
    assert np.array_equal(s2.pose(EYE0, LOOK0, 0)[0], s.pose(EYE0, LOOK0,
                                                             4)[0])


def test_shadow_dirty_frames():
    assert [schedule.Schedule(_params("dirty_orbit")).dirty(i)
            for i in range(3)] == [True] * 3
    orbit = schedule.Schedule(_params("orbit"))
    assert not any(orbit.dirty(i) for i in range(5))
    assert orbit.last_dirty(7) is None
    walk = schedule.Schedule(WALK)
    assert [walk.dirty(i) for i in range(4)] == [True, False, False, True]
    assert [walk.last_dirty(i) for i in (0, 2, 3, 5)] == [0, 0, 3, 3]


def test_an_unknown_camera_kind_is_refused():
    with pytest.raises(ValueError):
        schedule.Schedule(dict(_params("orbit"), camera="teleport"))
    with pytest.raises(ValueError):
        schedule.Schedule(dict(WALK, keys=WALK["keys"][:1]))
