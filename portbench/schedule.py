"""The general traffic generator: pose ``i`` of a camera path and the
frames that re-render the shadow maps, from the parameters of one
``traffic/<name>.json`` file. A new mix is a new file; this module reads
every mix.

Keys read:

- ``camera``: the path's kind, with its own keys:
  - ``"orbit"``: frame ``i`` turns the scene's starting eye
    ``orbit_step_rad * i`` rad about the world's +y axis (through the
    origin), look_at fixed; ``cycle_frames`` poses, then it repeats;
  - ``"keyframes"``: ``keys``, a list of ``{"eye": [x, y, z],
    "look_at": [x, y, z]}`` in world coordinates, visited in order and
    back to the first, ``frames_per_key`` frames from one key to the
    next (eye and look_at interpolated linearly): a walkthrough;
- ``shadows_dirty_every``: call ``mark_shadows_dirty()`` before every
  frame ``i`` with ``i % shadows_dirty_every == 0`` (``1``: every frame,
  ``0``: never, the maps cached);
- ``start``: the path's pose that pose ``0`` of the run is.

The up vector is the world's +y. Every seed runs the same poses in the
same order: the controller's budgets follow the poses it has seen, so a
start drawn from the seed would change the work from seed to seed
(PERF.md, Cells).
"""

from __future__ import annotations

import math

import numpy as np

UP = np.array([0, 1, 0], np.float32)


class Schedule:
    """Pose ``i`` of a traffic mix, applied to a camera of either
    package (anything with ``eye``, ``look_at`` and
    ``set_camera_view``)."""

    def __init__(self, params: dict):
        kind = params.get("camera")
        if kind == "orbit":
            self.step = float(params["orbit_step_rad"])
            self.cycle = int(params["cycle_frames"])
            self._pose = self._orbit
        elif kind == "keyframes":
            self.keys = [(np.asarray(k["eye"], np.float32),
                          np.asarray(k["look_at"], np.float32))
                         for k in params["keys"]]
            self.per_key = int(params["frames_per_key"])
            if len(self.keys) < 2 or self.per_key < 1:
                raise ValueError("a keyframed path needs two keys or more "
                                 "and frames_per_key >= 1")
            self.cycle = len(self.keys) * self.per_key
            self._pose = self._keyframes
        else:
            raise ValueError(f"unknown camera {kind!r}; 'orbit' or "
                             "'keyframes'")
        self.dirty_every = int(params.get("shadows_dirty_every", 0))
        self.start = int(params.get("start", 0)) % self.cycle

    def _orbit(self, eye0, look0, j: int):
        a = self.step * j
        c, s = math.cos(a), math.sin(a)
        e = np.asarray(eye0, np.float32)
        return (np.array([e[0] * c - e[2] * s, e[1], e[0] * s + e[2] * c],
                         np.float32), np.asarray(look0, np.float32))

    def _keyframes(self, eye0, look0, j: int):
        k, f = divmod(j, self.per_key)
        (e0, l0), (e1, l1) = self.keys[k], self.keys[(k + 1) % len(self.keys)]
        t = np.float32(f / self.per_key)
        return e0 + t * (e1 - e0), l0 + t * (l1 - l0)

    def pose(self, eye0, look0, i: int):
        """(eye, look_at) of pose ``i`` from the scene's starting eye
        ``eye0`` and look_at ``look0``."""
        return self._pose(eye0, look0, (self.start + i) % self.cycle)

    def dirty(self, i: int) -> bool:
        """Whether frame ``i`` re-renders the shadow maps."""
        return self.dirty_every > 0 and i % self.dirty_every == 0

    def last_dirty(self, i: int) -> int | None:
        """The last frame at or before ``i`` that re-rendered the maps,
        ``None`` where they are still those of the scene's own camera."""
        if self.dirty_every <= 0:
            return None
        return i - i % self.dirty_every

    def apply(self, camera, eye0, look0, i: int) -> None:
        """Put ``camera`` at pose ``i``."""
        eye, look = self.pose(eye0, look0, i)
        camera.set_camera_view(eye, look, UP)
