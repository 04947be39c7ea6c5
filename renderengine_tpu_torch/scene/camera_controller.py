"""Orbit / free camera controller.

Port of the *formulas* in ``Source/Runtime/CameraController.cpp``:
- F toggles free <-> orbit (orbit restores the initial camera,
  ``CameraController.cpp:74-88``)
- scroll zooms FOV clamped to [30, 130] deg (``:97-120``); with RMB held in
  free mode it adjusts move speed instead
- orbit: RMB-drag rotates eye around the target with a pole clamp
  (``:122-154``)
- free: RMB-drag mouse-look (FOV-scaled angles), WASD flying (``:155-200``)
"""

from __future__ import annotations

import numpy as np

from ..core import math3d
from .camera import Camera
from .input import Inputs, KeyAction

UP = np.array([0.0, 1.0, 0.0], np.float32)


class CameraController:
    ORBIT = 0
    FREE = 1

    def __init__(self, camera: Camera, viewport=(800, 600),
                 mouse_sensitivity: float = 1.0, speed: float = 2.0):
        self.camera = camera
        self.initial = Camera(eye=np.array(camera.eye, np.float32),
                              look_at=np.array(camera.look_at, np.float32),
                              up=np.array(camera.up, np.float32),
                              fov_degrees=camera.fov_degrees,
                              near=camera.near, far=camera.far,
                              width=camera.width, height=camera.height,
                              exposure=camera.exposure)
        self.viewport = viewport
        self.mode = self.ORBIT
        self.speed = speed
        self.mouse_sensitivity = mouse_sensitivity
        self._keys_down: set = set()

    # --- per-frame update (CameraController::Update) ----------------------

    def update(self, dt_s: float, inputs: Inputs) -> bool:
        moved = False
        if not inputs.mouse_was_captured:
            moved |= self._handle_keys(inputs)
            moved |= self._handle_scroll(inputs)
            moved |= self._handle_mouse_move(inputs)
        moved |= self._move(dt_s)
        return moved

    def _handle_keys(self, inputs: Inputs) -> bool:
        changed = False
        for key, action in inputs.keys.items():
            if action in (KeyAction.PRESSED, KeyAction.REPEATED):
                self._keys_down.add(key)
            elif action == KeyAction.RELEASED:
                self._keys_down.discard(key)
            if key == "f" and action == KeyAction.PRESSED:
                if self.mode == self.FREE:
                    c = self.initial
                    self.camera.set_camera_view(c.eye, c.look_at, c.up)
                    self.camera.fov_degrees = c.fov_degrees
                    self.mode = self.ORBIT
                else:
                    self.mode = self.FREE
                changed = True
        return changed

    def _handle_scroll(self, inputs: Inputs) -> bool:
        if not inputs.scroll_offset_received:
            return False
        dy = inputs.scroll_offset[1]
        if self.mode == self.ORBIT or (self.mode == self.FREE and not inputs.is_right_mouse_down):
            self.camera.fov_degrees = float(np.clip(self.camera.fov_degrees - dy, 30.0, 130.0))
            return True
        if self.mode == self.FREE and inputs.is_right_mouse_down:
            self.speed = max(self.speed + dy, 0.1)
            return True
        return False

    def _handle_mouse_move(self, inputs: Inputs) -> bool:
        cam = self.camera
        w, h = self.viewport
        if inputs.is_right_mouse_down and self.mode == self.ORBIT:
            # drag-rotate eye around the target (CameraController.cpp:122-154)
            da = np.array([
                (inputs.last_cursor_pos[0] - inputs.cursor_pos[0]) * (2 * np.pi / w),
                (inputs.last_cursor_pos[1] - inputs.cursor_pos[1]) * (np.pi / h),
            ], np.float32)
            cos_angle = float(np.dot(cam.forward(), UP))
            if cos_angle * np.sign(da[1]) > 0.99:
                da[1] = 0.0  # pole clamp
            pos = np.asarray(cam.eye, np.float32)
            target = np.asarray(cam.look_at, np.float32)
            rx = math3d.rotate(-da[0], UP)[:3, :3]
            pos = rx @ (pos - target) + target
            ry = math3d.rotate(da[1], cam.right())[:3, :3]
            pos = ry @ (pos - target) + target
            cam.set_camera_view(pos, target, UP)
            return True
        if inputs.is_right_mouse_down and self.mode == self.FREE:
            # mouse-look (CameraController.cpp:155-185)
            delta = self.mouse_sensitivity * np.array([
                inputs.cursor_pos[0] - inputs.last_cursor_pos[0],
                inputs.cursor_pos[1] - inputs.last_cursor_pos[1],
            ], np.float32)
            fov_v = cam.fov_degrees / w * h
            x_angle = np.radians(delta[0] * cam.fov_degrees / w)
            y_angle = np.radians(delta[1] * fov_v / h)
            cos_angle = float(np.dot(cam.forward(), UP))
            if (cos_angle > 0.99 and y_angle < 0) or (cos_angle < -0.99 and y_angle > 0):
                y_angle = 0.0
            lookat = np.asarray(cam.look_at, np.float32) - cam.up * y_angle
            new_lookat = lookat + cam.right() * x_angle
            cam.set_camera_view(cam.eye, new_lookat, UP)
            return True
        return False

    def _move(self, dt_s: float) -> bool:
        if self.mode != self.FREE:
            return False
        cam = self.camera
        forward = math3d.normalize(np.asarray(cam.look_at, np.float32) - np.asarray(cam.eye, np.float32))
        right = math3d.normalize(np.cross(forward, cam.up))
        f = (1.0 if "w" in self._keys_down else 0.0) + (-1.0 if "s" in self._keys_down else 0.0)
        r = (1.0 if "d" in self._keys_down else 0.0) + (-1.0 if "a" in self._keys_down else 0.0)
        if f == 0.0 and r == 0.0:
            return False
        cam.move(f * forward + r * right, self.speed * dt_s)
        return True
