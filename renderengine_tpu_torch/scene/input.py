"""Frame-accumulated input state.

Reference: ``Source/Runtime/InputSystem.{h,cpp}`` — a per-frame ``Inputs``
snapshot (key map, cursor position + last position, scroll offset, mouse
buttons) accumulated from window callbacks and cleared at ``EndFrame``.
Here the window backend is whatever host loop feeds events in (the viewer
app, a test, or nothing).
"""

from __future__ import annotations

from dataclasses import dataclass, field


class KeyAction:
    PRESSED = 0
    RELEASED = 1
    REPEATED = 2


@dataclass
class Inputs:
    keys: dict = field(default_factory=dict)      # key name -> KeyAction
    cursor_pos: tuple = (0.0, 0.0)
    last_cursor_pos: tuple = (0.0, 0.0)
    scroll_offset: tuple = (0.0, 0.0)
    scroll_offset_received: bool = False
    is_left_mouse_down: bool = False
    is_right_mouse_down: bool = False
    mouse_was_captured: bool = False  # UI-owned mouse (ImGui analog)


class InputSystem:
    """Accumulates events; ``get_frame_inputs`` returns the snapshot,
    ``end_frame`` rolls cursor state (``InputSystem.cpp:14-53``)."""

    def __init__(self):
        self._inputs = Inputs()

    def on_key(self, key: str, action: int) -> None:
        self._inputs.keys[key] = action

    def on_cursor(self, x: float, y: float) -> None:
        self._inputs.cursor_pos = (float(x), float(y))

    def on_scroll(self, dx: float, dy: float) -> None:
        self._inputs.scroll_offset = (float(dx), float(dy))
        self._inputs.scroll_offset_received = True

    def on_mouse_button(self, button: str, down: bool) -> None:
        if button == "left":
            self._inputs.is_left_mouse_down = down
        elif button == "right":
            self._inputs.is_right_mouse_down = down

    def get_frame_inputs(self) -> Inputs:
        return self._inputs

    def end_frame(self) -> None:
        i = self._inputs
        i.last_cursor_pos = i.cursor_pos
        i.scroll_offset = (0.0, 0.0)
        i.scroll_offset_received = False
        # PRESSED is an edge event: demote held keys to REPEATED so
        # one-shot handlers (like the F camera toggle) fire once
        i.keys = {k: KeyAction.REPEATED for k, v in i.keys.items()
                  if v != KeyAction.RELEASED}
