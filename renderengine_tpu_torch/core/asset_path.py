"""Virtual asset roots (reference ``Source/Core/AssetPath.{h,cpp}``):
``/Engine/x`` resolves under the engine assets dir, ``/Game/x`` under the
game assets dir; anything else is a plain filesystem path."""

from __future__ import annotations

import os
from pathlib import Path

_engine_dir: Path | None = None
_game_dir: Path | None = None


def set_engine_directory(path: str | os.PathLike) -> None:
    global _engine_dir
    _engine_dir = Path(path)


def set_game_directory(path: str | os.PathLike) -> None:
    global _game_dir
    _game_dir = Path(path)


def get_engine_directory() -> Path | None:
    return _engine_dir


def get_game_directory() -> Path | None:
    return _game_dir


def default_engine_directory() -> Path:
    """The repo's own ``assets/`` directory (engine built-ins: skybox etc.)."""
    return Path(__file__).resolve().parents[2] / "assets"


class AssetPath:
    """A virtual path (``AssetPath.h:6-31``). Resolution appends ``Assets/``
    under the configured root, matching ``AssetPath.cpp:10-29``."""

    ENGINE_PREFIX = "/Engine/"
    GAME_PREFIX = "/Game/"

    def __init__(self, path: str | os.PathLike):
        self.path = str(path)

    def get_path_on_disk(self) -> Path:
        p = self.path
        if p.startswith(self.ENGINE_PREFIX):
            root = _engine_dir if _engine_dir is not None else default_engine_directory()
            return Path(root) / p[len(self.ENGINE_PREFIX):]
        if p.startswith(self.GAME_PREFIX):
            if _game_dir is None:
                raise RuntimeError("Game directory not set (see set_game_directory)")
            return Path(_game_dir) / p[len(self.GAME_PREFIX):]
        return Path(p)

    def exists(self) -> bool:
        try:
            return self.get_path_on_disk().exists()
        except RuntimeError:
            return False

    def __str__(self) -> str:
        return self.path

    def __repr__(self) -> str:
        return f"AssetPath({self.path!r})"

    def __eq__(self, other) -> bool:
        return isinstance(other, AssetPath) and other.path == self.path

    def __hash__(self) -> int:
        return hash(self.path)
