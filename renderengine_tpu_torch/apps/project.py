"""Project settings + wizard (reference ``Source/Editor/ProjectSettings.{h,cpp}``
and ``ProjectWizard.cpp``): TOML ``<name>.rproj`` files with a
``[project] name`` entry; the project's assets live under ``<dir>/Assets``."""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import tomllib


@dataclass
class ProjectSettings:
    project_dir: Path = field(default_factory=Path)
    project_name: str = ""

    @property
    def assets_dir(self) -> Path:
        return self.project_dir / "Assets"

    @staticmethod
    def from_file(settings_file_path) -> "ProjectSettings":
        p = Path(settings_file_path)
        data = tomllib.loads(p.read_text())
        return ProjectSettings(p.parent, data["project"]["name"])

    def save_to_file(self) -> Path:
        path = self.project_dir / f"{self.project_name}.rproj"
        path.write_text(f'[project]\nname = "{self.project_name}"\n')
        return path


class ProjectWizard:
    @staticmethod
    def create_new_project(project_dir, project_name: str) -> ProjectSettings:
        """Reference ``ProjectWizard::CreateNewProject`` + the Assets-dir
        todo it never finished (``ProjectWizard.cpp:7-8``)."""
        settings = ProjectSettings(Path(project_dir), project_name)
        settings.project_dir.mkdir(parents=True, exist_ok=True)
        settings.assets_dir.mkdir(exist_ok=True)
        settings.save_to_file()
        return settings
