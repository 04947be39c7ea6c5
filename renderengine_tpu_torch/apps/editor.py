"""Editor stub — parity with ``Source/Editor/main.cpp:5-25``: parse
``--project``, set asset directories, exit. Plus ``--new-project`` wired to
the ProjectWizard."""

from __future__ import annotations

import os
import sys
from pathlib import Path

from ..core.args import ArgumentParser
from ..core import asset_path
from .project import ProjectSettings, ProjectWizard


def main(argv=None) -> int:
    parser = ArgumentParser(description="editor.py — the (stub) project editor")
    parser.add_option("project", "path to a .rproj project file")
    parser.add_option("new-project", "directory in which to create a new project")
    parser.add_option("name", "project name for --new-project")
    if not parser.parse(argv):
        return -1

    asset_path.set_engine_directory(Path(os.getcwd()))

    new_dir = parser.get_string("new-project")
    if new_dir:
        name = parser.get_string("name", "NewProject")
        settings = ProjectWizard.create_new_project(new_dir, name)
        print(f"created project '{settings.project_name}' at {settings.project_dir}")
        return 0

    project = parser.get_string("project")
    if project:
        settings = ProjectSettings.from_file(project)
        asset_path.set_game_directory(settings.project_dir)
        print(f"opened project '{settings.project_name}' ({settings.project_dir})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
