"""``--key value`` CLI parsing with ``--help`` text
(reference ``Source/Core/ArgumentParser.{h,cpp}``)."""

from __future__ import annotations

import sys
from dataclasses import dataclass, field


@dataclass
class ArgumentParser:
    """Same surface as the reference: register option descriptions, parse
    ``--key value`` pairs, query with defaults (``ArgumentParser.h:34-61``)."""

    description: str = ""
    _options: dict = field(default_factory=dict)  # name -> help text
    _values: dict = field(default_factory=dict)

    def add_option(self, name: str, help_text: str = "") -> None:
        self._options[name] = help_text

    def parse(self, argv: list[str] | None = None) -> bool:
        """Parse args. Returns False (and prints help) on ``--help``."""
        argv = list(sys.argv[1:] if argv is None else argv)
        i = 0
        while i < len(argv):
            a = argv[i]
            if a in ("--help", "-h"):
                print(self.help_text())
                return False
            if a.startswith("--"):
                key = a[2:]
                if i + 1 < len(argv) and not argv[i + 1].startswith("--"):
                    self._values[key] = argv[i + 1]
                    i += 2
                else:
                    self._values[key] = "true"
                    i += 1
            else:
                i += 1
        return True

    def help_text(self) -> str:
        lines = [self.description] if self.description else []
        for name, help_text in self._options.items():
            lines.append(f"  --{name:<16} {help_text}")
        return "\n".join(lines)

    def has(self, name: str) -> bool:
        return name in self._values

    def get_string(self, name: str, default: str | None = None) -> str | None:
        return self._values.get(name, default)

    def get_float(self, name: str, default: float = 0.0) -> float:
        v = self._values.get(name)
        return float(v) if v is not None else default

    def get_int(self, name: str, default: int = 0) -> int:
        v = self._values.get(name)
        return int(v) if v is not None else default

    def get_bool(self, name: str, default: bool = False) -> bool:
        v = self._values.get(name)
        if v is None:
            return default
        return v.lower() in ("1", "true", "yes", "on")
