"""Load a Python file of the harness by its path, as the harness finds a
metric's reader or a model family by name."""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path


def load_file(path: Path, name: str):
    """The module of the file `path`, registered as `name`: loaded once a
    process."""
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[name] = mod
    return sys.modules[name]
