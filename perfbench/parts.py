"""Find a part of the benchmark by its name: the file
``perfbench/<folder>/<name>.py`` under a benchmark root, loaded as a
module of its own.  Metric readers, traffic programs and graph generators
are found so, and a later cell adds one as a new file alone."""

from __future__ import annotations

import importlib.util
import re
from pathlib import Path
from types import ModuleType

__all__ = ["ROOT", "load", "path"]

#: the root of the checkout this package lies in
ROOT = Path(__file__).resolve().parents[1]


def path(root: Path, folder: str, name: str) -> Path:
    return Path(root) / "perfbench" / folder / f"{name}.py"


def load(root: Path, folder: str, name: str) -> ModuleType:
    """The module in ``perfbench/<folder>/<name>.py`` under ``root``."""
    file = path(root, folder, name)
    if not file.is_file():
        raise FileNotFoundError(f"no {folder} part {name!r}: {file}")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{folder}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}", file)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
