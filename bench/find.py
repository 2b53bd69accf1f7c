"""The benchmark's pieces, found by name: one file each, so that a later
cell, configuration or traffic mix adds files and edits none.

* ``bench/calls/<call>.py``: ``Call``, what a traffic file's ``"call"``
  names;
* ``bench/generators/<generator>.py``: ``make(graph)``, what a
  configuration's ``graph.generator`` names;
* ``bench/layouts/<kind>.py``: ``make(...)``, what a configuration's
  ``layouts.kind`` names;
* ``bench/metrics/<metric>.py``: ``read(run)``, one per metric of
  ``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib.util
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def module(folder: str, name: str):
    """The module of ``bench/<folder>/<name>.py``, loaded once."""
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {folder} file named {name!r} ({path})")
    key = f"bench.{folder}.{re.sub(r'[^A-Za-z0-9_]', '_', name)}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    return sys.modules[key]
