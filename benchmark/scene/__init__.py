"""Scenes the traffic renders, one module each, found by the name a mix
gives (``scene.<name>``)."""

from __future__ import annotations

import importlib


def load(name: str):
    """The scene module ``benchmark.scene.<name>``."""
    return importlib.import_module(f"{__name__}.{name}")
