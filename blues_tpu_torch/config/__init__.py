"""YAML/JSON configuration: ``Settings``, ``load_structure``, ``create_simulation``."""

from .settings import Settings, create_simulation, load_structure
