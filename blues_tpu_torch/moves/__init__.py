"""NCMC moves."""

from .base import Move, NullMove
from .rotation import RandomLigandRotationMove
