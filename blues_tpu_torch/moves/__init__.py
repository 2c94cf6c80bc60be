"""NCMC moves."""

from .base import Move, NullMove
from .rotation import RandomLigandRotationMove
from .engine import MoveEngine
from .water import WaterTranslationMove
from .sidechain import SideChainMove, find_rotatable_bonds
from .darting import SmartDartMove, MolDartMove
from .combination import CombinationMove
