"""The MD <-> NCMC <-> Metropolis driver, mobile-state compaction and the
pure Monte Carlo variant."""

from .driver import BLUESSimulation, SimulationConfig
from .montecarlo import MCStats, MonteCarloSimulation
