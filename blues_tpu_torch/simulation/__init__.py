"""The MD <-> NCMC <-> Metropolis driver and mobile-state compaction."""

from .driver import BLUESSimulation, SimulationConfig
