"""Unit system and physical constants (OpenMM MD units).

length = nanometer, time = picosecond, mass = dalton, energy = kJ/mol,
temperature = kelvin, charge = elementary charge. Same constants and
parser as ``blues_tpu.units``; kept as a copy so the port never imports
the JAX package.
"""

from __future__ import annotations

import re

#: Boltzmann constant * Avogadro, kJ/(mol*K)
BOLTZMANN_KJMOL = 8.31446261815324e-3
#: Coulomb constant 1/(4 pi eps0) in kJ*nm/(mol*e^2) (OpenMM ONE_4PI_EPS0)
ONE_4PI_EPS0 = 138.93545764438198
#: Avogadro's number, 1/mol
AVOGADRO = 6.02214076e23
#: 1 bar in kJ/(mol*nm^3)
BAR_TO_KJMOL_PER_NM3 = 1.0e5 * 1e-27 * AVOGADRO / 1000.0
#: Amber prmtop charges are stored multiplied by 18.2223 = sqrt(kcal*A/mol/e^2)
AMBER_CHARGE_SCALE = 18.2223
KCAL_TO_KJ = 4.184


def kT(temperature: float) -> float:
    """Thermal energy kT in kJ/mol for a temperature in kelvin."""
    return BOLTZMANN_KJMOL * temperature


_UNIT_TABLE = {
    "nanometer": (1.0, "length"),
    "nanometers": (1.0, "length"),
    "angstrom": (0.1, "length"),
    "angstroms": (0.1, "length"),
    "picosecond": (1.0, "time"),
    "picoseconds": (1.0, "time"),
    "femtosecond": (1e-3, "time"),
    "femtoseconds": (1e-3, "time"),
    "nanosecond": (1e3, "time"),
    "nanoseconds": (1e3, "time"),
    "/picosecond": (1.0, "rate"),
    "/picoseconds": (1.0, "rate"),
    "kelvin": (1.0, "temperature"),
    "dalton": (1.0, "mass"),
    "daltons": (1.0, "mass"),
    "amu": (1.0, "mass"),
    "kilojoule_per_mole": (1.0, "energy"),
    "kilojoules_per_mole": (1.0, "energy"),
    "kilocalorie_per_mole": (KCAL_TO_KJ, "energy"),
    "kilocalories_per_mole": (KCAL_TO_KJ, "energy"),
    "bar": (BAR_TO_KJMOL_PER_NM3, "pressure"),
    "atmosphere": (1.01325 * BAR_TO_KJMOL_PER_NM3, "pressure"),
    "atmospheres": (1.01325 * BAR_TO_KJMOL_PER_NM3, "pressure"),
}


#: the unit of a bare number per config key (the reference's per-key table)
DEFAULT_UNITS = {
    "dt": "picoseconds",
    "friction": "/picosecond",
    "temperature": "kelvin",
    "pressure": "bar",
    "hydrogenMass": "daltons",
    "nonbondedCutoff": "angstroms",
    "switchDistance": "angstroms",
    "cutoff": "angstroms",
    "freeze_distance": "angstroms",
    "weight": "kilocalories_per_mole",  # restraint weight per A^2 handled at use site
    "radius": "angstroms",
}


def parse_quantity(value, default_unit: str | None = None) -> float:
    """Parse ``'10 * angstroms'``, ``'1/picosecond'`` or a bare number
    (scaled by ``default_unit``) into a float in MD units."""
    if isinstance(value, (int, float)):
        if default_unit is None:
            return float(value)
        return float(value) * _UNIT_TABLE[default_unit][0]
    if not isinstance(value, str):
        raise TypeError(f"cannot parse quantity from {type(value)}")
    s = re.sub(r"\*\s*1\s*/", "/", value.strip())
    m = re.match(r"^([-+0-9.eE]+)\s*([*/])\s*([A-Za-z_/]+)$", s)
    if m is None:
        try:
            num = float(s)
        except ValueError:
            raise ValueError(f"cannot parse quantity string {value!r}") from None
        return parse_quantity(num, default_unit)
    num, op, unit_name = float(m.group(1)), m.group(2), m.group(3).strip()
    if op == "/":
        key = "/" + unit_name
        if key in _UNIT_TABLE:
            return num * _UNIT_TABLE[key][0]
        return num / _UNIT_TABLE[unit_name][0]
    return num * _UNIT_TABLE[unit_name][0]
