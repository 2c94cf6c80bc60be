"""Lambda schedules, constraints, Langevin/BAOAB, FIRE and the NCMC protocol."""
