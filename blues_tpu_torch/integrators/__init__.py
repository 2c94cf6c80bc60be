"""Lambda schedules, constraints, Langevin/BAOAB, FIRE, the Monte Carlo barostat
and the NCMC protocol."""
