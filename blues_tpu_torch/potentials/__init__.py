"""Energy terms: pair math, bonded, PME, the sweep pair sum and their composition."""
