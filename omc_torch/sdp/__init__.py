"""Node relaxations: batch data, the ADMM solver and the safe dual bounds."""
