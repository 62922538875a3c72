"""Device compute ops: batched equilibration, factorization, and solves."""
