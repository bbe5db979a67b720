"""Application circuits: passport verification, register identity."""
