"""Data pipeline of the port: the deterministic synthetic token stream."""
