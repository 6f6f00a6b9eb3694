"""Checkpoint store of the port: atomic, verified, BDI-compressed."""
