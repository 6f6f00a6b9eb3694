"""Serving stack of the port: the paged compressed-KV engine."""
