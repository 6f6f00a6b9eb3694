"""Models of the port: the dense GQA family (params, forward, loss)."""
