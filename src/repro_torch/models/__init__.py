"""Model building blocks of the port (dense GQA so far)."""
