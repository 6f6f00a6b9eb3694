"""Optimizers of the port: AdamW with optionally BDI-compressed moments."""
from .adamw import (AdamWConfig, adamw_init, adamw_update,  # noqa: F401
                    opt_state_bytes)
