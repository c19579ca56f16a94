"""The port's distribution layer for the LM substrate (``ctx``).  The
solver's distribution lives in ``repro_torch.core.dist``."""
