"""Activation-sharding context of the LM substrate.

The model code pins its large intermediates with ``constrain(x, ...)``
(logical axis names, one per dimension).  On one device with no mesh
installed that is the identity, which is all the port's models need
until the sharding layer is ported.
"""
from __future__ import annotations

from typing import Optional


def constrain(x, *axes: Optional[str]):
    """``x`` unchanged: no device mesh is installed in the port."""
    return x
