# Randomized approximate Cholesky (AC) of graph Laplacians with the
# bulk-synchronous wavefront construction, and the solver built on it.
from .laplacian import Graph, laplacian_matvec, laplacian_matvec_np  # noqa: F401
from .column_math import key_from_seed                               # noqa: F401
from .ref_ac import ACFactor, DeviceFactor, factorize_sequential     # noqa: F401
from .parac import factorize_wavefront, factorize_batched            # noqa: F401
from .solver import (Solver, FactorCache, FactorHandle,              # noqa: F401
                     PreconditionerHandle, FactorFleet)
from .ordering import ORDERINGS                                      # noqa: F401
