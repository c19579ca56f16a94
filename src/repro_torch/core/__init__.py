# Randomized approximate Cholesky (AC) of graph Laplacians with the
# bulk-synchronous wavefront construction, and the solver built on it.
from .laplacian import Graph, laplacian_matvec, laplacian_matvec_np  # noqa: F401
from .column_math import key_from_seed                               # noqa: F401
from .ref_ac import ACFactor, DeviceFactor, factorize_sequential     # noqa: F401
from .parac import factorize_wavefront, factorize_batched            # noqa: F401
from .trisolve import (make_preconditioner, precond_apply_np,        # noqa: F401
                       build_schedules_device)
# ``pcg.pcg`` itself stays in its module: exported here it would shadow
# the submodule ``core.pcg``
from .pcg import (pcg_batched, pcg_np,                               # noqa: F401
                  pcg_batched_init, pcg_batched_step, pcg_batched_result,
                  laplacian_pcg, laplacian_pcg_batched, laplacian_pcg_np)
from .solver import (Solver, FactorCache, FactorHandle,              # noqa: F401
                     PreconditionerHandle, FactorFleet, PrecondFamily,
                     PRECOND_FAMILIES, register_family, get_family)
from .ordering import ORDERINGS                                      # noqa: F401
