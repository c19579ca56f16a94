from .engine import SolveEngine, SolveRequest, EngineStats  # noqa: F401
from .admission import (AdmissionPolicy, FIFOAdmission,  # noqa: F401
                        PriorityAdmission, DeadlineAdmission, make_policy)
from .frontend import (SolveFrontend, FrontendStats,  # noqa: F401
                       EngineOverloadedError)
from .cluster import (SolveCluster, ClusterStats,  # noqa: F401
                      ClusterOverloadedError, EngineReplica, ReplicaStats,
                      AdaptiveSelector, make_routing)
