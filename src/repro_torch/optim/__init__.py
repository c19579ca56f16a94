from .adamw import adamw_init, adamw_update, global_norm, OptState  # noqa: F401
from .schedule import wsd_schedule, cosine_schedule                 # noqa: F401
