from .misc import (
    PathManager,
    array_mean,
    seed_everything,
    span,
    to_str_round,
    trace_profile,
)
