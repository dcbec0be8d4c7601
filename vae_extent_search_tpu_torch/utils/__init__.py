from .misc import (
    PathManager,
    array_mean,
    seed_everything,
    to_str_round,
    trace_profile,
)
