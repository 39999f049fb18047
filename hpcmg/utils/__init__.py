from hpcmg.utils.checkpoint import (
    CheckpointManager,
    run_with_checkpoints,
)
from hpcmg.utils.io import (
    field_difference_norm,
    load_field,
    load_field_txt,
    save_field,
    save_field_txt,
)
from hpcmg.utils.timing import (
    Timer,
    device_sync,
    profile,
    time_run,
)

__all__ = [
    "CheckpointManager",
    "run_with_checkpoints",
    "field_difference_norm",
    "load_field",
    "load_field_txt",
    "save_field",
    "save_field_txt",
    "Timer",
    "device_sync",
    "profile",
    "time_run",
]
