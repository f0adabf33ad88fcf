from .store import (  # noqa: F401
    AsyncCheckpointer,
    CheckpointMeta,
    latest_step,
    restore,
    save,
)
