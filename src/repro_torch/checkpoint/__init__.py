from .manager import (CheckpointError, latest_step, load_meta,  # noqa: F401
                      restore, save, verify)
