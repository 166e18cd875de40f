from .pipeline import DataConfig, batch_at  # noqa: F401
