from .pipeline import DataConfig, Prefetcher, batch_at  # noqa: F401
