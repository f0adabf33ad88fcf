from .pipeline import DataSpec, SyntheticStream, make_batch_iterator  # noqa: F401
