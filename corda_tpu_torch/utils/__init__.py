from .metrics import MetricRegistry  # noqa: F401
