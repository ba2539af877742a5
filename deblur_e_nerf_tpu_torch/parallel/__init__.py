from . import data_parallel, mesh  # noqa: F401
