from .timing import profile_trace, span, sync, timeit  # noqa: F401
