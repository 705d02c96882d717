from .timing import Phases, profile_trace, sync, timeit  # noqa: F401
