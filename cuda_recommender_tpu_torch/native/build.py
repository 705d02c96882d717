"""``python -m cuda_recommender_tpu_torch.native.build``: compile the native
host helpers into ``cuda_recommender_tpu_torch/_build/`` (a no-op when that
library is built)."""

from . import build_library

if __name__ == "__main__":
    print(build_library(verbose=True))
