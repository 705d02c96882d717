"""The plain references the benchmark judges the program's output against:
one module a configuration's solver (``ccd``, ``als``), named by the
configuration file's ``reference`` key. They import torch and nothing of
the program."""
