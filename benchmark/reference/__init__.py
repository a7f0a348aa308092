"""Plain references of what the benchmark's cells run.

Plain PyTorch in float32: no kernel of the program, no cache, no batching
beyond the step's own. They import neither ``jax`` nor either package of
the repository. Parameter names and layouts follow the program's modules,
so one seeded state dict (``benchmark/weights.py``) loads into both sides.
Each module's docstring lists where it departs from the published model.
"""
