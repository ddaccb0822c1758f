"""PyTorch/CUDA port of ``repro``: data-aware PRF attention served on a GPU.

Mirrors ``repro``'s subpackages (configs, core, kernels, models,
serving, launch) and keeps its public layouts, so each module's
counterpart is found under the same name. Imports torch and numpy only.
Entry points default to ``device="cuda"``; pass ``device="cpu"`` to run
the kernels' plain PyTorch versions.
"""
