"""Utilities: hierarchy checkpoints and casts (``checkpoint``), run records
(``metrics``), profiling and NaN guards (``profiling``) and traffic models
(``roofline``).

Counterpart of ``parallel_amg_tpu/utils``.  Its ``precision.x64_scope`` has
no counterpart: torch has float64 tensors natively, and ``amg_pcg_mp``
widens its Krylov vectors without a global switch.
"""
