"""Pallas kernels for the blocked EKF's deferred tick (Triton route).

- ``grid_update`` — the deferred rank-2M landmark-grid pass: init-overwrite
                    replay + masked rank-2M subtraction in one read and one
                    write of the component planes. It serves config 4
                    (``parallel/bigmap``) and single-robot serving
                    (``pipeline/serving``), auto-routed on a GPU for
                    maps of at least ``bigmap.GRID_KERNEL_MIN_N``
                    landmarks by ``parallel/bigmap._resolve_grid_kernel``.

The XLA schedule it replaces stays in ``parallel/blocked_ekf`` as the CPU
and multi-shard path and as the kernel's oracle. ``interpret=True`` runs
the kernel in the Pallas interpreter, which is how the CPU tests check it.
"""

from .grid_update import fused_grid_update
