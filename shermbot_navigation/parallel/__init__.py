"""Multi-chip layer: device meshes, blocked/sharded covariance EKF for large
maps, distributed association, Schur-complement refinement, pose graphs.

The reference has NO parallelism (SURVEY.md section 2.5) — every node is a
single-threaded process. This package is the from-scratch design that
BASELINE.json configs 4-5 require: landmark-block (map) sharding over a
``jax.sharding.Mesh`` with XLA collectives between devices, batched sequences
over a data axis, and information-form refinement for maps too large for a
dense covariance.
"""
