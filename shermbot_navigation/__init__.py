"""shermbot_navigation: a GPU 2D EKF-SLAM engine in JAX.

A ground-up JAX/XLA/Pallas re-design of the capabilities of
``sziselman/Shermbot-Navigation`` (a ROS1/C++ TurtleBot3 EKF-SLAM stack):

- ``ops.se2``        — SE(2) rigid-transform algebra        (ref: rigid2d/src/rigid2d.cpp)
- ``ops.diff_drive`` — differential-drive kinematics         (ref: rigid2d/src/diff_drive.cpp)
- ``models.ekf_slam``— EKF-SLAM predict/associate/update     (ref: nuslam/src/slam_library.cpp)
- ``ops.clustering``,
  ``ops.circle_fit`` — lidar landmark perception             (ref: nuslam/src/circle_fit_library.cpp)
- ``sim.tube_world`` — vectorized world + lidar simulator    (ref: nuturtlesim/src/tube_world.cpp)
- ``pipeline``       — in-process jitted pipeline replacing the ROS topic graph
- ``parallel``       — mesh/sharding layer for large-map multi-device SLAM
- ``ops.pallas``     — Pallas (Triton) kernels for the blocked EKF's tick

Everything is pure-functional, jit/vmap/scan-friendly, and designed for an
accelerator: static shapes with landmark-capacity padding + masks,
branchless gating via ``jnp.where``, batched linear algebra, and sharded
covariance blocks over a ``jax.sharding.Mesh`` for maps that exceed one
device.
"""

__version__ = "0.1.0"
