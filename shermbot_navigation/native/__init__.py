"""ctypes bindings to the native C++ host engine (native/baseline).

The native engine is the framework's host-side runtime: the reference's
full pipeline (tube-world sim -> odometry -> perception -> dense EKF-SLAM,
per slam_library.cpp / tube_world.cpp / circle_fit_library.cpp semantics)
as an in-process C++ library. It serves three roles:

- measured performance/trajectory baseline for the JAX engine (BASELINE.md),
- low-latency single-robot host serving path (no device round-trip),
- in-process oracle for parity tests (no subprocess/CSV plumbing).

Built on demand via ``make`` (g++ only, no external deps).
"""

from shermbot_navigation.native.host import (  # noqa: F401
    HostEngine,
    detect_landmarks,
    ensure_built,
    simulate_lidar,
)
