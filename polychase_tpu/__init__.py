"""polychase_tpu — a JAX (XLA) rebuild of Polychase.

Polychase is a 3D camera/object match-moving pipeline: sparse optical flow →
ray-cast 2D↔3D correspondences → PnP pose solving → sparse Levenberg–Marquardt
bundle adjustment (reference: theartful/polychase).

This package re-implements every component as device programs:

- ``engine/``   pure-JAX math & solvers (pose, camera, raycast, GFTT, LK,
                LM, PnP, bundle adjustment, pin solving)
- ``parallel/`` multi-device sharding (BA edges, LK targets, raycast rays)
- ``io/``       sqlite3 flow database (schema-compatible with the reference)
- ``native/``   C++ BVH ray caster for latency-critical host paths
- ``runtime/``  worker-thread facades matching the reference's async job layer
- ``api.py``    the ``polychase_core``-shaped public surface the Blender addon
                consumes (reference: cpp/polychase_pybind.cc)
"""

__version__ = "0.1.0"
