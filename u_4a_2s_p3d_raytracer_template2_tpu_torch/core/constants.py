"""Global numeric constants of the renderer.

Semantics mirror the reference's compile-time constants
(reference: macros.h:1 ``EPSILON 0.001f``, main.cpp:34 ``MAX_DEPTH 4``,
P3D_RT.glsl:234 ``MAX_BOUNCES 10``, P3D_RT.glsl:284 ``MAX_SAMPLES 10000``).
Copied as is from ``u_4a_2s_p3d_raytracer_template2_tpu/core/constants.py``.
"""

EPSILON = 1e-3
MAX_DEPTH = 4          # Whitted bounce cap; depth starts at 1 (main.cpp:774)
MAX_BOUNCES = 10       # path tracer bounce cap (P3D_RT.glsl:234)
MAX_SAMPLES = 10000    # progressive accumulation cap (P3D_RT.glsl:284)
BIG = 1e30             # stand-in for FLT_MAX in f32-safe comparisons

# Object type codes in the unified primitive table.
PLANE = 0
TRIANGLE = 1
SPHERE = 2
AABOX = 3
INVALID = -1

# Acceleration structure selector (reference: scene.h:18).
ACCEL_NONE = 0
ACCEL_GRID = 1
ACCEL_BVH = 2
