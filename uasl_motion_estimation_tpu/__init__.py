"""uasl_motion_estimation_tpu: stereo/mono visual-odometry framework in JAX.

A from-scratch JAX/XLA/Pallas re-design with the capabilities of the
`uasl_motion_estimation` C++ library (feature & pose types, stereo/mono VO,
GN/LM optimisation, MI-based scale estimation, windowed bundle adjustment)
plus the feature front-end (detection, ZNCC/MI stereo matching, KLT tracking)
that the reference delegates to OpenCV — batched for the accelerator and
sharded over device meshes instead of per-feature scalar loops.
"""

__version__ = "0.1.0"

from . import ops  # noqa: F401
