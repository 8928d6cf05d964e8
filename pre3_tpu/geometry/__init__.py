"""Geometry & math core: quaternions, SE(3), camera model, inverse depth.

Batched re-design of the reference's rotation/camera math layers
(reference: slamToolbox FrameTransforms/Rotations, initialize_cam.m,
hu/hinv/distort/undistort, inverse-depth parameterization). Pure jnp,
fully vmappable, autodiff-friendly — hand Jacobians from the reference
(calculate_Hi_*, dRq_times_a_by_dq, ...) are replaced by jax.jacfwd/jacrev
and only kept as test oracles in tests/.
"""

from pre3_tpu.geometry.quaternion import (
    qprod, qconj, qnormalize, q2r, r2q, v2q, q2v, e2q, q2e, qrotate,
)
from pre3_tpu.geometry.se3 import (
    Pose, pose_identity, pose_compose, pose_inverse, pose_apply,
    pose_to_matrix, pose_from_matrix, pose_delta,
)
from pre3_tpu.geometry.camera import (
    Camera, sr4000_camera, distort, undistort, project, unproject,
    project_point, in_fov,
)
from pre3_tpu.geometry.inverse_depth import (
    inverse_depth_to_cartesian, ray_from_angles, inverse_depth_point,
    linearity_index,
)
