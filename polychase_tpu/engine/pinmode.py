"""Interactive pin-mode pose solving (drag pins → pose update).

Rebuild of cpp/pin_mode.{h,cc}.  Dispatch on pin count:

- 1 pin: depth-preserving translation along the drag ray
  (cpp/pin_mode.cc:110-149);
- 2 pins: rotation about the view axis through the anchor pin plus
  scale-about-anchor as a camera-distance change (cpp/pin_mode.cc:151-217);
- ≥3 pins: project pins with the *initial* transform, override the
  dragged pin's 2D target, warm-start from the *current* transform, run
  iterative PnP (Trivial loss) in camera space, then recompose into a
  model- or view-matrix update (cpp/pin_mode.cc:16-108).

The n≥3 path solves on the **host** for small pin counts: a pin drag is
one solve per mouse move (cpp/pin_mode.cc:219-246), and an 8-pin
9-parameter LM is microseconds of numpy (`engine.pnp_host`), less than a
device dispatch's latency.  Above ``POLYCHASE_HOST_PIN_MAX`` points
(default 4096, not measured on the GPU) it takes the jitted,
bucket-padded device solve;
``POLYCHASE_HOST_PIN_MAX=0`` forces the device path everywhere.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import jax
import numpy as np

from . import camera as C
from . import pose as P
from .geometry import (
    SceneTransformations,
    TRANSFORM_CAMERA,
    TRANSFORM_MODEL,
)
from .levmarq import BundleOptions, TRIVIAL
from .pnp import PnPOptions, solve_pnp


class PinUpdate(NamedTuple):
    """One dragged pin (cpp/pin_mode.h:10-13)."""

    pin_idx: int
    pos: np.ndarray  # (2,) new pixel position


def _np4(mat) -> np.ndarray:
    return np.asarray(mat, np.float64).reshape(4, 4)


def _ray_world(scene: SceneTransformations, pos) -> tuple:
    """Pixel → world ray, pure host math (one solve per mouse move)."""
    view_inv = np.linalg.inv(_np4(scene.view_matrix))
    intr = jax.device_get(scene.intrinsics)
    s = float(intr.sign)
    px, py = (float(v) for v in np.asarray(pos, np.float64).reshape(2))
    d = np.array(
        [
            s * (px - float(intr.cx)) / float(intr.fx),
            s * (py - float(intr.cy)) / float(intr.fy),
            s,
        ]
    )
    return view_inv[:3, 3], view_inv[:3, :3] @ d


def _find_transformation_1(
    object_points, scene: SceneTransformations, update: PinUpdate, trans_type
) -> SceneTransformations:
    """Depth-preserving translation (cpp/pin_mode.cc:110-149)."""
    origin, direction = _ray_world(scene, update.pos)
    model = _np4(scene.model_matrix)
    p_obj = np.asarray(object_points[0], np.float64)
    p_world = model[:3, :3] @ p_obj + model[:3, 3]

    depth = np.linalg.norm(p_world - origin)
    translated = origin + depth * direction / np.linalg.norm(direction)
    translation = translated - p_world

    new_model = model.copy()
    new_model[:3, 3] += translation

    if trans_type == TRANSFORM_MODEL:
        return SceneTransformations(
            np.asarray(new_model, np.float32),
            scene.view_matrix,
            scene.intrinsics,
        )
    view = _np4(scene.view_matrix) @ new_model @ np.linalg.inv(model)
    # Host arrays throughout: a pin drag solves per mouse move, and every
    # device round trip would add latency.
    return SceneTransformations(
        scene.model_matrix, np.asarray(view, np.float32), scene.intrinsics
    )


def _find_transformation_2(
    object_points, scene: SceneTransformations, update: PinUpdate, trans_type
) -> SceneTransformations:
    """Rotate about the view axis through the anchor + scale about it
    (cpp/pin_mode.cc:151-217)."""
    origin, direction = _ray_world(scene, update.pos)
    view_inv = np.linalg.inv(_np4(scene.view_matrix))
    camera_center = view_inv[:3, 3]
    model = _np4(scene.model_matrix)

    moving = model[:3, :3] @ np.asarray(
        object_points[update.pin_idx], np.float64
    ) + model[:3, 3]
    anchor = model[:3, :3] @ np.asarray(
        object_points[1 - update.pin_idx], np.float64
    ) + model[:3, 3]

    depth = np.linalg.norm(moving - origin)
    translated_moving = origin + depth * direction / np.linalg.norm(direction)

    du = moving - anchor
    dv = translated_moving - anchor
    dn_unit = view_inv[:3, 2] / np.linalg.norm(view_inv[:3, 2])
    du_unit = du / np.linalg.norm(du)
    dv_unit = dv / np.linalg.norm(dv)
    angle = np.arctan2(
        np.dot(np.cross(du_unit, dv_unit), dn_unit), np.dot(du_unit, dv_unit)
    )

    # Rodrigues rotation about dn_unit
    K = np.array(
        [
            [0, -dn_unit[2], dn_unit[1]],
            [dn_unit[2], 0, -dn_unit[0]],
            [-dn_unit[1], dn_unit[0], 0],
        ]
    )
    R = np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)

    scale_inv = np.linalg.norm(du) / np.linalg.norm(dv)
    new_anchor = camera_center + (anchor - camera_center) * scale_inv

    update_mat = np.eye(4)
    update_mat[:3, :3] = R
    update_mat[:3, 3] = new_anchor - R @ anchor

    if trans_type == TRANSFORM_MODEL:
        return SceneTransformations(
            np.asarray(update_mat @ model, np.float32),
            scene.view_matrix,
            scene.intrinsics,
        )
    return SceneTransformations(
        scene.model_matrix,
        np.asarray(_np4(scene.view_matrix) @ update_mat, np.float32),
        scene.intrinsics,
    )


_np_mat_to_quat = P.mat_to_quat_np
_np_quat_to_mat = P.quat_to_mat_np


def _find_transformation_n(
    object_points,
    initial: SceneTransformations,
    current: SceneTransformations,
    update: PinUpdate,
    trans_type,
    optimize_focal_length,
    optimize_principal_point,
) -> SceneTransformations:
    """General case via iterative PnP in camera space
    (cpp/pin_mode.cc:16-108)."""
    X = np.asarray(object_points, np.float64).reshape(-1, 3)
    model_view = _np4(initial.view_matrix) @ _np4(initial.model_matrix)
    mv_R, mv_t = model_view[:3, :3], model_view[:3, 3]

    X_cam = X @ mv_R.T + mv_t
    ii = jax.device_get(initial.intrinsics)
    Kp = np.array(
        [
            [float(ii.fx), 0.0, float(ii.cx)],
            [0.0, float(ii.fy), float(ii.cy)],
            [0.0, 0.0, 1.0],
        ],
        np.float64,
    )
    proj = X_cam @ Kp.T
    image_points = (proj[:, :2] / proj[:, 2:3]).astype(np.float32)
    image_points[update.pin_idx] = np.asarray(update.pos, np.float32)

    # Warm start: the delta that maps initial MV to current MV
    initial_pose_mat = (
        _np4(current.view_matrix)
        @ _np4(current.model_matrix)
        @ np.linalg.inv(model_view)
    )
    # Host-side decomposition: each eager device op on this interactive
    # path costs a host round trip.
    q0 = _np_mat_to_quat(initial_pose_mat[:3, :3]).astype(np.float32)
    cam0 = C.CameraState(
        current.intrinsics,
        P.Pose(q0, initial_pose_mat[:3, 3].astype(np.float32)),
    )

    opts = PnPOptions(
        bundle_opts=BundleOptions(loss_type=TRIVIAL),
        max_inlier_error=0.0,
        optimize_focal_length=optimize_focal_length,
        optimize_principal_point=optimize_principal_point,
    )
    host_max = int(os.environ.get("POLYCHASE_HOST_PIN_MAX", "4096"))
    if len(X_cam) <= host_max:
        from .pnp_host import solve_pnp_host

        result = solve_pnp_host(
            X_cam.astype(np.float32), image_points, cam0, opts
        )
    else:
        result = solve_pnp(X_cam.astype(np.float32), image_points, cam0, opts)

    R = _np_quat_to_mat(np.asarray(result.camera.pose.q, np.float64))
    t = np.asarray(result.camera.pose.t, np.float64)

    if trans_type == TRANSFORM_MODEL:
        new_mv = np.eye(4)
        new_mv[:3, :3] = R @ mv_R
        new_mv[:3, 3] = R @ mv_t + t
        model = np.linalg.inv(_np4(initial.view_matrix)) @ new_mv
        return SceneTransformations(
            np.asarray(model, np.float32),
            current.view_matrix,
            result.camera.intrinsics,
        )
    upd = np.eye(4)
    upd[:3, :3] = R
    upd[:3, 3] = t
    view = upd @ _np4(initial.view_matrix)
    return SceneTransformations(
        current.model_matrix,
        np.asarray(view, np.float32),
        result.camera.intrinsics,
    )


def find_transformation(
    object_points,
    initial_scene_transform: SceneTransformations,
    current_scene_transform: SceneTransformations,
    update: PinUpdate,
    trans_type: int,
    optimize_focal_length: bool = False,
    optimize_principal_point: bool = False,
) -> SceneTransformations:
    """Pose update from a pin drag (cpp/pin_mode.cc:219-246)."""
    object_points = np.asarray(object_points, np.float32).reshape(-1, 3)
    n = object_points.shape[0]
    if not 0 <= int(update.pin_idx) < n:
        raise ValueError("pin_idx out of range")
    if n == 1:
        return _find_transformation_1(
            object_points, initial_scene_transform, update, trans_type
        )
    if n == 2:
        # Started from current (not initial) like the reference
        # (cpp/pin_mode.cc:232-235)
        return _find_transformation_2(
            object_points, current_scene_transform, update, trans_type
        )
    return _find_transformation_n(
        object_points, initial_scene_transform, current_scene_transform,
        update, trans_type, optimize_focal_length, optimize_principal_point,
    )
