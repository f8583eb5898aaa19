"""Host-side keypoint descriptions (via-points with precision matrices).

A copy of the JAX package's `systems/keypoints.py` (pure numpy), kept so
the port imports nothing of the JAX package.

These are plain Python data holders used at problem-build time to scatter
dense `Spec` arrays; nothing here is traced. They mirror the reference
keypoint hierarchy (Keypoint.h:15-41 and subclasses):

  PosOrnKeypoint           TAG "POS_ORN"       (PosOrnKeypoint.cpp:13-45)
  PosOrnKeypointDistFunct  dead-zone variant   (PosOrnKeypointDistFunct.cpp:13-35)
  SpacetimeKeypoint        TAG "POS_ORN_TIME"  (SpacetimeKeypoint.cpp:12-24)
  AngularKeypoint          TAG "JNT"           (AngularKeypoint.cpp:13-27)
  AngularTimeKeypoint      TAG "JNT_TIME"      (AngularTimeKeypoint.cpp:12-24)
  PointKeypoint            position-only extension (no reference analogue;
                           supports planar/cartesian position tracking)

`order` is the keypoint type: 1 = FIRST_ORDER, 2 = SECOND_ORDER
(Keypoint.h:17). `state()` returns the reference `getState()` layout —
note the second-order PosOrn layout is [p, dp, quat, dquat]
(PosOrnKeypoint.cpp:16-19), which differs from the forward-map layout
[p, quat, dp, dquat] used by `diff`; dense spec building accounts for this.
"""

import dataclasses
from typing import Optional

import numpy as np

__all__ = [
    "Keypoint",
    "PosOrnKeypoint",
    "PosOrnKeypointDistFunct",
    "SpacetimeKeypoint",
    "AngularKeypoint",
    "AngularTimeKeypoint",
    "PointKeypoint",
]


@dataclasses.dataclass
class Keypoint:
    timestep: int
    precision: np.ndarray
    order: int = 1
    TAG: str = ""

    def state(self) -> np.ndarray:
        raise NotImplementedError


@dataclasses.dataclass
class PosOrnKeypoint(Keypoint):
    """Task-space position + quaternion via-point.

    position (3,), orientation (4,) w-first; second order adds dposition and
    dorientation (quaternion rate, 4). Precision is (6,6) for first order,
    (12,12) for second (residual layout [dp, dorn] appended).
    """

    position: np.ndarray = None
    orientation: np.ndarray = None
    dposition: Optional[np.ndarray] = None
    dorientation: Optional[np.ndarray] = None
    TAG: str = "POS_ORN"

    def __init__(self, position, orientation, precision, timestep,
                 dposition=None, dorientation=None):
        order = 2 if dposition is not None else 1
        super().__init__(timestep=int(timestep), precision=np.asarray(precision, float),
                         order=order, TAG=type(self).TAG)
        self.position = np.asarray(position, float)
        self.orientation = np.asarray(orientation, float)
        self.dposition = None if dposition is None else np.asarray(dposition, float)
        self.dorientation = None if dorientation is None else np.asarray(dorientation, float)

    def state(self) -> np.ndarray:
        """Reference getState layout (PosOrnKeypoint.cpp:13-22)."""
        if self.order == 1:
            return np.concatenate([self.position, self.orientation])
        return np.concatenate(
            [self.position, self.dposition, self.orientation, self.dorientation]
        )

    def fx_state(self) -> np.ndarray:
        """Forward-map layout [p, quat, dp, dquat] used by diff()."""
        if self.order == 1:
            return np.concatenate([self.position, self.orientation])
        return np.concatenate(
            [self.position, self.orientation, self.dposition, self.dorientation]
        )


class PosOrnKeypointDistFunct(PosOrnKeypoint):
    """PosOrnKeypoint with dead zones: position residual shrunk by a sphere
    radius, orientation residual by per-axis thresholds
    (PosOrnKeypointDistFunct.cpp:13-35)."""

    def __init__(self, position, orientation, precision, timestep,
                 pos_radius=0.0, orn_thresh=(0.0, 0.0, 0.0),
                 dposition=None, dorientation=None):
        super().__init__(position, orientation, precision, timestep,
                         dposition=dposition, dorientation=dorientation)
        self.pos_radius = float(pos_radius)
        self.orn_thresh = np.asarray(orn_thresh, float)


class SpacetimeKeypoint(PosOrnKeypoint):
    """PosOrnKeypoint + continuous-time target (SpacetimeKeypoint.cpp:12-24)."""

    TAG = "POS_ORN_TIME"

    def __init__(self, position, orientation, precision, timestep, continuous_time,
                 dposition=None, dorientation=None):
        super().__init__(position, orientation, precision, timestep,
                         dposition=dposition, dorientation=dorientation)
        self.continuous_time = float(continuous_time)

    def state(self) -> np.ndarray:
        return np.concatenate([super().state(), [self.continuous_time]])

    def fx_state(self) -> np.ndarray:
        return np.concatenate([super().fx_state(), [self.continuous_time]])


@dataclasses.dataclass
class AngularKeypoint(Keypoint):
    """Joint-space via-point with plain Euclidean residual
    (AngularKeypoint.cpp:24-27)."""

    position: np.ndarray = None
    dposition: Optional[np.ndarray] = None
    TAG: str = "JNT"

    def __init__(self, position, precision, timestep, dposition=None):
        order = 2 if dposition is not None else 1
        super().__init__(timestep=int(timestep), precision=np.asarray(precision, float),
                         order=order, TAG=type(self).TAG)
        self.position = np.asarray(position, float)
        self.dposition = None if dposition is None else np.asarray(dposition, float)

    def state(self) -> np.ndarray:
        if self.order == 1:
            return np.asarray(self.position)
        return np.concatenate([self.position, self.dposition])

    fx_state = state


class AngularTimeKeypoint(AngularKeypoint):
    """AngularKeypoint + continuous-time target (AngularTimeKeypoint.cpp:12-24)."""

    TAG = "JNT_TIME"

    def __init__(self, position, precision, timestep, continuous_time, dposition=None):
        super().__init__(position, precision, timestep, dposition=dposition)
        self.continuous_time = float(continuous_time)

    def state(self) -> np.ndarray:
        return np.concatenate([super().state(), [self.continuous_time]])

    fx_state = state


@dataclasses.dataclass
class PointKeypoint(Keypoint):
    """Cartesian position-only via-point (extension for planar/position
    tracking; the reference's Robot2D has no working task-space system)."""

    position: np.ndarray = None
    dposition: Optional[np.ndarray] = None
    TAG: str = "POINT"

    def __init__(self, position, precision, timestep, dposition=None):
        order = 2 if dposition is not None else 1
        super().__init__(timestep=int(timestep), precision=np.asarray(precision, float),
                         order=order, TAG=type(self).TAG)
        self.position = np.asarray(position, float)
        self.dposition = None if dposition is None else np.asarray(dposition, float)

    def state(self) -> np.ndarray:
        if self.order == 1:
            return np.asarray(self.position)
        return np.concatenate([self.position, self.dposition])

    fx_state = state
