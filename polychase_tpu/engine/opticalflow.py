"""Optical-flow database generation (the "Analyze Video" pipeline).

Rebuild of the reference pipeline (cpp/opticalflow.cc:209-321):
for every frame, detect-or-load keypoints, build an LK pyramid, and track
into the neighbor frames of the ±{1, 2, 4, 8} skip pattern
(cpp/opticalflow.cc:76-78), writing each pair's surviving flows to the
SQLite database.  Differences from the reference, by design:

- the per-skip-pair TBB thread pool (cpp/opticalflow.cc:269-309) is
  replaced by the device itself: each LK solve already batches every
  feature, so pairs are dispatched back-to-back to the accelerator;
- decoded frames are cached as *prepared pyramids* (padded levels +
  Scharr derivatives, the expensive part) in an LRU keyed by frame id —
  the analogue of the reference's 17-frame ring buffer
  (cpp/opticalflow_thread.h:34-79);
- the pipeline is resumable exactly like the reference: existing
  keypoints are reused and existing pair flows skipped
  (cpp/opticalflow.cc:168-178, :286).

The progress callback returns False to cancel (cpp/opticalflow.cc:238-247).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, NamedTuple, Optional

import numpy as np

from ..io.database import Database
from ..obs import get_logger, profile_region
from .gftt import (
    GFTTOptions,
    device_suppress_route,
    gftt_dispatch,
    gftt_finish,
)
from .lk import (
    LKOptions,
    PyramidCache,
    calc_optical_flow,
    calc_optical_flow_multi,
    calc_optical_flow_multi_async,
    calc_optical_flow_multi_finish,
    chain_engages,
    prepare_pyramid,
    prepare_pyramid_with_gftt,
)

# Skip pattern (cpp/opticalflow.cc:76-78)
IMAGE_SKIPS = (-8, -4, -2, -1, 1, 2, 4, 8)

# FrameAccessorFunction: frame_id -> (H, W, 3) uint8 RGB or None
FrameAccessor = Callable[[int], Optional[np.ndarray]]
# OpticalFlowProgressCallback: (progress, message) -> continue?
ProgressCallback = Callable[[float, str], bool]

OpticalFlowOptions = LKOptions  # same fields (cpp/opticalflow.h:27-33)


class VideoInfo(NamedTuple):
    """Clip geometry (cpp/opticalflow.h:20-25)."""

    width: int
    height: int
    first_frame: int
    num_frames: int


def rgb_to_gray(frame: np.ndarray) -> np.ndarray:
    """RGB→gray with OpenCV's fixed-point BT.601 weights
    (cv::COLOR_RGB2GRAY; used at cpp/opticalflow.cc:259)."""
    f = frame.astype(np.uint32)
    y = (f[..., 0] * 4899 + f[..., 1] * 9617 + f[..., 2] * 1868 + 8192) >> 14
    return y.astype(np.uint8)


class _PyramidLRU:
    """LRU of prepared pyramids, the 17-slot ring-buffer analogue."""

    def __init__(self, capacity: int = 17):
        self.capacity = capacity
        self._store: OrderedDict[int, PyramidCache] = OrderedDict()

    def get(self, frame_id: int) -> Optional[PyramidCache]:
        pyr = self._store.get(frame_id)
        if pyr is not None:
            self._store.move_to_end(frame_id)
        return pyr

    def put(self, frame_id: int, pyr: PyramidCache) -> None:
        self._store[frame_id] = pyr
        self._store.move_to_end(frame_id)
        while len(self._store) > self.capacity:
            self._store.popitem(last=False)


class FrameNotProvidedError(RuntimeError):
    pass


def generate_optical_flow_database(
    video_info: VideoInfo,
    frame_accessor: FrameAccessor,
    callback: Optional[ProgressCallback],
    database_path: str,
    detector_options: GFTTOptions = GFTTOptions(),
    flow_options: OpticalFlowOptions = OpticalFlowOptions(),
    write_images: bool = False,
) -> None:
    """Generate keypoints + pairwise flows for a clip
    (cpp/opticalflow.cc:209-321).

    ``write_images`` dumps debug PNGs next to the database like the
    reference (cpp/opticalflow.cc:80-96) when a ``frames`` directory is
    writable; it is best-effort.
    """
    if frame_accessor is None:
        raise ValueError("frame_accessor is required")

    db = Database(database_path)
    try:
        _run(
            db, video_info, frame_accessor, callback,
            detector_options, flow_options, write_images, database_path,
        )
    finally:
        db.close()


def _get_gray(
    frame_accessor: FrameAccessor, video_info: VideoInfo, frame_id: int
) -> np.ndarray:
    frame = frame_accessor(frame_id)
    if frame is None:
        raise FrameNotProvidedError(
            f"Requested frame #{frame_id} was not provided"
        )
    frame = np.asarray(frame)
    if frame.ndim == 3 and frame.shape[2] == 3:
        if (
            frame.shape[0] != video_info.height
            or frame.shape[1] != video_info.width
        ):
            raise ValueError(
                f"frame #{frame_id} has shape {frame.shape[:2]}, expected "
                f"({video_info.height}, {video_info.width})"
            )
        return rgb_to_gray(frame)
    if frame.ndim == 2:
        return frame.astype(np.uint8, copy=False)
    raise ValueError("frames must be (H, W, 3) RGB or (H, W) gray")


_log = get_logger("opticalflow")


def _run(
    db: Database,
    video_info: VideoInfo,
    frame_accessor: FrameAccessor,
    callback: Optional[ProgressCallback],
    detector_options: GFTTOptions,
    flow_options: OpticalFlowOptions,
    write_images: bool,
    database_path: str,
) -> None:
    first = video_info.first_frame
    last = video_info.first_frame + video_info.num_frames  # exclusive
    # Capacity must cover the live window [i-8, i+8+PYR_LOOKAHEAD] so the
    # prefetched pyramids are never evicted before use (17 slots = the
    # reference's ring; +PYR_LOOKAHEAD+headroom for the prefetch depth).
    cache = _PyramidLRU(25)

    frames_dir = None
    if write_images:
        import os

        frames_dir = os.path.join(
            os.path.dirname(os.path.abspath(database_path)), "frames"
        )
        os.makedirs(frames_dir, exist_ok=True)

    gray_cache = _PyramidLRU(25)  # generic LRU; stores np arrays here
    dev_cache = _PyramidLRU(25)   # device-resident uint8 frames

    def gray_of(frame_id: int) -> np.ndarray:
        g = gray_cache.get(frame_id)
        if g is None:
            g = _get_gray(frame_accessor, video_info, frame_id)
            gray_cache.put(frame_id, g)
        return g

    def dev_gray_of(frame_id: int):
        """One uint8 upload per frame, shared by GFTT and the pyramid
        prep (uploading twice as f32 costs 8× the link traffic)."""
        import jax

        d = dev_cache.get(frame_id)
        if d is None:
            d = jax.device_put(gray_of(frame_id))
            dev_cache.put(frame_id, d)
        return d

    def get_pyramid(frame_id: int):
        pyr = cache.get(frame_id)
        if pyr is None:
            pyr = prepare_pyramid(dev_gray_of(frame_id), flow_options)
            cache.put(frame_id, pyr)
        return pyr

    # Fused detection: GFTT's response + top-k ride the pyramid-prep
    # dispatch (one program, shared upload) instead of a separate
    # device-serial program (~3.4 ms/frame at 640p, mostly dispatch
    # cost).  Masked and device-suppressed routes keep the dedicated
    # program; POLYCHASE_GFTT_PREP_FUSED=0 restores split dispatches.
    import os as _os_f

    fuse_gftt = (
        _os_f.environ.get("POLYCHASE_GFTT_PREP_FUSED", "1") != "0"
        and not device_suppress_route(
            video_info.width * video_info.height, detector_options
        )
    )

    def ensure_gftt(fa: int) -> None:
        """Queue detection for ``fa`` if its keypoints don't exist yet."""
        if fa in gftt_pending or fa in gftt_skip:
            return
        if db.read_keypoints(fa).shape[0] > 0:
            gftt_skip.add(fa)
            return
        if fuse_gftt and cache.get(fa) is None:
            pyr, disp = prepare_pyramid_with_gftt(
                dev_gray_of(fa), flow_options, detector_options
            )
            cache.put(fa, pyr)
            gftt_pending[fa] = disp
            return
        gftt_pending[fa] = gftt_dispatch(
            dev_gray_of(fa), None, detector_options
        )

    # Software pipeline: GFTT for upcoming frames is dispatched ahead,
    # and LK result transfers are deferred one frame, so host work (greedy
    # suppression, SQLite writes) and the device<->host link overlap device
    # compute.  The reference overlaps work with a 4-thread TBB pool
    # (cpp/opticalflow.cc:269-309); here asynchronous dispatch plays that
    # role with a single Python thread.
    LOOKAHEAD = 4
    gftt_pending: dict = {}
    gftt_skip: set = set()
    from collections import deque

    pending_flows: deque = deque()

    # Missing-flow targets per source frame (cpp/opticalflow.cc:286):
    # cached because prefetch consults future frames repeatedly.  Entries
    # are computed before their source frame is processed and nothing
    # writes a future source's pairs in between, so they never go stale.
    target_cache: dict = {}

    def missing_targets(fid: int):
        tg = target_cache.get(fid)
        if tg is None:
            tg = [
                fid + skip
                for skip in IMAGE_SKIPS
                if first <= fid + skip < last
                and not db.image_pair_flow_exists(fid, fid + skip)
            ]
            target_cache[fid] = tg
        return tg

    def flush_one():
        frame_id1, targets, handle = pending_flows.popleft()
        tracked, status, err = calc_optical_flow_multi_finish(handle)
        # One sqlite commit for the frame's whole skip fan-out: per-pair
        # commits cost ~2.7 ms/frame on the 1-core host (stage table).
        with db.deferred_commits():
            for i, frame_id2 in enumerate(targets):
                st = status[i]
                keep = np.nonzero(st)[0].astype(np.uint32)
                db.write_image_pair_flow(
                    frame_id1, frame_id2, keep, tracked[i][st], err[i][st]
                )

    cancelled = False
    for frame_id1 in range(first, last):
        if callback is not None:
            progress = (frame_id1 - first) / max(video_info.num_frames, 1)
            if not callback(progress, f"Processing frame {frame_id1}"):
                cancelled = True
                break

        # The current frame's detection must be in flight before its LK
        # dispatch (steady state: queued by an earlier iteration's
        # post-LK prefetch; clip start / cache miss: dispatched here).
        ensure_gftt(frame_id1)

        # Read-or-generate keypoints (cpp/opticalflow.cc:154-178)
        features = db.read_keypoints(frame_id1)
        if features.shape[0] == 0 and frame_id1 in gftt_pending:
            features, _quality = gftt_finish(gftt_pending.pop(frame_id1))
            db.write_keypoints(frame_id1, features)
            _log.debug(
                "frame %d: detected %d keypoints", frame_id1,
                features.shape[0],
            )

        if write_images and frames_dir is not None:
            _save_debug_image(
                gray_of(frame_id1), frame_id1, frames_dir, features
            )

        if features.shape[0] == 0:
            continue

        # Batch every needed skip target into one device dispatch
        # (the reference's 4-thread pair pool, cpp/opticalflow.cc:269-309,
        # becomes a batch axis).
        targets = missing_targets(frame_id1)

        if not targets:
            continue
        pyr1 = get_pyramid(frame_id1)
        pyrs2 = [get_pyramid(f2) for f2 in targets]
        skips = [f2 - frame_id1 for f2 in targets]
        if not chain_engages(skips, features.shape[0]):
            skips = None
        _log.debug(
            "frame %d: tracking %d features into %s",
            frame_id1, features.shape[0], targets,
        )
        with profile_region("analyze.lk"):
            handle = calc_optical_flow_multi_async(
                pyr1, pyrs2, features, flow_options, skips=skips
            )
        pending_flows.append((frame_id1, targets, handle))

        # Prefetch pyramid prep for UPCOMING source frames and their
        # missing-flow targets, AFTER this frame's dispatch: the uploads
        # + prep programs queue behind the in-flight LK work instead of
        # delaying it (at clip start this halves the serial ramp before
        # the first LK).  Resume runs (all flows present) must not touch
        # the frame accessor at all, so prefetch is gated on the DB's
        # missing-pair set.
        for fs in range(frame_id1 + 1, min(frame_id1 + LOOKAHEAD + 1, last)):
            tg = missing_targets(fs)
            if tg:
                # Detection first: on the fused route it also creates
                # fs's pyramid in the same dispatch.
                ensure_gftt(fs)
                get_pyramid(fs)
                for f2 in tg:
                    get_pyramid(f2)

        # Keep several solves in flight: the finish of frame i-k overlaps
        # the device compute of frames i-k+1..i.  The default depth is not
        # measured on the GPU; POLYCHASE_LK_INFLIGHT overrides.
        import os as _os

        depth = int(_os.environ.get("POLYCHASE_LK_INFLIGHT", "5"))
        while len(pending_flows) > depth:
            flush_one()

    while pending_flows:
        flush_one()
    if callback is not None:
        callback(1.0, "Cancelled" if cancelled else "Done")


def _save_debug_image(gray, frame_id, frames_dir, features):
    """Best-effort debug dump (cpp/opticalflow.cc:80-96)."""
    try:
        import cv2

        cv2.imwrite(f"{frames_dir}/{frame_id:06d}.png", gray)
        vis = cv2.cvtColor(gray, cv2.COLOR_GRAY2BGR)
        for x, y in features.astype(int):
            cv2.drawMarker(vis, (int(x), int(y)), (0, 255, 0),
                           cv2.MARKER_CROSS, 10)
        cv2.imwrite(f"{frames_dir}/keypoints_{frame_id:06d}.png", vis)
    except Exception:
        pass
