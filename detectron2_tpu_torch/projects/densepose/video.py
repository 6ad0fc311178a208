"""DensePose bootstrapping from videos: keyframe listing and decoding and
the frame selectors (counterpart of ``detectron2_tpu/projects/densepose/
video.py``; ``VideoKeyframeDataset`` :239), host code in numpy.

Decoding needs PyAV, imported in :func:`_open_av` only: without it
``list_keyframes`` returns no keyframes and ``read_keyframes`` no frames,
each with a warning, as the JAX package's do. ``VideoKeyframeDataset``
takes an injectable ``keyframe_lister`` and ``keyframe_reader``, so its
selection, transform and categories run without a decoder. Frames are
float32 ``[N, H, W, 3]`` BGR (NHWC), as the inference-based loader feeds
them to the bootstrap predictor.
"""

import csv
import logging
import os
import random
from enum import Enum
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

logger = logging.getLogger(__name__)

FrameTsList = List[int]
FrameSelector = Callable[[FrameTsList], FrameTsList]

__all__ = [
    "FrameSelectionStrategy",
    "RandomKFramesSelector",
    "FirstKFramesSelector",
    "LastKFramesSelector",
    "AllFramesSelector",
    "frame_selector_from_strategy",
    "list_keyframes",
    "maybe_prepend_base_path",
    "read_keyframes",
    "video_list_from_file",
    "read_keyframe_helper_data",
    "VideoKeyframeDataset",
]


class FrameSelectionStrategy(Enum):
    """Frame selection strategy used with videos (reference
    frame_selector.py:15-29): random_k / first_k / last_k / all."""

    RANDOM_K = "random_k"
    FIRST_K = "first_k"
    LAST_K = "last_k"
    ALL = "all"


class RandomKFramesSelector:
    """Retain at most ``k`` random frames (reference frame_selector.py:32-49)."""

    def __init__(self, k: int):
        self.k = k

    def __call__(self, frame_tss: FrameTsList) -> FrameTsList:
        return random.sample(frame_tss, min(self.k, len(frame_tss)))


class FirstKFramesSelector:
    """Retain at most ``k`` first frames (reference frame_selector.py:52-69)."""

    def __init__(self, k: int):
        self.k = k

    def __call__(self, frame_tss: FrameTsList) -> FrameTsList:
        return frame_tss[: self.k]


class LastKFramesSelector:
    """Retain at most ``k`` last frames (reference frame_selector.py:72-89)."""

    def __init__(self, k: int):
        self.k = k

    def __call__(self, frame_tss: FrameTsList) -> FrameTsList:
        return frame_tss[-self.k :]


class AllFramesSelector:
    def __call__(self, frame_tss: FrameTsList) -> FrameTsList:
        return list(frame_tss)


def frame_selector_from_strategy(strategy: FrameSelectionStrategy, k: int = 0) -> FrameSelector:
    """Build the selector for a strategy (the reference's build_frame_selector,
    data/build.py)."""
    if strategy == FrameSelectionStrategy.RANDOM_K:
        return RandomKFramesSelector(k)
    if strategy == FrameSelectionStrategy.FIRST_K:
        return FirstKFramesSelector(k)
    if strategy == FrameSelectionStrategy.LAST_K:
        return LastKFramesSelector(k)
    return AllFramesSelector()


def _open_av(video_fpath: str):
    import av  # the optional decoder: its absence is handled by the callers

    return av.open(video_fpath, mode="r")


def list_keyframes(video_fpath: str, video_stream_idx: int = 0) -> FrameTsList:
    """Keyframe timestamps (timebase counts) of a video via forward keyframe
    seeks, tolerating up to 2 backward-seek glitches (reference
    video_keyframe_dataset.py:26-101). Returns [] when PyAV is unavailable or
    the container cannot be read."""
    try:
        container = _open_av(video_fpath)
    except ImportError:
        logger.warning("list_keyframes: PyAV is not installed; returning no keyframes")
        return []
    except Exception as e:
        logger.warning(f"list_keyframes: error opening {video_fpath}: {e}")
        return []
    try:
        stream = container.streams.video[video_stream_idx]
        keyframes: FrameTsList = []
        pts = -1
        tolerance_backward_seeks = 2
        while True:
            try:
                container.seek(pts + 1, backward=False, any_frame=False, stream=stream)
            except Exception:
                # seeking past the end of the video: return what we have
                return keyframes
            packet = next(container.demux(video=video_stream_idx))
            if packet.pts is not None and packet.pts <= pts:
                tolerance_backward_seeks -= 1
                if tolerance_backward_seeks == 0:
                    return []
                pts += 1
                continue
            tolerance_backward_seeks = 2
            pts = packet.pts
            if pts is None:
                return keyframes
            if packet.is_keyframe:
                keyframes.append(pts)
    except Exception as e:
        logger.warning(f"list_keyframes: error reading {video_fpath}: {e}")
        return []
    finally:
        try:
            container.close()
        except Exception:
            pass


def read_keyframes(
    video_fpath: str, keyframes: FrameTsList, video_stream_idx: int = 0
) -> Optional[np.ndarray]:
    """Decode the frames at the given timestamps. Returns [N, H, W, 3] uint8
    RGB, or None on failure (reference video_keyframe_dataset.py:104-165)."""
    try:
        container = _open_av(video_fpath)
    except ImportError:
        logger.warning("read_keyframes: PyAV is not installed")
        return None
    except Exception as e:
        logger.warning(f"read_keyframes: error opening {video_fpath}: {e}")
        return None
    try:
        stream = container.streams.video[video_stream_idx]
        frames = []
        for pts in keyframes:
            try:
                container.seek(pts, any_frame=False, stream=stream)
                frame = next(container.decode(video=0))
                frames.append(frame.to_rgb().to_ndarray())
            except Exception as e:
                logger.warning(f"read_keyframes: error at pts {pts} of {video_fpath}: {e}")
                break
        return np.stack(frames) if frames else None
    except Exception as e:
        logger.warning(f"read_keyframes: error reading {video_fpath}: {e}")
        return None
    finally:
        try:
            container.close()
        except Exception:
            pass


def maybe_prepend_base_path(base_path: Optional[str], path: str) -> str:
    """``path`` under ``base_path``, unless it is absolute or a URL."""
    if base_path is None or path.startswith(("/", "http://", "https://")):
        return path
    return os.path.join(base_path, path)


def video_list_from_file(video_list_fpath: str, base_path: Optional[str] = None) -> List[str]:
    """Plain-text list of video paths, one per line (reference
    video_keyframe_dataset.py:167-179)."""
    video_list = []
    with open(video_list_fpath, "r") as io:
        for line in io:
            line = line.strip()
            if line:
                video_list.append(maybe_prepend_base_path(base_path, line))
    return video_list


def read_keyframe_helper_data(fpath: str) -> Dict[int, FrameTsList]:
    """CSV with header (video_id, keyframes), keyframes like "[1,11,21]"
    (reference video_keyframe_dataset.py:182-219)."""
    video_id_to_keyframes: Dict[int, FrameTsList] = {}
    try:
        with open(fpath, "r") as io:
            reader = csv.reader(io)
            header = next(reader)
            vid_idx = header.index("video_id")
            kf_idx = header.index("keyframes")
            for row in reader:
                video_id = int(row[vid_idx])
                assert (
                    video_id not in video_id_to_keyframes
                ), f"Duplicate keyframes entry for video {fpath}"
                video_id_to_keyframes[video_id] = (
                    [int(v) for v in row[kf_idx][1:-1].split(",")]
                    if len(row[kf_idx]) > 2
                    else []
                )
    except Exception as e:
        logger.warning(f"Error reading keyframe helper data from {fpath}: {e}")
    return video_id_to_keyframes


class VideoKeyframeDataset:
    """Keyframes (+ categories) per video, for bootstrapping inference
    (reference video_keyframe_dataset.py:222-307).

    Yields {"images": float32 [N, H, W, 3] BGR (NHWC; d2 yields NCHW
    tensors), "categories": List[str]}.
    """

    _EMPTY_FRAMES = np.empty((0, 1, 1, 3), dtype=np.float32)

    def __init__(
        self,
        video_list: List[str],
        category_list: Union[str, List[str], None] = None,
        frame_selector: Optional[FrameSelector] = None,
        transform: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        keyframe_helper_fpath: Optional[str] = None,
        keyframe_lister: Callable[[str], FrameTsList] = list_keyframes,
        keyframe_reader: Callable[[str, FrameTsList], Optional[np.ndarray]] = read_keyframes,
    ):
        if isinstance(category_list, list):
            self.category_list = category_list
        else:
            self.category_list = [category_list] * len(video_list)
        assert len(video_list) == len(
            self.category_list
        ), "length of video and category lists must be equal"
        self.video_list = video_list
        self.frame_selector = frame_selector
        self.transform = transform
        self.keyframe_helper_data = (
            read_keyframe_helper_data(keyframe_helper_fpath)
            if keyframe_helper_fpath is not None
            else None
        )
        self.keyframe_lister = keyframe_lister
        self.keyframe_reader = keyframe_reader

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        categories = [self.category_list[idx]]
        fpath = self.video_list[idx]
        keyframes = (
            self.keyframe_lister(fpath)
            if self.keyframe_helper_data is None or idx not in self.keyframe_helper_data
            else self.keyframe_helper_data[idx]
        )
        if not keyframes:
            return {"images": self._EMPTY_FRAMES, "categories": []}
        if self.frame_selector is not None:
            keyframes = self.frame_selector(keyframes)
        frames = self.keyframe_reader(fpath, keyframes)
        if frames is None or len(frames) == 0:
            return {"images": self._EMPTY_FRAMES, "categories": []}
        frames = frames[..., ::-1].astype(np.float32)  # RGB -> BGR, NHWC kept
        if self.transform is not None:
            frames = self.transform(frames)
        return {"images": frames, "categories": categories}

    def __len__(self):
        return len(self.video_list)
