"""ctypes bindings and the on-demand build of the native libav video decoder
(counterpart of ``eilev_tpu/native/decoder.py``).

The port's own copy of ``video_decoder.cpp`` is compiled once with ``g++``
against the system's libav (``-lavformat -lavcodec -lavutil -lswscale``)
into ``build/eilev_tpu_torch/`` through ``ops/_build.py``'s cache (keyed by
the source, locked against parallel builders, renamed into place whole);
nothing is written beside the sources. Decode calls run without the GIL, so
a thread pool of decoders overlaps host decode with device compute. A host
without g++ or libav's headers has no decoder: :func:`decoder_available`
says so and :class:`VideoDecoder` raises ``RuntimeError``.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "video_decoder.cpp"
LIBS = ("-lavformat", "-lavcodec", "-lavutil", "-lswscale")
_BUILD_LOCK = threading.Lock()
_LIB_HANDLE: Optional[ctypes.CDLL] = None
_BUILD_ERROR: Optional[str] = None


def library_path() -> Path:
    """Where the decoder's library is built: ``build/eilev_tpu_torch/``."""
    from ..ops._build import host_library_path

    return host_library_path(SOURCE, LIBS)


def _load() -> Optional[ctypes.CDLL]:
    global _LIB_HANDLE, _BUILD_ERROR
    if _LIB_HANDLE is not None:
        return _LIB_HANDLE
    with _BUILD_LOCK:
        if _LIB_HANDLE is not None:
            return _LIB_HANDLE
        from ..ops._build import build_host

        try:
            lib = ctypes.CDLL(str(build_host(SOURCE, LIBS)))
        except (OSError, RuntimeError) as e:  # no g++, no libav headers, a failed build
            _BUILD_ERROR = f"build failed: {e}"
            return None
        lib.vd_open.restype = ctypes.c_void_p
        lib.vd_open.argtypes = [ctypes.c_char_p]
        lib.vd_error.restype = ctypes.c_char_p
        lib.vd_error.argtypes = [ctypes.c_void_p]
        lib.vd_duration.restype = ctypes.c_double
        lib.vd_duration.argtypes = [ctypes.c_void_p]
        lib.vd_fps.restype = ctypes.c_double
        lib.vd_fps.argtypes = [ctypes.c_void_p]
        lib.vd_width.restype = ctypes.c_int
        lib.vd_width.argtypes = [ctypes.c_void_p]
        lib.vd_height.restype = ctypes.c_int
        lib.vd_height.argtypes = [ctypes.c_void_p]
        lib.vd_close.argtypes = [ctypes.c_void_p]
        lib.vd_decode_clip.restype = ctypes.c_int
        lib.vd_decode_clip.argtypes = [
            ctypes.c_void_p,
            ctypes.c_double,
            ctypes.c_double,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte),
        ]
        _LIB_HANDLE = lib
        return lib


def decoder_available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    _load()
    return _BUILD_ERROR


class VideoDecoder:
    """One open video file; decode uniform-sampled clips as (C, T, H, W) uint8."""

    def __init__(self, path: str):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native decoder unavailable: {_BUILD_ERROR}")
        self._lib = lib
        self._h = lib.vd_open(path.encode())
        err = lib.vd_error(self._h).decode()
        if err:
            msg = f"{path}: {err}"
            lib.vd_close(self._h)
            self._h = None
            raise RuntimeError(msg)

    @property
    def duration(self) -> float:
        return self._lib.vd_duration(self._h)

    @property
    def fps(self) -> float:
        return self._lib.vd_fps(self._h)

    @property
    def size(self) -> tuple[int, int]:
        return self._lib.vd_height(self._h), self._lib.vd_width(self._h)

    def decode_clip(
        self,
        start_sec: float,
        end_sec: float,
        num_frames: int,
        *,
        height: int = 0,
        width: int = 0,
    ) -> np.ndarray:
        """Returns (C=3, num_frames, H, W) uint8 RGB."""
        h = height or self.size[0]
        w = width or self.size[1]
        out = np.empty((num_frames, h, w, 3), np.uint8)
        ret = self._lib.vd_decode_clip(
            self._h,
            float(start_sec),
            float(end_sec),
            int(num_frames),
            int(h),
            int(w),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        )
        if ret != 0:
            raise RuntimeError(
                f"decode failed ({ret}): {self._lib.vd_error(self._h).decode()}"
            )
        return np.ascontiguousarray(out.transpose(3, 0, 1, 2))

    def close(self) -> None:
        if self._h is not None:
            self._lib.vd_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
