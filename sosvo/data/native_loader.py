"""ctypes bindings + writer for the native .sosq sequence streamer.

The C++ side (`native/seqloader.cpp`) is the framework's native data-loader
runtime component (SURVEY.md C17/section 2.3: the reference's frame IO rides
OpenCV's C++ decode; ours is a zlib + worker-thread prefetcher that feeds
the host side of the replay with one memcpy per frame). The library builds on
demand with g++ and is cached next to the source (`native/libseqloader.so`,
never committed).

Format .sosq v1 (little-endian):
  header:  u32 magic 'SOSQ' | u32 version=1 | u32 frames | u32 H | u32 W
           | u32 compressed
  table:   u64 offsets[frames + 1]   (byte offsets of each frame's stream)
  frames:  raw f32 or zlib streams, back to back
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
import zlib
from pathlib import Path

import numpy as np

_MAGIC = 0x51534F53
_SRC = Path(__file__).resolve().parents[2] / "native" / "seqloader.cpp"
_LIB = _SRC.parent / "libseqloader.so"


def _build_lib() -> Path:
    if _LIB.exists() and _LIB.stat().st_mtime >= _SRC.stat().st_mtime:
        return _LIB
    # Build under a per-process name and rename: processes that build at
    # once (parallel test workers) never load a half-written library.
    tmp = _LIB.with_name(f"{_LIB.name}.{os.getpid()}.tmp")
    subprocess.run(
        ["g++", "-O2", "-shared", "-fPIC", "-o", str(tmp), str(_SRC),
         "-lz", "-lpthread"],
        check=True, capture_output=True, text=True,
    )
    os.replace(tmp, _LIB)
    return _LIB


_lib_handle = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = ctypes.CDLL(str(_build_lib()))
        lib.sosq_open.restype = ctypes.c_void_p
        lib.sosq_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        for fn in (lib.sosq_frames, lib.sosq_height, lib.sosq_width):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p]
        lib.sosq_next.restype = ctypes.c_int
        lib.sosq_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
        lib.sosq_get.restype = ctypes.c_int
        lib.sosq_get.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_float)]
        lib.sosq_close.restype = None
        lib.sosq_close.argtypes = [ctypes.c_void_p]
        _lib_handle = lib
    return _lib_handle


def write_sosq(path: str | Path, frames: np.ndarray, compressed: bool = True) -> None:
    """Write (F, H, W) float32 frames as a .sosq bundle."""
    frames = np.ascontiguousarray(frames, np.float32)
    f_count, h, w = frames.shape
    payloads = []
    for i in range(f_count):
        raw = frames[i].tobytes()
        payloads.append(zlib.compress(raw, 6) if compressed else raw)
    header = struct.pack("<6I", _MAGIC, 1, f_count, h, w, int(compressed))
    base = len(header) + 8 * (f_count + 1)
    offsets = [base]
    for p in payloads:
        offsets.append(offsets[-1] + len(p))
    with open(path, "wb") as f:
        f.write(header)
        f.write(struct.pack(f"<{f_count + 1}Q", *offsets))
        for p in payloads:
            f.write(p)


class SosqReader:
    """Streaming reader over the native prefetcher."""

    def __init__(self, path: str | Path, readahead: int = 4):
        self._lib = _lib()
        self._h = self._lib.sosq_open(str(path).encode(), readahead)
        if not self._h:
            raise IOError(f"failed to open sosq file: {path}")
        self.frames = self._lib.sosq_frames(self._h)
        self.height = self._lib.sosq_height(self._h)
        self.width = self._lib.sosq_width(self._h)
        self._buf = np.empty((self.height, self.width), np.float32)

    def __len__(self) -> int:
        return self.frames

    def next(self) -> np.ndarray:
        rc = self._lib.sosq_next(
            self._h, self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise IOError(f"sosq_next failed: {rc}")
        return self._buf.copy()

    def get(self, idx: int) -> np.ndarray:
        rc = self._lib.sosq_get(
            self._h, idx, self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise IOError(f"sosq_get({idx}) failed: {rc}")
        return self._buf.copy()

    def close(self) -> None:
        if self._h:
            self._lib.sosq_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
