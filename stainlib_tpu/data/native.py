"""ctypes bindings + on-demand build of the native tile pipeline.

The C++ core (``_native/tilereader.cpp``) plays the role of the reference's
native data plumbing (OpenSlide/PyVips decode + OpenCV morphology inside
``data_utils.py:1``). It is compiled once with g++ into the package tree and
loaded via ctypes (no pybind11 dependency). Every entry point has a numpy
fallback so the framework degrades gracefully on hosts without a compiler.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "_native", "tilereader.cpp")
_LIB_PATH = os.path.join(_DIR, "_native", "libtilereader.so")
_TIFF_SRC = os.path.join(_DIR, "_native", "tiffreader.cpp")
_TIFF_LIB_PATH = os.path.join(_DIR, "_native", "libtiffreader.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False
_tiff_lib: Optional[ctypes.CDLL] = None
_tiff_build_failed = False

MAGIC = 0x31525357  # "WSR1"


def build_native(force: bool = False) -> Optional[str]:
    """Compile the shared library if needed. Returns its path or None."""
    global _build_failed
    if (os.path.exists(_LIB_PATH) and not force
            and (not os.path.exists(_SRC)  # stripped install: lib only
                 or os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SRC))):
        return _LIB_PATH
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
             _SRC, "-o", _LIB_PATH],
            check=True, capture_output=True,
        )
        return _LIB_PATH
    except (OSError, subprocess.CalledProcessError):
        _build_failed = True
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if necessary) the native library; None if unavailable."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        path = build_native()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            # A present-but-unloadable .so (foreign arch/glibc): degrade to
            # the numpy fallbacks instead of raising from every entry point.
            _build_failed = True
            return None
        lib.tr_open.restype = ctypes.c_void_p
        lib.tr_open.argtypes = [ctypes.c_char_p]
        lib.tr_close.argtypes = [ctypes.c_void_p]
        lib.tr_num_levels.argtypes = [ctypes.c_void_p]
        lib.tr_num_levels.restype = ctypes.c_int
        lib.tr_level_size.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.tr_read_region.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.tr_read_region.restype = ctypes.c_int
        lib.tr_sample_tiles.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint64, ctypes.c_double, ctypes.c_double,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_double,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.tr_sample_tiles.restype = ctypes.c_int
        lib.tr_tissue_mask.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.tr_tissue_mask.restype = ctypes.c_int
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def get_tiff_lib() -> Optional[ctypes.CDLL]:
    """Load (building against the system libtiff if necessary) the TIFF
    reader; None when libtiff or a compiler is unavailable."""
    global _tiff_lib, _tiff_build_failed
    with _lock:
        if _tiff_lib is not None:
            return _tiff_lib
        if _tiff_build_failed:
            return None
        if not os.path.exists(_TIFF_LIB_PATH) or (
            os.path.exists(_TIFF_SRC)  # stripped install: lib only
            and os.path.getmtime(_TIFF_LIB_PATH) < os.path.getmtime(_TIFF_SRC)
        ):
            try:
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                     "-pthread", _TIFF_SRC, "-ltiff", "-o", _TIFF_LIB_PATH],
                    check=True, capture_output=True,
                )
            except (OSError, subprocess.CalledProcessError):
                _tiff_build_failed = True
                return None
        try:
            lib = ctypes.CDLL(_TIFF_LIB_PATH)
        except OSError:
            _tiff_build_failed = True
            return None
        lib.tf_open.restype = ctypes.c_void_p
        lib.tf_open.argtypes = [ctypes.c_char_p]
        lib.tf_close.argtypes = [ctypes.c_void_p]
        lib.tf_num_levels.argtypes = [ctypes.c_void_p]
        lib.tf_num_levels.restype = ctypes.c_int
        lib.tf_level_size.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.tf_read_region.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.tf_read_region.restype = ctypes.c_int
        lib.tf_read_regions.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.tf_read_regions.restype = ctypes.c_int
        lib.tf_sample_tiles.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint64, ctypes.c_double, ctypes.c_double,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_double,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.tf_sample_tiles.restype = ctypes.c_int
        lib.tf_writer_open.restype = ctypes.c_void_p
        lib.tf_writer_open.argtypes = [ctypes.c_char_p]
        lib.tf_writer_add_level.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
        ]
        lib.tf_writer_add_level.restype = ctypes.c_int
        lib.tf_writer_close.argtypes = [ctypes.c_void_p]
        _tiff_lib = lib
        return _tiff_lib


def tiff_native_available() -> bool:
    return get_tiff_lib() is not None


# ---------------------------------------------------------------------------
# WSIRAW ("WSR1") pyramid container
# ---------------------------------------------------------------------------


def write_wsiraw(path: str, levels) -> None:
    """Write a raw RGB pyramid: header (magic, n_levels, per-level w/h/pad)
    followed by contiguous uint8 HWC planes, coarsest last. ``levels``:
    sequence of (H, W, 3) uint8 arrays, level 0 first (full resolution)."""
    with open(path, "wb") as f:
        f.write(np.uint32(MAGIC).tobytes())
        f.write(np.uint32(len(levels)).tobytes())
        for lv in levels:
            h, w, c = lv.shape
            assert c == 3 and lv.dtype == np.uint8
            f.write(np.uint32(w).tobytes())
            f.write(np.uint32(h).tobytes())
            f.write(np.zeros(2, np.uint32).tobytes())  # reserved
        for lv in levels:
            f.write(np.ascontiguousarray(lv).tobytes())


class _SlideBase:
    """Shared native-with-numpy-fallback slide handle: level geometry,
    white-filled ``read_region``, and rejection ``sample_tiles`` (the
    trainer-mode rules of ``data_utils.py:1``). Subclasses set the C-ABI
    prefix (``tr_``/``tf_``) and provide the fallback level loader."""

    _PREFIX = ""

    def __init__(self, path: str):
        self.path = path
        self._lib = self._get_lib()
        self._handle = None
        self._np_levels = None
        if self._lib is not None:
            self._handle = self._fn("open")(path.encode())
        if not self._handle:
            self._lib = None
            self._np_levels = self._load_fallback(path)

    # -- subclass hooks -----------------------------------------------------
    def _get_lib(self):
        raise NotImplementedError

    def _load_fallback(self, path: str):
        raise NotImplementedError

    def _fn(self, name: str):
        return getattr(self._lib, self._PREFIX + name)

    # -- shared API ----------------------------------------------------------
    @property
    def native(self) -> bool:
        return self._handle is not None

    @property
    def num_levels(self) -> int:
        if self.native:
            return self._fn("num_levels")(self._handle)
        return len(self._np_levels)

    def _check_level(self, level: int):
        n = self.num_levels
        if not 0 <= level < n:
            raise IndexError(f"level {level} out of range for "
                             f"{n}-level slide {self.path!r}")

    def level_size(self, level: int) -> Tuple[int, int]:
        """(width, height)."""
        self._check_level(level)
        if self.native:
            w = ctypes.c_uint32()
            h = ctypes.c_uint32()
            self._fn("level_size")(self._handle, level, ctypes.byref(w),
                                   ctypes.byref(h))
            return w.value, h.value
        lv = self._np_levels[level]
        return lv.shape[1], lv.shape[0]

    def read_region(self, level: int, x: int, y: int, w: int, h: int):
        """(h, w, 3) uint8; out-of-bounds filled white."""
        self._check_level(level)
        out = np.empty((h, w, 3), np.uint8)
        if self.native:
            rc = self._fn("read_region")(
                self._handle, level, x, y, w, h,
                out.ctypes.data_as(ctypes.c_void_p),
            )
            if rc != 0:
                raise OSError(
                    f"{self._PREFIX}read_region failed (rc={rc}) on "
                    f"{self.path!r} level {level} at ({x}, {y})")
            return out
        lv = self._np_levels[level]
        out[:] = 255
        x0, y0 = max(x, 0), max(y, 0)
        x1, y1 = min(x + w, lv.shape[1]), min(y + h, lv.shape[0])
        if x0 < x1 and y0 < y1:
            out[y0 - y : y1 - y, x0 - x : x1 - x] = lv[y0:y1, x0:x1]
        return out

    def sample_tiles(self, level: int, tile: int, n: int, seed: int = 0,
                     white_mean_max: float = 230.0, stddev_min: float = 15.0,
                     mask: Optional[np.ndarray] = None,
                     mask_scale: float = 0.0,
                     max_attempts: int = 50):
        """Random tissue tiles with rejection (trainer-mode sampling rules
        of ``data_utils.py:1``). Returns (tiles (n,t,t,3), coords (n,2));
        coords are (-1,-1) for slots that exhausted their attempts (or when
        the level is smaller than the tile), with mid-gray filler tiles."""
        self._check_level(level)
        # Pre-fill the documented failure contract: the native samplers
        # return early without touching the buffers when the level is
        # smaller than the tile, and np.empty garbage must never be
        # mistaken for tiles.
        out = np.full((n, tile, tile, 3), 128, np.uint8)
        coords = np.full((n, 2), -1, np.int64)
        if self.native:
            m_ptr = None
            mw = mh = 0
            if mask is not None:
                mask = np.ascontiguousarray(mask.astype(np.uint8))
                m_ptr = mask.ctypes.data_as(ctypes.c_void_p)
                mh, mw = mask.shape
            rc = self._fn("sample_tiles")(
                self._handle, level, tile, n, seed, white_mean_max,
                stddev_min, m_ptr, mw, mh, mask_scale, max_attempts,
                out.ctypes.data_as(ctypes.c_void_p),
                coords.ctypes.data_as(ctypes.c_void_p),
            )
            if rc < 0:
                raise OSError(
                    f"{self._PREFIX}sample_tiles failed (rc={rc}) on "
                    f"{self.path!r} level {level}")
            return out, coords
        rng = np.random.default_rng(seed)
        W, H = self.level_size(level)
        if W < tile or H < tile:
            return out, coords  # same contract as the native early return
        for i in range(n):
            for _ in range(max_attempts):
                x = int(rng.integers(0, W - tile + 1))
                y = int(rng.integers(0, H - tile + 1))
                if mask is not None:
                    mx = min(int(x * mask_scale), mask.shape[1] - 1)
                    my = min(int(y * mask_scale), mask.shape[0] - 1)
                    if not mask[my, mx]:
                        continue
                patch = self.read_region(level, x, y, tile, tile)
                if patch.mean() > white_mean_max or patch.std() < stddev_min:
                    continue
                out[i] = patch
                coords[i] = (x, y)
                break
        return out, coords

    def close(self):
        if self.native and self._handle:
            self._fn("close")(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class RawSlide(_SlideBase):
    """Handle over a WSIRAW pyramid, native-backed with numpy fallback.

    API mirrors what the WSI sampler needs from OpenSlide/pyvips
    (``read_region`` / level geometry; ``data_utils.py:1``).
    """

    _PREFIX = "tr_"

    def _get_lib(self):
        return get_lib()

    def _load_fallback(self, path: str):
        return _read_wsiraw_numpy(path)


def _read_wsiraw_numpy(path: str):
    with open(path, "rb") as f:
        head = np.frombuffer(f.read(8), np.uint32)
        assert head[0] == MAGIC, "not a WSIRAW file"
        n = int(head[1])
        geom = np.frombuffer(f.read(16 * n), np.uint32).reshape(n, 4)
        levels = []
        for i in range(n):
            w, h = int(geom[i, 0]), int(geom[i, 1])
            levels.append(
                np.frombuffer(f.read(3 * w * h), np.uint8).reshape(h, w, 3)
            )
    return levels


# ---------------------------------------------------------------------------
# Tiled-TIFF (.svs / pyramidal .tif) ingestion
# ---------------------------------------------------------------------------

# TIFF compression tags accepted by write_tiff_pyramid.
TIFF_COMPRESSION = {"none": 1, "lzw": 5, "jpeg": 7, "deflate": 8}


def write_tiff_pyramid(path: str, levels, tile: int = 256,
                       compression: str = "jpeg", quality: int = 90) -> None:
    """Write a tiled pyramidal TIFF (the .svs container layout: baseline IFD
    first, reduced-resolution IFDs after). ``levels``: (H, W, 3) uint8
    arrays, level 0 first. JPEG levels are stored as YCbCr like Aperio."""
    lib = get_tiff_lib()
    if lib is None:
        raise RuntimeError("native TIFF writer unavailable (libtiff/g++)")
    comp = TIFF_COMPRESSION[compression]
    if comp == 7 and tile % 16 != 0:
        raise ValueError("JPEG tiles must be multiples of 16")
    handle = lib.tf_writer_open(path.encode())
    if not handle:
        raise OSError(f"cannot create {path}")
    try:
        for i, lv in enumerate(levels):
            assert lv.dtype == np.uint8 and lv.shape[-1] == 3
            lv = np.ascontiguousarray(lv)
            rc = lib.tf_writer_add_level(
                handle, lv.shape[1], lv.shape[0],
                lv.ctypes.data_as(ctypes.c_void_p), tile, comp, quality,
                1 if i else 0,
            )
            if rc != 0:
                raise OSError(f"TIFF level write failed ({rc})")
    finally:
        lib.tf_writer_close(handle)


class TiffSlide(_SlideBase):
    """Handle over a tiled/stripped pyramidal TIFF (.svs, .tif): the
    OpenSlide.read_region / pyvips.Region.fetch replacement
    (``data_utils.py:1``). Native libtiff decode with a PIL fallback."""

    _PREFIX = "tf_"

    def _get_lib(self):
        return get_tiff_lib()

    def _load_fallback(self, path: str):
        return _read_tiff_pil(path)

    def read_regions(self, level: int, coords, w: int, h: int):
        """Batched ``read_region``: (n, h, w, 3) uint8 decoded concurrently
        across the handle pool (one C call, threaded) — the eval-stream
        counterpart of the threaded train-mode sampler (the reference
        tester's exhaustive deployment loop, ``data_utils.py:1``). Failed
        regions come back mid-gray, like the sampler's slot substitution."""
        self._check_level(level)
        coords = np.ascontiguousarray(coords, np.int64).reshape(-1, 2)
        n = len(coords)
        out = np.empty((n, h, w, 3), np.uint8)
        if self.native:
            xs = np.ascontiguousarray(coords[:, 0])
            ys = np.ascontiguousarray(coords[:, 1])
            rc = self._lib.tf_read_regions(
                self._handle, level, xs.ctypes.data_as(ctypes.c_void_p),
                ys.ctypes.data_as(ctypes.c_void_p), n, w, h,
                out.ctypes.data_as(ctypes.c_void_p),
            )
            if rc < 0:
                raise OSError(f"tf_read_regions failed (rc={rc}) on "
                              f"{self.path!r} level {level}")
            return out
        for i, (x, y) in enumerate(coords):
            out[i] = self.read_region(level, int(x), int(y), w, h)
        return out


def _read_tiff_pil(path: str):
    """Fallback full-level decode via PIL; keeps IFDs whose aspect ratio
    matches the baseline (drops .svs label/macro images)."""
    from PIL import Image, ImageSequence

    with Image.open(path) as im:
        frames = [
            np.asarray(f.convert("RGB"))
            for f in ImageSequence.Iterator(im)
        ]
    frames.sort(key=lambda a: -a.shape[1])
    a0 = frames[0].shape[1] / frames[0].shape[0]
    keep = [frames[0]] + [
        f for f in frames[1:]
        if 0.9 * a0 <= f.shape[1] / f.shape[0] <= 1.1 * a0
    ]
    return keep


_TIFF_EXTS = (".tif", ".tiff", ".svs")


def open_slide(path: str):
    """Open any supported slide container: WSIRAW ('WSR1') or tiled TIFF
    (.tif/.tiff/.svs). Dispatches on magic bytes, falling back to extension."""
    with open(path, "rb") as f:
        head = f.read(4)
    if len(head) == 4 and np.frombuffer(head, np.uint32)[0] == MAGIC:
        return RawSlide(path)
    if head[:2] in (b"II", b"MM") or path.lower().endswith(_TIFF_EXTS):
        return TiffSlide(path)
    return RawSlide(path)


# ---------------------------------------------------------------------------
# Standalone helpers
# ---------------------------------------------------------------------------


def tissue_mask_hsv(rgb: np.ndarray, h_range=(120, 180), s_range=(20, 255),
                    v_range=(30, 255), k_close: int = 51, k_open: int = 31):
    """HSV in-range tissue mask + box close/open morphology — the sampler's
    ``get_bb`` ROI detection (``data_utils.py:1``). Returns a bool mask."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    out = np.empty((h, w), np.uint8)
    lib = get_lib()
    if lib is not None:
        lib.tr_tissue_mask(
            rgb.ctypes.data_as(ctypes.c_void_p), w, h,
            h_range[0], h_range[1], s_range[0], s_range[1],
            v_range[0], v_range[1], k_close, k_open,
            out.ctypes.data_as(ctypes.c_void_p),
        )
        return out.astype(bool)
    # numpy fallback (cv2-convention HSV)
    import cv2 as cv

    hsv = cv.cvtColor(rgb, cv.COLOR_RGB2HSV)
    m = cv.inRange(hsv, (h_range[0], s_range[0], v_range[0]),
                   (h_range[1], s_range[1], v_range[1])).astype(np.uint8)
    m = cv.morphologyEx(m, cv.MORPH_CLOSE, np.ones((k_close, k_close), np.uint8))
    m = cv.morphologyEx(m, cv.MORPH_OPEN, np.ones((k_open, k_open), np.uint8))
    return m.astype(bool)
