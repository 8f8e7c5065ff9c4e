"""The port's native host library: its build and its ctypes binding.

``csrc/tris_native.cpp`` (COCO RLE codec, polygon fill, connected
components, the dense CRF's permutohedral lattice) and ``csrc/tris_jpeg.cpp``
(the fused JPEG decode and Pillow-exact bilinear resize) are this package's
copies of the JAX package's ``native/`` sources. They are compiled with g++
at first use into ``build/`` (git-ignored), with ``native/Makefile``'s flags
(``-O3 -march=native -fPIC -std=c++17 -Wall -fopenmp``) and its probe for
libjpeg: where ``<jpeglib.h>`` is found the JPEG entry points link
``-ljpeg``, else they compile to stubs and :func:`jpeg_available` is False.

The library's file name carries a hash of the sources, the flags and the
compiler's version, since ``-march=native`` makes it the host's own; a build
writes a temporary file beside it and renames it into place under a file
lock, so processes that start together (test workers, the CRF pass's
workers) build it once. A failed build raises with the compiler's output;
nothing here falls back to the numpy versions.

The lattice's loops are OpenMP loops. The team each CRF call takes is its
``threads`` argument (default 1), set on the calling thread before the call
(``tris_set_num_threads``): the ir-label pass runs one process per core, and
a full team in each of them would oversubscribe the host. The setting is the
library's own (its loops' ``num_threads``), not the OpenMP runtime's: the
library links ``libgomp`` by name, so in a process that loaded torch first
it shares torch's runtime, and a call leaves torch's thread count as it was.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("tris_native.cpp", "tris_jpeg.cpp")
CXX = "g++"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-fopenmp")

_lib_handle = None
_lock = threading.Lock()


def _has_libjpeg(cxx: str) -> bool:
    """``native/Makefile``'s probe: does the preprocessor find <jpeglib.h>?"""
    probe = subprocess.run([cxx, "-E", "-x", "c++", "-"], input=b"#include <cstdio>\n"
                           b"#include <jpeglib.h>\n", capture_output=True)
    return probe.returncode == 0


def build_command(sources, out: str, cxx: str = CXX, jpeg: bool = True) -> list:
    """The g++ command that links ``sources`` into the shared library ``out``."""
    jpeg_flags = ["-DTRIS_HAVE_JPEG"] if jpeg else []
    return ([cxx, *CXXFLAGS, *jpeg_flags, "-shared", "-o", out] + [str(s) for s in sources]
            + (["-ljpeg"] if jpeg else []))


def build_library(sources=None, build_dir=None, cxx: str = CXX) -> Path:
    """Compile ``sources`` (default: this package's two ``csrc`` files) into
    ``build_dir`` unless a library of the same sources, flags and compiler is
    there already; returns its path. Raises ``RuntimeError`` with the
    compiler's output when the build fails."""
    sources = [Path(s) for s in (sources or [CSRC / n for n in SOURCES])]
    build_dir = Path(build_dir or BUILD_DIR)
    build_dir.mkdir(parents=True, exist_ok=True)
    try:
        version = subprocess.run([cxx, "--version"], capture_output=True, text=True).stdout
        jpeg = _has_libjpeg(cxx)
    except OSError as e:
        raise RuntimeError(f"tris_tpu_torch.native: the C++ compiler {cxx!r} cannot run: {e}") \
            from e
    key = hashlib.sha256()
    for s in sources:
        key.update(s.name.encode() + b"\0" + s.read_bytes())
    key.update(" ".join(build_command([s.name for s in sources], "", cxx, jpeg)).encode())
    key.update(version.encode())
    lib = build_dir / f"libtris_native-{key.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    with open(build_dir / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():  # another process built it while this one waited
            return lib
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
        os.close(fd)
        try:
            res = subprocess.run(build_command(sources, tmp, cxx, jpeg), capture_output=True,
                                 text=True)
            if res.returncode != 0:
                raise RuntimeError(f"tris_tpu_torch.native: the build failed "
                                   f"({' '.join(build_command(sources, str(lib), cxx, jpeg))}):"
                                   f"\n{res.stdout}{res.stderr}")
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i, f, buf, size = ctypes.c_int, ctypes.c_float, ctypes.c_char_p, ctypes.c_size_t

    lib.tris_set_num_threads.argtypes = [i]
    lib.tris_set_num_threads.restype = i
    lib.tris_rle_decode.argtypes = [u32p, i, i, i, u8p]
    lib.tris_rle_decode.restype = None
    lib.tris_rle_encode.argtypes = [u8p, i, i, u32p, i]
    lib.tris_rle_encode.restype = i
    lib.tris_polygon_to_rle.argtypes = [f64p, i, i, i, u32p, i]
    lib.tris_polygon_to_rle.restype = i
    lib.tris_connected_components.argtypes = [u8p, i, i, i32p]
    lib.tris_connected_components.restype = i
    lib.tris_dense_crf_multi.argtypes = [u8p, f32p, i, i, i, i, i, f, f, f, f, f, f32p]
    lib.tris_dense_crf_multi.restype = None
    lib.tris_jpeg_available.argtypes = []
    lib.tris_jpeg_available.restype = i
    lib.tris_resize_bilinear_u8.argtypes = [u8p, i, i, i, i, i, u8p]
    lib.tris_resize_bilinear_u8.restype = None
    lib.tris_jpeg_probe.argtypes = [buf, size, ctypes.POINTER(ctypes.c_int32),
                                    ctypes.POINTER(ctypes.c_int32)]
    lib.tris_jpeg_probe.restype = i
    lib.tris_jpeg_decode_u8.argtypes = [buf, size, u8p]
    lib.tris_jpeg_decode_u8.restype = i
    lib.tris_jpeg_decode_resize_norm.argtypes = [buf, size, i, ctypes.c_void_p,
                                                 ctypes.c_void_p, i, f32p, i32p]
    lib.tris_jpeg_decode_resize_norm.restype = i
    lib.tris_jpeg_decode_resize_u8.argtypes = [buf, size, i, i, u8p, i32p]
    lib.tris_jpeg_decode_resize_u8.restype = i
    return lib


def _lib() -> ctypes.CDLL:
    """The library, built first if needed (raises when it cannot be)."""
    global _lib_handle
    with _lock:
        if _lib_handle is None:
            _lib_handle = _bind(ctypes.CDLL(str(build_library())))
        return _lib_handle


def library_path() -> str:
    """The loaded library's file (builds it first if needed)."""
    return _lib()._name


def rle_decode(counts: np.ndarray, h: int, w: int) -> np.ndarray:
    """Column-major run lengths -> binary mask uint8 [h, w]."""
    counts = np.ascontiguousarray(counts, np.uint32)
    out = np.zeros((h, w), np.uint8)
    _lib().tris_rle_decode(counts, len(counts), h, w, out)
    return out


def rle_encode(mask: np.ndarray) -> np.ndarray:
    """Binary mask [h, w] -> column-major run lengths (uint32, zeros first)."""
    mask = np.ascontiguousarray(mask, np.uint8)
    h, w = mask.shape
    buf = np.zeros(h * w + 2, np.uint32)
    n = _lib().tris_rle_encode(mask, h, w, buf, len(buf))
    if n < 0:
        raise RuntimeError(f"tris_rle_encode: {h * w + 2} counts did not hold the runs")
    return buf[:n].copy()


def polygon_to_counts(poly, h: int, w: int) -> np.ndarray:
    """One polygon [x0, y0, x1, y1, ...] -> COCO's run lengths on [h, w]."""
    xy = np.ascontiguousarray(poly, np.float64)
    buf = np.zeros(h * w + 2, np.uint32)
    n = _lib().tris_polygon_to_rle(xy, len(xy) // 2, h, w, buf, len(buf))
    if n < 0:
        raise RuntimeError(f"tris_polygon_to_rle: {h * w + 2} counts did not hold the runs")
    return buf[:n].copy()


def connected_components(mask: np.ndarray):
    """4-connected components of a binary mask: (labels int32 [h, w], count)."""
    mask = np.ascontiguousarray(mask, np.uint8)
    h, w = mask.shape
    labels = np.zeros((h, w), np.int32)
    n = _lib().tris_connected_components(mask, h, w, labels)
    return labels, int(n)


def jpeg_available() -> bool:
    """True when the library was built against libjpeg."""
    return bool(_lib().tris_jpeg_available())


def resize_bilinear_u8(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Pillow-exact bilinear resize of a uint8 [H, W] or [H, W, C] array
    (byte-identical to ``Image.fromarray(img).resize((ow, oh), BILINEAR)``)."""
    squeeze = img.ndim == 2
    img = np.ascontiguousarray(img[..., None] if squeeze else img, np.uint8)
    h, w, c = img.shape
    out = np.empty((oh, ow, c), np.uint8)
    _lib().tris_resize_bilinear_u8(img, h, w, c, oh, ow, out)
    return out[..., 0] if squeeze else out


def _require_jpeg(lib) -> None:
    if not lib.tris_jpeg_available():
        raise RuntimeError("tris_tpu_torch.native: built without libjpeg (<jpeglib.h> not "
                           "found); check jpeg_available() first")


def jpeg_decode(data: bytes):
    """JPEG bytes -> RGB uint8 [H, W, 3], byte-identical to
    ``Image.open(...).convert("RGB")`` for RGB and grayscale JPEGs. Returns
    None for a file the decoder declines (CMYK, corrupt): decode that one
    with PIL."""
    lib = _lib()
    _require_jpeg(lib)
    h, w = ctypes.c_int32(), ctypes.c_int32()
    if lib.tris_jpeg_probe(data, len(data), ctypes.byref(h), ctypes.byref(w)) != 0:
        return None
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.tris_jpeg_decode_u8(data, len(data), out) != 0:
        return None
    return out


def jpeg_decode_resize_norm(data: bytes, size: int, mean=None, std=None, fast: bool = False):
    """Fused JPEG decode, square bilinear resize and normalisation:
    ``(float32 [size, size, 3], (orig_h, orig_w))``, or None for a file the
    decoder declines. With ``fast=False`` bit-identical to the PIL chain of
    ``data/transforms.py``; ``fast=True`` lets libjpeg reconstruct at a
    reduced DCT scale first (approximate)."""
    lib = _lib()
    _require_jpeg(lib)
    out = np.empty((size, size, 3), np.float32)
    hw = np.zeros(2, np.int32)
    if mean is not None:
        mean = np.ascontiguousarray(mean, np.float32)
        std = np.ascontiguousarray(std, np.float32)
        mp, sp = mean.ctypes.data, std.ctypes.data
    else:
        mp = sp = None
    if lib.tris_jpeg_decode_resize_norm(data, len(data), size, mp, sp, int(fast), out, hw) != 0:
        return None
    return out, (int(hw[0]), int(hw[1]))


def jpeg_decode_resize_u8(data: bytes, size: int, fast: bool = False):
    """Fused JPEG decode and square bilinear resize to uint8, the u8 feed's
    host half: ``(uint8 [size, size, 3], (orig_h, orig_w))``, byte-identical
    to PIL's decode then ``resize(BILINEAR)`` (with ``fast=False``), or None
    for a file the decoder declines."""
    lib = _lib()
    _require_jpeg(lib)
    out = np.empty((size, size, 3), np.uint8)
    hw = np.zeros(2, np.int32)
    if lib.tris_jpeg_decode_resize_u8(data, len(data), size, int(fast), out, hw) != 0:
        return None
    return out, (int(hw[0]), int(hw[1]))


class crf:
    """The native lattice's mean-field CRF (``pseudo/crf.py`` calls it)."""

    @staticmethod
    def dense_crf_inference(image: np.ndarray, unary: np.ndarray, n_iters: int, gxy: float,
                            gcompat: float, bxy: float, brgb: float, bcompat: float,
                            threads: int = 1) -> np.ndarray:
        """One problem: unary [L, h, w] -> Q [L, h, w]."""
        return crf.dense_crf_inference_multi(image, unary[None], n_iters, gxy, gcompat, bxy,
                                             brgb, bcompat, threads)[0]

    @staticmethod
    def dense_crf_inference_multi(image: np.ndarray, unary: np.ndarray, n_iters: int,
                                  gxy: float, gcompat: float, bxy: float, brgb: float,
                                  bcompat: float, threads: int = 1) -> np.ndarray:
        """K problems over one image, the lattices built once: unary [K, L, h,
        w] -> Q [K, L, h, w], on an OpenMP team of ``threads``."""
        lib = _lib()
        image = np.ascontiguousarray(image, np.uint8)
        K, L, h, w = unary.shape
        if image.shape != (h, w, 3):
            raise ValueError(f"dense_crf: image {image.shape} is not [{h}, {w}, 3]")
        unary = np.ascontiguousarray(unary.reshape(K, L, h * w), np.float32)
        out = np.zeros((K, L, h * w), np.float32)
        lib.tris_set_num_threads(int(threads))
        lib.tris_dense_crf_multi(image, unary, K, h, w, L, n_iters, gxy, gcompat, bxy, brgb,
                                 bcompat, out)
        return out.reshape(K, L, h, w)
