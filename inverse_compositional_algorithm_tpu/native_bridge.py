"""ctypes bridge to the native CPU engine (native/ica_cpu.cc).

Builds on first use with `make -C native` into native/build/ (for the
host that runs it: -march=native) if g++ is available; all entry points
degrade gracefully (raise NativeUnavailable) when the library can't be
built, so the pure-JAX path never depends on it. See native/ica_cpu.cc
for the role this plays (the reference's Numba tier, reimplemented as
portable C++/OpenMP).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

__all__ = ["NativeUnavailable", "available", "warp_bicubic", "gradients",
           "normal_eq", "solve"]

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SO = os.path.join(_REPO, "native", "build", "libica_cpu.so")
_lib = None
_tried = False


class NativeUnavailable(RuntimeError):
    pass


def _load():
    global _lib, _tried
    if _lib is not None:
        return _lib
    if _tried:
        raise NativeUnavailable("native library unavailable (build failed)")
    _tried = True
    if not os.path.exists(_SO):
        # Build under a private name, then rename: several processes (test
        # workers) may build at once, and each sees either no library or a
        # whole one.
        tmp = f"{_SO}.{os.getpid()}.tmp"
        try:
            subprocess.run(["make", "-C", os.path.join(_REPO, "native"),
                            f"OUT={tmp}"],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, _SO)
        except Exception as e:  # noqa: BLE001
            raise NativeUnavailable(f"could not build native library: {e}")
    lib = ctypes.CDLL(_SO)
    i64 = ctypes.c_int64
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.ica_warp_bicubic.argtypes = [f32p, i64, i64, i64, f64p,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, f32p]
    lib.ica_gradients.argtypes = [f32p, i64, i64, i64, f32p, f32p]
    lib.ica_normal_eq.argtypes = [f32p, f32p, f32p, f32p, f32p, i64, i64,
                                  ctypes.c_int, f64p, f64p]
    lib.ica_solve.argtypes = [f32p, f32p, i64, i64, i64, f64p,
                              ctypes.c_int, ctypes.c_int, ctypes.c_double,
                              ctypes.c_double, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, f64p,
                              ctypes.POINTER(ctypes.c_int)]
    _lib = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except NativeUnavailable:
        return False


def warp_bicubic(image: np.ndarray, p8, ttype_value: int,
                 nanifoutside: bool = True, delta: int = 0) -> np.ndarray:
    """[H, W, C] float32 warp by padded params (native oracle path)."""
    lib = _load()
    img = np.ascontiguousarray(image, np.float32)
    h, w, c = img.shape
    p = np.ascontiguousarray(np.asarray(p8, np.float64).reshape(8))
    out = np.empty_like(img)
    lib.ica_warp_bicubic(img, h, w, c, p, int(ttype_value),
                         int(bool(nanifoutside)), int(delta), out)
    return out


def gradients(image: np.ndarray):
    lib = _load()
    img = np.ascontiguousarray(image, np.float32)
    h, w, c = img.shape
    ix = np.empty_like(img)
    iy = np.empty_like(img)
    lib.ica_gradients(img, h, w, c, ix, iy)
    return ix, iy


def normal_eq(w1, w2, w3, wu, wv, ttype_value: int):
    """(H [8,8], b [8]) float64 from [H, W] float32 maps (raw Jacobian)."""
    lib = _load()
    maps = [np.ascontiguousarray(m, np.float32) for m in (w1, w2, w3, wu, wv)]
    h, w = maps[0].shape
    hout = np.empty((8, 8), np.float64)
    bout = np.empty(8, np.float64)
    lib.ica_normal_eq(*maps, h, w, int(ttype_value), hout, bout)
    return hout, bout


def solve(i1, i2, p0, ttype_value: int, robust_value: int = 0,
          lam: float = 0.0, tol: float = 1e-3, max_iter: int = 30,
          nanifoutside: bool = True, delta: int = 10):
    """Complete single-pair IC / robust-IRLS solve in the native engine.

    The accelerator-independent twin of models.ic.ic_solve (single scale,
    single pair; f64 accumulation and solve, like the IPOL C++).

    Args:
      i1, i2: [H, W, C] images; p0: initial padded/unpadded params.
      ttype_value / robust_value: TransformType.value / RobustLoss.value.

    Returns: (p [8] float64, error, niters).
    """
    lib = _load()
    a = np.ascontiguousarray(i1, np.float32)
    b = np.ascontiguousarray(i2, np.float32)
    h, w, c = a.shape
    p = np.zeros(8, np.float64)
    p0 = np.asarray(p0, np.float64).ravel()
    p[: p0.shape[0]] = p0
    err = np.zeros(1, np.float64)
    nit = ctypes.c_int(0)
    lib.ica_solve(a, b, h, w, c, p, int(ttype_value), int(robust_value),
                  float(lam), float(tol), int(max_iter),
                  int(bool(nanifoutside)), int(delta), err,
                  ctypes.byref(nit))
    return p, float(err[0]), int(nit.value)
