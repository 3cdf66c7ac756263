"""ctypes binding of the native host pipeline (the repository's ``native/``):
the multithreaded NDT map builder, the voxel filter and the correspondence
matcher that writes the maha6 kernel buffer (``native/ndt_builder.cc``,
with the eigensolver ``native/eigh3.cc``). The counterpart of the JAX
package's ``native.py``, with the same functions, ctypes signatures and ABI
check; the numpy copies in ``pipelines/ndt.py`` stay the portable path and
the correctness oracle.

Build
-----
At first use, g++ compiles the two sources of ``native/`` with the flags
of ``native/Makefile`` (``eigh3.cc`` without ``-march=native``, both with
``-ffp-contract=off``: the eigenbasis of degenerate voxels, and so the
cost trace, depends on it) into ``build/torch_native/`` beside the package
(``.gitignore`` lists ``build/``). ``native/`` itself is neither built in
nor read for a library. The library's file name holds a hash of the
sources and flags, so an edited source is rebuilt.

The build is safe when several processes load at once (test workers, a
server's replicas): a builder takes an ``fcntl`` lock on ``lock`` in the
build directory, checks again under the lock whether a library of the
right ABI is there, compiles and links to temporary names of its own in
the same directory, checks the new library's ABI, and ``os.replace``\\ s it
onto the final name. A loader thus never sees a partly written file. If
g++ fails, :func:`load` raises with the compiler's output; there is no
Python fallback inside the binding.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
from _ctypes import dlclose
from pathlib import Path
from typing import Optional

import numpy as np

from .pipelines.ndt import (
    MIN_EIGENVALUE,
    MIN_EIGENVALUE_RATIO,
    MIN_POINTS_PER_VOXEL,
    NdtMap,
)

_REPO = Path(__file__).resolve().parent.parent
NATIVE_SRC = _REPO / "native"
BUILD_DIR = _REPO / "build" / "torch_native"

# native/Makefile: CXXFLAGS_COMMON, CXXFLAGS (ndt_builder.cc) and
# CXXFLAGS_EIGH (eigh3.cc), LDFLAGS
CXX = "g++"
CXXFLAGS_COMMON = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-ffp-contract=off")
SOURCES = {
    "ndt_builder.cc": CXXFLAGS_COMMON + ("-march=native",),
    "eigh3.cc": CXXFLAGS_COMMON,
}
LDFLAGS = ("-shared", "-pthread")

_ABI_VERSION = 2  # must match nls_abi_version() in ndt_builder.cc

_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the library is built, in ``BUILD_DIR``: the file name holds a
    hash of the sources and the flags."""
    digest = hashlib.sha256(" ".join([CXX, *LDFLAGS]).encode())
    for src, flags in sorted(SOURCES.items()):
        digest.update(" ".join(flags).encode())
        digest.update((NATIVE_SRC / src).read_bytes())
    return BUILD_DIR / f"libnls_native_{digest.hexdigest()[:16]}.so"


def _abi(path: Path) -> int:
    """The ABI version that the library at ``path`` reports (0 if it has no
    ``nls_abi_version``, -1 if there is no such file). The library is
    unloaded again, so a later load of the same name maps the file anew."""
    if not path.exists():
        return -1
    lib = ctypes.CDLL(str(path))
    try:
        fn = lib.nls_abi_version
        fn.restype, fn.argtypes = ctypes.c_int64, []
        return int(fn())
    except AttributeError:
        return 0
    finally:
        dlclose(lib._handle)


def _compile(build_dir: Path, out: Path) -> None:
    """Compile and link the library to ``out`` (a temporary name); raises
    with the compiler's output if g++ fails."""
    tag = f"{os.getpid()}"
    objs, procs = [], []
    for src, flags in SOURCES.items():
        obj = build_dir / f"{Path(src).stem}.{tag}.o"
        cmd = [CXX, *flags, "-c", str(NATIVE_SRC / src), "-o", str(obj)]
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
        objs.append(obj)
    failed = []
    for cmd, proc in procs:  # both compiles run at once
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}: exit {proc.returncode}\n{log}")
    try:
        if failed:
            raise RuntimeError("native build failed:\n" + "\n".join(failed))
        cmd = [CXX, *map(str, objs), *LDFLAGS, "-o", str(out)]
        link = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"native link failed: {' '.join(cmd)}\n{link.stdout}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)


def ensure_built(force: bool = False) -> Path:
    """Build the library unless one of the right ABI is there; returns its
    path. Race-free across processes (see the module docstring)."""
    path = library_path()
    if not force and _abi(path) == _ABI_VERSION:
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path.parent / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        # another process may have built it while this one waited
        if not force and _abi(path) == _ABI_VERSION:
            return path
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        try:
            _compile(path.parent, tmp)
            got = _abi(tmp)
            if got != _ABI_VERSION:
                raise OSError(f"{tmp}: native ABI {got} != expected {_ABI_VERSION}")
            os.replace(tmp, path)
        finally:
            tmp.unlink(missing_ok=True)
    return path


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed (see :func:`ensure_built`),
    with every function's ctypes signature declared."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(ensure_built()))
    lib.nls_abi_version.restype, lib.nls_abi_version.argtypes = ctypes.c_int64, []
    lib.nls_build_ndt_map.restype = ctypes.c_int64
    lib.nls_build_ndt_map.argtypes = [
        ctypes.POINTER(ctypes.c_double),  # points
        ctypes.c_int64,  # n
        ctypes.c_double,  # resolution
        ctypes.c_int64,  # min_points
        ctypes.c_double,  # min_eigenvalue
        ctypes.c_double,  # eigenvalue_ratio
        ctypes.c_int64,  # max_voxels
        ctypes.POINTER(ctypes.c_double),  # means
        ctypes.POINTER(ctypes.c_double),  # sqrt_infos
        ctypes.POINTER(ctypes.c_double),  # infos
        ctypes.POINTER(ctypes.c_int64),  # counts
        ctypes.POINTER(ctypes.c_uint8),  # valid
        ctypes.c_int,  # num_threads
        ctypes.c_int,  # identity_moment
    ]
    lib.nls_voxel_filter.restype = ctypes.c_int64
    lib.nls_voxel_filter.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.c_double,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.nls_match_and_pack.restype = ctypes.c_int64
    lib.nls_match_and_pack.argtypes = [
        ctypes.POINTER(ctypes.c_double),  # points
        ctypes.c_int64,  # n
        ctypes.POINTER(ctypes.c_double),  # R (3x3)
        ctypes.POINTER(ctypes.c_double),  # t (3)
        ctypes.POINTER(ctypes.c_double),  # means
        ctypes.POINTER(ctypes.c_double),  # sqrt_infos
        ctypes.c_int64,  # m
        ctypes.c_double,  # radius
        ctypes.c_int,  # k
        ctypes.c_int64,  # lanes
        ctypes.POINTER(ctypes.c_float),  # packed_out
        ctypes.c_int,  # num_threads
    ]
    _lib = lib
    return lib


def available() -> bool:
    """True if the library builds (or is built) and loads."""
    try:
        load()
        return True
    except (OSError, RuntimeError):
        return False


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def build_ndt_map(
    points: np.ndarray,
    voxel_resolution: float,
    num_threads: int = 1,
    max_voxels: int = 1 << 20,
    identity_moment: bool = True,
) -> NdtMap:
    """Native ``pipelines.ndt.build_ndt_map``.

    ``num_threads=1`` (the default) accumulates the moments serially in
    input order, bit for bit as the numpy builder and the reference's
    serial loop do: the row-scaled sqrt-information of near-degenerate
    (flat wall or floor) voxels is ulp-sensitive, so a threaded merge of
    partial sums would rotate their eigenbasis and move the cost trace.
    ``num_threads=0`` uses every host CPU (one voxel-map partial a thread,
    merged at the end). ``identity_moment`` is the numpy builder's flag."""
    lib = load()
    pts = np.ascontiguousarray(points, dtype=np.float64)
    if num_threads <= 0:
        num_threads = os.cpu_count() or 1
    means = np.empty((max_voxels, 3))
    sqrt_infos = np.empty((max_voxels, 3, 3))
    infos = np.empty((max_voxels, 3, 3))
    counts = np.empty(max_voxels, dtype=np.int64)
    valid = np.empty(max_voxels, dtype=np.uint8)
    m = lib.nls_build_ndt_map(
        _ptr(pts, ctypes.c_double), pts.shape[0], voxel_resolution,
        MIN_POINTS_PER_VOXEL, MIN_EIGENVALUE, MIN_EIGENVALUE_RATIO, max_voxels,
        _ptr(means, ctypes.c_double), _ptr(sqrt_infos, ctypes.c_double),
        _ptr(infos, ctypes.c_double), _ptr(counts, ctypes.c_int64),
        _ptr(valid, ctypes.c_uint8), num_threads, 1 if identity_moment else 0,
    )
    if m == -2:
        raise ValueError(
            "native build_ndt_map: voxel index outside the +/-2^20 packed-key "
            "range (points beyond ~1e6 voxels from the origin); use "
            "pipelines.ndt.build_ndt_map (exact integer-triple keys)"
        )
    if m < 0:
        raise RuntimeError(f"more than {max_voxels} voxels; raise max_voxels")
    return NdtMap(
        means=means[:m].copy(),
        sqrt_informations=sqrt_infos[:m].copy(),
        informations=infos[:m].copy(),
        counts=counts[:m].copy(),
        valid=valid[:m].astype(bool),
    )


def filter_points(points: np.ndarray, filter_voxel_size: float) -> np.ndarray:
    """Native ``pipelines.ndt.filter_points``: the first point of each
    voxel, in input order."""
    lib = load()
    pts = np.ascontiguousarray(points, dtype=np.float64)
    keep = np.empty(pts.shape[0], dtype=np.int64)
    kept = lib.nls_voxel_filter(
        _ptr(pts, ctypes.c_double), pts.shape[0], filter_voxel_size, _ptr(keep, ctypes.c_int64)
    )
    if kept == -2:
        raise ValueError(
            "native filter_points: voxel index outside the +/-2^20 packed-key "
            "range; use pipelines.ndt.filter_points"
        )
    return pts[keep[:kept]]


def match_and_pack(
    points: np.ndarray,
    rotation: np.ndarray,
    translation: np.ndarray,
    means: np.ndarray,
    sqrt_infos: np.ndarray,
    radius: float,
    num_neighbors: int,
    lanes: int,
    out: Optional[np.ndarray] = None,
    num_threads: int = 0,
) -> np.ndarray:
    """Correspondence search and the packed (16, lanes) float32 maha6
    buffer (the FLANN analog, reference simple_optimization_test.cc:
    296-342): for each point warped by (rotation, translation), its
    ``num_neighbors`` nearest voxel means within ``radius``, point-major
    (lane i k + s), rows p 0-2, mu 3-5, S row-major 6-14, mask 15; lanes
    past N k are zero. ``out`` may be a reused C-contiguous (16, lanes)
    float32 array, for example a numpy view of a pinned torch tensor.
    ``num_threads=0`` uses every host CPU; the buffer does not depend on
    the thread count."""
    lib = load()
    pts = np.ascontiguousarray(points, np.float64)
    R = np.ascontiguousarray(rotation, np.float64)
    t = np.ascontiguousarray(translation, np.float64)
    mu = np.ascontiguousarray(means, np.float64)
    S = np.ascontiguousarray(np.asarray(sqrt_infos).reshape(mu.shape[0], 9), np.float64)
    if out is None:
        out = np.empty((16, lanes), np.float32)
    if out.shape != (16, lanes) or out.dtype != np.float32 or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous (16, {lanes}) float32 array")
    if num_threads <= 0:
        num_threads = os.cpu_count() or 1
    res = lib.nls_match_and_pack(
        _ptr(pts, ctypes.c_double), pts.shape[0], _ptr(R, ctypes.c_double),
        _ptr(t, ctypes.c_double), _ptr(mu, ctypes.c_double), _ptr(S, ctypes.c_double),
        mu.shape[0], radius, num_neighbors, lanes, _ptr(out, ctypes.c_float), num_threads,
    )
    if res < 0:
        raise ValueError("nls_match_and_pack: bad k or insufficient lanes")
    return out
