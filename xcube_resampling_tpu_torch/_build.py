"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Every ``csrc/*.cu`` file is compiled for Hopper (``sm_90a``), one ``nvcc``
process per source, all started together, and the objects are linked into
one shared library with a plain C interface, at first use, into
``build/xcube_resampling_tpu_torch/`` beside the package.  The library's
name carries a hash of the sources and flags, so an edited source builds a
new library.  Nothing here includes PyTorch's headers: a build takes
seconds, not minutes.

``-fmad=false`` keeps ``a + b * c`` as two rounded operations, as the plain
PyTorch versions (one operation per launch) and the JAX package compute it,
so that the kernels agree with them bit for bit where the arithmetic is
the same (the JAX package's C++ build uses ``-ffp-contract=off`` for the
same reason).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "xcube_resampling_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
# C signature of every kernel entry point (all return cudaGetLastError())
_SIGNATURES = {
    # src, iystar_c, base_v, win, v, vd, batch, src_h, src_w, out_h, ncj,
    # ncc, step, n_col_tiles, col_tile, d_v, method, rows, cols, extent,
    # n_col_blocks, walkers, vec4, code, stream
    "xrt_srw_vertical": [
        _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _I, _I64,
        _I64, _I, _I, _I, _I, _I, _I64, _I64, _I, _I, _P,
    ],
    # ext, iystar_c, base_v, win, v, vd, batch, ext_h, src_w, out_h, ncj,
    # ncc, step, n_col_tiles, col_tile, d_v, method, rows, cols, extent,
    # n_col_blocks, walkers, vec4, row0, off, src_h, code, stream
    "xrt_srw_vertical_band": [
        _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _I, _I64,
        _I64, _I, _I, _I, _I, _I, _I64, _I64, _I, _I64, _I64, _I64, _I, _P,
    ],
    # v, vd, ix_c, iy_c, base_h, win, out, batch, out_h, out_w, src_h,
    # src_w, ncj, nci, step, row_tile, d_h, method, fill, cols, extent,
    # n_col_blocks, group, stages, warps, vec4, row0, stream
    "xrt_srw_horizontal_f32": [
        _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _I64,
        _I, _I64, _I, _I, _F, _I, _I, _I64, _I, _I, _I, _I, _I64, _P,
    ],
    # the same on float64 v, vd, out and fill
    "xrt_srw_horizontal_f64": [
        _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _I64,
        _I, _I64, _I, _I, _D, _I, _I, _I64, _I, _I, _I, _I, _I64, _P,
    ],
    # src, iystar_c, s_v, base_v, v, batch, src_h, src_w, out_h, ncj, ncc,
    # step, n_col_tiles, col_tile, d_v, method, stream
    "xrt_srw_aligned_vertical_f32": [
        _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _I, _I64, _I64, _I, _I, _P,
    ],
    # v, ix_c, iy_c, s_h, base_h, out, batch, out_h, src_w, out_w, src_h,
    # ncj, nci, step, row_tile, d_h, method, fill, stream
    "xrt_srw_aligned_horizontal_f32": [
        _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I, _I64, _I, _I,
        _F, _P,
    ],
    # src, iystar_c, s_v, base_v, win, v, flags, batch, src_h, src_w, out_h,
    # ncj, ncc, step, n_col_tiles, col_tile, d_v, method, rows, extent,
    # walkers, stream
    "xrt_srw_aligned_vertical_staged_f32": [
        _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _I, _I64, _I64, _I,
        _I, _I, _I, _I64, _P,
    ],
    # v, flags, ix_c, iy_c, s_h, base_h, out, batch, out_h, src_w, out_w,
    # src_h, ncj, nci, step, row_tile, d_h, method, fill, stream
    "xrt_srw_aligned_horizontal_flagged_f32": [
        _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I, _I64, _I,
        _I, _F, _P,
    ],
    # src, ix_c, iy_c, out, batch, src_h, src_w, ncj, nci, out_h, out_w,
    # step, method, fill, stream
    "xrt_fused_reproject_f32": [
        _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I, _I, _F, _P,
    ],
    # ext, ix_c, iy_c, out, batch, ext_h, src_w, ncj, nci, out_h, out_w,
    # step, method, fill, row0, off, src_h, stream
    "xrt_fused_reproject_band_f32": [
        _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I, _I, _F,
        _I64, _I64, _I64, _P,
    ],
    # src, ix_c, iy_c, out, batch, src_h, src_w, ncj, nci, out_h, out_w,
    # step, method, fill, fill_bits, row0, off, true_h, band, code, stream
    "xrt_fused_reproject_typed": [
        _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I, _I, _D, _I64,
        _I64, _I64, _I64, _I, _I, _P,
    ],
    # src, iystar_c, ix_c, iy_c, out, batch, src_h, src_w, ncj, ncc, nci,
    # out_h, out_w, step, n_samples, method, fill, src_h_g, src_w_g, j_off,
    # i_off, staged, stream
    "xrt_esw_gather_f32": [
        _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I, _I,
        _I, _F, _I64, _I64, _I64, _I64, _I, _P,
    ],
    # ext, iystar_c, ix_c, iy_c, out, batch, ext_h, src_w, ncj, ncc, nci,
    # out_h, out_w, step, n_samples, method, fill, row0, off, src_h, staged,
    # stream
    "xrt_esw_gather_band_f32": [
        _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I, _I,
        _I, _F, _I64, _I64, _I64, _I, _P,
    ],
    # src, table, tile_start, fields, out, n_pieces, n_tiles, batch, src_h,
    # src_w, out_h, out_w, step, method, fill, tile_rows, tile_cols,
    # staged, stream
    "xrt_esw_mosaic_f32": [
        _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I, _I, _F, _I, _I, _I,
        _P,
    ],
    # src, out, batch, src_h, src_w, pitch_b, pitch_h, out_h, out_w,
    # j_scale, i_scale, j_off, i_off, order, fill, fill_bits, in_code,
    # out_code, stream
    "xrt_affine_gather": [
        _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _D, _D, _D, _D, _I,
        _D, _I64, _I, _I, _P,
    ],
    # src, out, batch, src_h, src_w, pitch_b, pitch_h, out_h, out_w, j_div,
    # i_div, j_scale, i_scale, j_off, i_off, fill, agg, pa, pb, code,
    # route, stream
    "xrt_affine_gather_reduce": [
        _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _D, _D, _D,
        _D, _D, _I, _I64, _I64, _I, _I, _P,
    ],
    # src, out, batch, h, w, j_div, i_div, agg, pa, pb, code, stream
    "xrt_coarsen_reduce": [
        _P, _P, _I64, _I64, _I64, _I64, _I64, _I, _I64, _I64, _I, _P,
    ],
    # src, out, batch, h, w, j_div, i_div, median, code, threads, stream
    "xrt_coarsen_rank": [
        _P, _P, _I64, _I64, _I64, _I64, _I64, _I, _I, _I, _P,
    ],
    # sx, sy, src_h, src_w, itab, dtab, n_tiles, items, n_items, patch_w,
    # patch_h, tile_h, tile_w, n_tiles_x, out_h, out_w, x_scale, y_scale,
    # uv_delta, claim, out, stream
    "xrt_rectify_phase_a": [
        _P, _P, _I64, _I64, _P, _P, _I64, _P, _I64, _I64, _I64, _I64, _I64, _I64,
        _I64, _I64, _D, _D, _D, _P, _P, _P,
    ],
    # src, ix, iy, valid, rows, cols, out, n, batch, src_h, src_w, out_w,
    # out_plane, method, fill, fill_bits, code, stream
    "xrt_ij_gather": [
        _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _I, _D,
        _I64, _I, _P,
    ],
    # ext, map, out, batch, ext_h, src_w, out_h, out_w, off, src_h, method,
    # fill, fill_bits, code, stream
    "xrt_ij_gather_band": [
        _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I, _D, _I64, _I, _P,
    ],
    # gx, gy, src_h, src_w, r0, dst_h, dst_w, tile, coarse_iters,
    # refine_iters, max_edge, margin, scratch, cqj, cqi, meta, stream
    "xrt_hybrid_seed": [
        _P, _P, _I64, _I64, _D, _I64, _I64, _I64, _I64, _I64, _D, _I64, _P, _P, _P, _P, _P,
    ],
    # gx, gy, src_h, src_w, r0, cqj, cqi, dst_h, dst_w, tile, win_j, win_i,
    # margin, uv_delta, out, tested, solved, stream
    "xrt_hybrid_dense": [
        _P, _P, _I64, _I64, _D, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _D, _P, _P,
        _P, _P,
    ],
    # gx, gy, src_h, src_w, dst_h, dst_w, stride, coarse_iters, fine_iters,
    # uv_delta, scratch, cq, out, stream
    "xrt_phase_a_walk": [
        _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _D, _P, _P, _P, _P,
    ],
    # gx, gy, src_h, src_w, tiles, bjs, bis, n, win, tile, n_ti, dst_h,
    # dst_w, uv_delta, out, stream
    "xrt_phase_a_tiled": [
        _P, _P, _I64, _I64, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _D, _P, _P,
    ],
    # gx, gy, src_h, src_w, dst_h, dst_w, r_i, r_j, uv_delta, claim, out,
    # stream
    "xrt_phase_a_scan": [
        _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _D, _P, _P, _P,
    ],
    # x, y, h, w, lattice, n_cols, n_rows, ij_border, table, out, queued,
    # stream
    "xrt_ij_bboxes": [
        _P, _P, _I64, _I64, _P, _I64, _I64, _I64, _P, _P, ctypes.POINTER(_I), _P,
    ],
    # src, ij_map, out, batch, src_h, src_w, out_h, out_w, method, fill,
    # fill_bits, code, stream
    "xrt_exact_gather_ij": [
        _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I, _D, _I64, _I, _P,
    ],
    # src, xx, yy, itab, dtab, out, batch, src_h, src_w, out_h, out_w,
    # tile_h, tile_w, n_tiles_x, win_h, win_w, pad_top, pad_left, x_res,
    # neg_y_res, method, fill, fill_bits, code, stream
    "xrt_exact_gather_windows": [
        _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64,
        _I64, _I64, _I64, _I64, _D, _D, _I, _D, _I64, _I, _P,
    ],
}


@dataclass
class Build:
    path: Path
    seconds: float  # nvcc wall time; 0.0 when the library was already built
    log: str  # nvcc's output (ptxas register and spill report)


_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def find_nvcc() -> str:
    """``nvcc`` from ``CUDA_HOME``, ``PATH``, or the toolkit's default
    install location; raises ``RuntimeError`` when there is none."""
    cuda_home = os.environ.get("CUDA_HOME")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME to the CUDA toolkit or put nvcc on "
        "PATH to build the xcube_resampling_tpu_torch kernels"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.h")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libxrt_kernels_{h.hexdigest()[:16]}.so"


def _run(procs: list[tuple[str, subprocess.Popen]], t0: float) -> str:
    """Wait for every process; their output, each headed by its name and
    the seconds since *t0* at which it ended, or ``RuntimeError`` naming
    the ones that failed (the others are waited for first).  Each process
    is drained by a thread of its own, so none waits on a full pipe."""
    ends: dict[str, tuple[str, float]] = {}

    def drain(name: str, proc: subprocess.Popen) -> None:
        try:
            out, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        ends[name] = (out, time.perf_counter() - t0)

    threads = [threading.Thread(target=drain, args=p) for p in procs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    log, failed = [], []
    for name, proc in procs:
        out, end = ends[name]
        log.append(f"== {name} ({end:.1f} s)\n{out}")
        if proc.returncode != 0:
            failed.append(f"{name} ({proc.returncode})")
    text = "".join(log)
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n{text}")
    return text


def build() -> Build:
    """Compile the kernels unless the library for these sources exists:
    one ``nvcc -c`` per source in parallel, then one link."""
    path = _library_path()
    if path.is_file():
        return Build(path, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{path.stem}.{os.getpid()}"
    nvcc = find_nvcc()
    objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        compiles = [
            (src.name, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
            for src, obj in zip(_sources(), objects)
        ]
        log = _run(compiles, t0)
        link = subprocess.Popen(
            [nvcc, "-shared", "-o", str(tmp), *map(str, objects)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        log += _run([("link", link)], t0)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objects:
            obj.unlink(missing_ok=True)
    return Build(path, time.perf_counter() - t0, log)


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build().path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.xrt_cuda_error_string.argtypes = [ctypes.c_int]
            lib.xrt_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, rc: int, kernel: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib.xrt_cuda_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed: {msg} ({rc})")
