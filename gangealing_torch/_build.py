"""Build the port's CUDA kernels into one shared library and bind it.

The sources in ``gangealing_torch/csrc/`` are compiled by ``nvcc`` for
``sm_90a`` into ``build/torch_kernels/`` beside the package, at first use:
one ``nvcc`` per source, all started together, then one link. The build log
beside the library gives each step's wall seconds.
The library's file name carries a hash of the sources and the flags, so a
source change builds a new library. It has a plain C interface and is
loaded with ``ctypes``: every pointer and the stream are ``c_void_p``.

``LAUNCHES`` counts the kernel launches of each wrapper. It is the only
state at module level besides the cached library handle.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
# -fmad=false: no multiply-add contraction, so each step rounds as the plain
# torch version rounds it and kernel and plain version agree to the last bits.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v")

LAUNCHES = {"grid_sample": 0, "grid_sample_dgrid": 0, "grid_sample_dimg": 0,
            "mipmap_sample": 0, "mipmap_sample_dcoords": 0,
            "mipmap_sample_dpyramid": 0, "splat": 0, "upfirdn2d": 0,
            "upfirdn2d_dx": 0}
PADDING_CODES = {"border": 0, "reflection": 1, "zeros": 2}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path() -> Path:
    """The library file for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libgangealing_kernels_{h.hexdigest()[:16]}.so"


def _nvcc_run(what, args):
    """Run nvcc on ``args``; return its log headed by its wall seconds, or
    raise with its errors."""
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *args], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {what} ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    return (f"== nvcc {what}: {time.perf_counter() - t0:.2f} s\n"
            f"{proc.stdout}{proc.stderr}")


def _build(lib_path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC.glob("*.cu"))
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, s.stem + ".o") for s in sources]
        with ThreadPoolExecutor(len(sources)) as pool:
            logs = list(pool.map(_nvcc_run, [s.name for s in sources], [
                [*NVCC_FLAGS, "-c", "-o", o, str(s)]
                for o, s in zip(objs, sources)]))
        # Link to a temporary name and rename, so a concurrent or
        # interrupted build never leaves a half-written library under the
        # final name.
        so = os.path.join(tmp, "lib.so")
        logs.append(_nvcc_run("link", [*NVCC_FLAGS, "-shared", "-o", so,
                                       *objs]))
        lib_path.with_suffix(".log").write_text("".join(logs))
        os.replace(so, lib_path)


@functools.cache
def load_kernels() -> ctypes.CDLL:
    """Build the library if needed, load it, and declare its entry points."""
    lib_path = library_path()
    if not lib_path.exists():
        _build(lib_path)
    lib = ctypes.CDLL(str(lib_path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gg_grid_sample_fwd.argtypes = [ptr, ptr, ptr] + [i32] * 9 + [ptr]
    lib.gg_grid_sample_fwd.restype = i32
    lib.gg_grid_sample_dgrid.argtypes = [ptr] * 4 + [i32] * 7 + [ptr]
    lib.gg_grid_sample_dgrid.restype = i32
    lib.gg_grid_sample_dimg_scratch.argtypes = [i32] * 5
    lib.gg_grid_sample_dimg_scratch.restype = ctypes.c_longlong
    lib.gg_grid_sample_dimg.argtypes = [ptr] * 4 + [i32] * 7 + [ptr]
    lib.gg_grid_sample_dimg.restype = i32
    lib.gg_mipmap_pyramid_fwd.argtypes = [ptr] * 5 + [i32] * 11 + [ptr]
    lib.gg_mipmap_pyramid_fwd.restype = i32
    lib.gg_mipmap_pyramid_dcoords.argtypes = [ptr] * 7 + [i32] * 11 + [ptr]
    lib.gg_mipmap_pyramid_dcoords.restype = i32
    lib.gg_mipmap_dpyramid_scratch.argtypes = [i32] * 5
    lib.gg_mipmap_dpyramid_scratch.restype = ctypes.c_longlong
    lib.gg_mipmap_dpyramid.argtypes = [ptr] * 6 + [i32] * 10 + [ptr]
    lib.gg_mipmap_dpyramid.restype = i32
    lib.gg_splat_fwd.argtypes = [ptr] * 8 + [i32] * 7 + [ptr]
    lib.gg_splat_fwd.restype = i32
    lib.gg_upfirdn2d.argtypes = [ptr] * 2 + [i32] * 10 + [ptr] + [i32] * 2 \
        + [ptr]
    lib.gg_upfirdn2d.restype = i32
    return lib


def check_operand(name: str, t: torch.Tensor, ndim: int,
                  device: torch.device, channels_last: bool = False,
                  dtypes: tuple = (torch.float32,)) -> None:
    """Raise unless ``t`` is what a kernel takes: a contiguous CUDA tensor
    of a dtype in ``dtypes`` (float32 unless given) and ``ndim`` dimensions
    on ``device`` (or, with ``channels_last``, one contiguous in that memory
    format)."""
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype not in dtypes:
        names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise ValueError(f"{name} must be {names}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not (t.is_contiguous() or channels_last and t.is_contiguous(
            memory_format=torch.channels_last)):
        raise ValueError(f"{name} must be contiguous"
                         f"{' or channels_last' if channels_last else ''}")


def padding_code(padding_mode: str) -> int:
    if padding_mode not in PADDING_CODES:
        raise ValueError(f"unknown padding_mode: {padding_mode}")
    return PADDING_CODES[padding_mode]


def launch(name: str, fn, *args) -> None:
    """Call a C entry point, raise if its launch failed, and count it."""
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
