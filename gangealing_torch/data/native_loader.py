"""Native prefetching data loader (C++ decode workers over mmap'd LMDB).

The port's own copy of gangealing_tpu/data/native_loader.py, the
counterpart of torch DataLoader worker processes (reference
datasets/__init__.py:20-41): decode threads live in-process (no pickling
or IPC), read encoded bytes zero-copy from the LMDB mmap, and stage
float32 [-1, 1] CHW batches in a bounded ring buffer. Batches are numpy
arrays, as ``data/dataset.py``'s loaders yield them; the caller moves a
batch to the card.

The library, ``build/torch_native/libgt_loader.so``, is built with g++ at
the first construction (never at import) from the port's copies of
``native/lmdb_kv.cc`` and ``native/image_loader.cc``, against the headers
in ``gangealing_torch/native/include`` (libjpeg-turbo 2.1.5, the libjpeg
6.2 ABI, and libpng 1.6.39, with their licence texts). It links the
libjpeg-turbo and libpng16 that the running interpreter's Pillow wheel
carries in its ``pillow.libs`` directory, by full path and with an rpath
to it, and takes libpng16 from opencv-python's ``opencv_python.libs``
where Pillow's directory lacks it. Where neither holds a library,
construction raises ``FileNotFoundError`` naming the globs and the
directories searched; there is no fallback to the Python loader.
"""

import ctypes
import glob
import importlib.util
import os
from typing import Iterator

import numpy as np

_LIB = None
# (glob, what it finds), each looked up in the directories of
# _library_dirs() in order
_LIBRARY_GLOBS = (("libjpeg-*.so.62*", "libjpeg-turbo (the 6.2 ABI)"),
                  ("libpng16-*.so.16*", "libpng16"))


def _wheel_libs(package, libs):
    """The directory of shared libraries that ``package``'s wheel carries
    beside it (``site-packages/<libs>``), found without importing it."""
    spec = importlib.util.find_spec(package)
    if spec is None or spec.origin is None:
        return None
    return os.path.join(os.path.dirname(os.path.dirname(spec.origin)), libs)


def _library_dirs():
    """Where the decoders' libraries are looked for, in order: Pillow's
    ``pillow.libs``, then opencv-python's ``opencv_python.libs``."""
    dirs = [_wheel_libs("PIL", "pillow.libs"),
            _wheel_libs("cv2", "opencv_python.libs")]
    return [d for d in dirs if d is not None]


def _find_libraries(dirs):
    """The full path of the first match of each of ``_LIBRARY_GLOBS`` in
    the first of ``dirs`` that holds one."""
    found, missing = [], []
    for pattern, what in _LIBRARY_GLOBS:
        hits = [sorted(glob.glob(os.path.join(d, pattern))) for d in dirs]
        hits = [h[0] for h in hits if h]
        if hits:
            found.append(hits[0])
        else:
            missing.append(f"{what} ({pattern})")
    if missing:
        raise FileNotFoundError(
            f"the native image loader cannot link {', '.join(missing)}: "
            f"no match in {dirs}")
    return found


def _read(path):
    """The text of ``path``, or None where there is no such file."""
    try:
        with open(path) as f:
            return f.read()
    except FileNotFoundError:
        return None


def _native_lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    from gangealing_torch.data._native_build import build_shared_lib
    package = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    native = os.path.join(package, "native")
    libs = _find_libraries(_library_dirs())
    rpaths = sorted({os.path.dirname(p) for p in libs})
    flags = ["-I", os.path.join(native, "include"), *libs,
             *(f"-Wl,-rpath,{d}" for d in rpaths), "-lpthread"]
    so = os.path.join(os.path.dirname(package), "build", "torch_native",
                      "libgt_loader.so")
    # a library linked against other copies (another Pillow, a copied
    # build directory) is rebuilt: the link line is kept beside it
    stamp = so + ".link"
    line = "\n".join(flags)
    if os.path.exists(so) and _read(stamp) != line:
        os.remove(so)
    build_shared_lib([os.path.join(native, "lmdb_kv.cc"),
                      os.path.join(native, "image_loader.cc")], so, flags)
    tmp = f"{stamp}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(line)
    os.replace(tmp, stamp)
    lib = ctypes.CDLL(so)
    lib.gt_loader_create.restype = ctypes.c_void_p
    lib.gt_loader_create.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint64, ctypes.c_int]
    lib.gt_loader_next.restype = ctypes.c_int
    lib.gt_loader_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_void_p]
    lib.gt_loader_len.restype = ctypes.c_int64
    lib.gt_loader_len.argtypes = [ctypes.c_void_p]
    lib.gt_loader_set_epoch.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.gt_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.linked = libs
    _LIB = lib
    return lib


def linked_libraries():
    """The full paths of the libjpeg-turbo and libpng16 that the loader's
    library links (built on the first call)."""
    return list(_native_lib().linked)


class NativeImageLoader:
    """Infinite iterator of ((n, 3, res, res) float32 in [-1,1], (n,) int64
    dataset indices) batches, decoded by C++ worker threads."""

    def __init__(self, path: str, resolution: int = 256, batch: int = 64,
                 num_threads: int = 8, shuffle: bool = True, seed: int = 0,
                 prefetch_depth: int = 4):
        self._h = None
        self._lib = _native_lib()
        self._h = self._lib.gt_loader_create(
            path.encode(), resolution, batch, num_threads, int(shuffle),
            seed, prefetch_depth)
        if not self._h:
            raise IOError(f"cannot open image loader over {path}")
        self.batch = batch
        self.resolution = resolution
        self._buf = np.empty((batch, 3, resolution, resolution), np.float32)
        self._idx = np.empty((batch,), np.int64)

    def __len__(self):
        return int(self._lib.gt_loader_len(self._h))

    def next(self):
        if not self._h:
            raise RuntimeError("native loader is closed")
        n = self._lib.gt_loader_next(
            self._h, self._buf.ctypes.data_as(ctypes.c_void_p),
            self._idx.ctypes.data_as(ctypes.c_void_p))
        if n == -2:
            # a full epoch of chunks decoded zero images: the resolution
            # key prefix doesn't exist in this LMDB, or the data is corrupt
            raise RuntimeError(
                f"native loader decoded no images for a full epoch — is "
                f"resolution={self.resolution} present in this dataset?")
        if n < 0:
            # loader closed/destroyed; a distinct exception, NOT
            # StopIteration (PEP 479 would turn that into a confusing
            # 'generator raised StopIteration' inside __iter__)
            raise RuntimeError("native loader is closed")
        return self._buf[:n].copy(), self._idx[:n].copy()

    def __iter__(self) -> Iterator:
        while True:
            yield self.next()

    def set_epoch(self, seed: int):
        self._lib.gt_loader_set_epoch(self._h, seed)

    def close(self):
        if self._h:
            self._lib.gt_loader_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
