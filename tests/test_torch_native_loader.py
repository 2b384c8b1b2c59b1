"""The port's native image loader (gangealing_torch/data/native_loader.py):
the five checks of tests/test_native_loader.py on the port's class, the
port's batches against the JAX package's loader over the same LMDB (to the
bit), its build rules (nothing at import, a named error where the decoders'
libraries are missing, the library directories in order)."""

import io
import os
import subprocess
import sys
from importlib import import_module

import numpy as np
import pytest

from gangealing_torch.data import native_loader as tnl
from gangealing_torch.data.dataset import MultiResolutionDataset
from gangealing_torch.data.lmdb_io import write_lmdb

jnl = import_module("gangealing_tpu.data.native_loader")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _make_dataset(tmp_path, rng, n=32, res=32, fmt="PNG"):
    from PIL import Image
    imgs = (rng.rand(n, res, res, 3) * 255).astype(np.uint8)
    items = {b"length": str(n).encode()}
    for i in range(n):
        buf = io.BytesIO()
        Image.fromarray(imgs[i]).save(buf, format=fmt, quality=95)
        items[f"{res}-{str(i).zfill(5)}".encode()] = buf.getvalue()
    path = str(tmp_path / f"ds_{fmt}")
    write_lmdb(path, items)
    return path, imgs


@pytest.mark.parametrize("fmt", ["PNG", "JPEG"])
def test_native_loader_decode_parity(tmp_path, rng, fmt):
    """Every image within 1e-5 of the PIL path (MultiResolutionDataset),
    and equal to the bit to the JAX package's loader's decode of it."""
    path, _ = _make_dataset(tmp_path, rng, fmt=fmt)
    ours = tnl.NativeImageLoader(path, resolution=32, batch=8, num_threads=2,
                                 shuffle=False, seed=0)
    ref = jnl.NativeImageLoader(path, resolution=32, batch=8, num_threads=2,
                                shuffle=False, seed=0)
    assert len(ours) == 32
    pil = MultiResolutionDataset(path, resolution=32)
    seen, jax_seen = {}, {}
    for _ in range(4):
        for loader, into in ((ours, seen), (ref, jax_seen)):
            batch, idx = loader.next()
            assert batch.dtype == np.float32 and idx.dtype == np.int64
            assert batch.shape == (8, 3, 32, 32)
            for b, i in zip(batch, idx):
                into[int(i)] = b
    ours.close()
    ref.close()
    assert sorted(seen) == list(range(32)) == sorted(jax_seen)
    for i in range(32):
        np.testing.assert_allclose(seen[i], pil[i], atol=1e-5, rtol=0,
                                   err_msg=f"decode mismatch idx={i}")
        np.testing.assert_array_equal(seen[i], jax_seen[i])


def test_native_loader_shuffles(tmp_path, rng):
    path, _ = _make_dataset(tmp_path, rng)
    loader = tnl.NativeImageLoader(path, resolution=32, batch=32,
                                   num_threads=1, shuffle=True, seed=1)
    _, idx = loader.next()
    loader.close()
    assert sorted(idx.tolist()) == list(range(32))
    assert idx.tolist() != list(range(32))  # shuffled order


def test_native_loader_epochs(tmp_path, rng):
    """Crossing an epoch boundary reshuffles and keeps streaming."""
    path, _ = _make_dataset(tmp_path, rng, n=8)
    loader = tnl.NativeImageLoader(path, resolution=32, batch=8,
                                   num_threads=1, shuffle=True, seed=0)
    orders = [tuple(loader.next()[1].tolist()) for _ in range(4)]
    loader.close()
    for o in orders:
        assert sorted(o) == list(range(8))
    assert len(set(orders)) > 1  # different epoch orders


def test_native_loader_rejects_empty_dataset(tmp_path):
    """length=0 datasets error at create instead of hanging the consumer."""
    path = str(tmp_path / "empty")
    write_lmdb(path, {b"length": b"0"})
    with pytest.raises(IOError):
        tnl.NativeImageLoader(path, resolution=32, batch=4, num_threads=2)


def test_native_loader_errors_on_wrong_resolution(tmp_path, rng):
    """A resolution with no keys in the LMDB raises after a full epoch of
    empty chunks; a closed loader raises its own error."""
    path, _ = _make_dataset(tmp_path, rng, n=8, res=32)
    loader = tnl.NativeImageLoader(path, resolution=64, batch=4,
                                   num_threads=2)
    try:
        with pytest.raises(RuntimeError, match="resolution"):
            loader.next()
    finally:
        loader.close()
    with pytest.raises(RuntimeError, match="closed"):
        loader.next()


def _stream(cls, path, steps, shuffle, threads, epoch_seed=None):
    loader = cls(path, resolution=32, batch=8, num_threads=threads,
                 shuffle=shuffle, seed=3, prefetch_depth=2)
    if epoch_seed is not None:
        loader.set_epoch(epoch_seed)
    out = [loader.next() for _ in range(steps)]
    loader.close()
    return out


@pytest.mark.parametrize("shuffle", [True, False])
def test_native_loader_matches_jax_one_thread(tmp_path, rng, shuffle):
    """One decode thread: the same index sequence and the same batches to
    the bit as the JAX package's loader over 3 epochs of 20 images in
    batches of 8 (a short chunk at each epoch's end), with set_epoch's
    seed taking effect at the next epoch."""
    path, _ = _make_dataset(tmp_path, rng, n=20, fmt="PNG")
    for epoch_seed in (None, 12345):
        ours = _stream(tnl.NativeImageLoader, path, 9, shuffle, 1,
                       epoch_seed)
        ref = _stream(jnl.NativeImageLoader, path, 9, shuffle, 1, epoch_seed)
        assert [len(i) for _, i in ours] == [8, 8, 4] * 3
        for (b, i), (rb, ri) in zip(ours, ref):
            np.testing.assert_array_equal(i, ri)
            np.testing.assert_array_equal(b, rb)
        epochs = [np.concatenate([i for _, i in ours[3 * e:3 * e + 3]])
                  for e in range(3)]
        for e in epochs:
            assert sorted(e.tolist()) == list(range(20))
        if shuffle:
            assert len({tuple(e.tolist()) for e in epochs}) == 3


@pytest.mark.parametrize("fmt", ["PNG", "JPEG"])
def test_native_loader_matches_jax_four_threads(tmp_path, rng, fmt):
    """Four decode threads: each epoch holds every index once, as the JAX
    package's loader's does, and each index gives the same image to the
    bit."""
    path, _ = _make_dataset(tmp_path, rng, n=20, fmt=fmt)
    ours = _stream(tnl.NativeImageLoader, path, 9, True, 4)
    ref = _stream(jnl.NativeImageLoader, path, 9, True, 4)
    images = {}
    for e in range(3):
        for stream in (ours, ref):
            idx = np.concatenate([i for _, i in stream[3 * e:3 * e + 3]])
            assert sorted(idx.tolist()) == list(range(20))
    for b, i in ref:
        images.update(zip(i.tolist(), b))
    for b, i in ours:
        for img, k in zip(b, i.tolist()):
            np.testing.assert_array_equal(img, images[k])


def test_native_loader_import_builds_nothing():
    """Importing the module compiles and loads nothing and prints
    nothing: the build waits for the first construction."""
    code = (
        "import subprocess, sys\n"
        "def refuse(*a, **k):\n"
        "    raise SystemExit('a process was started at import')\n"
        "subprocess.Popen = refuse\n"
        "import gangealing_torch.data.native_loader as nl\n"
        "assert nl._LIB is None\n"
        "bad = [m for m in ('gangealing_torch.data._native_build', 'PIL',"
        " 'cv2') if m in sys.modules]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == "" and proc.stderr == ""


def test_native_loader_names_missing_libraries(tmp_path, rng, monkeypatch):
    """With no decoder library in the directories searched, construction
    raises FileNotFoundError naming both globs and the directories, and
    builds nothing."""
    path, _ = _make_dataset(tmp_path, rng, n=4)
    empty = tmp_path / "no_libs"
    empty.mkdir()
    monkeypatch.setattr(tnl, "_LIB", None)
    monkeypatch.setattr(tnl, "_library_dirs", lambda: [str(empty)])

    def refuse(*a, **k):
        raise AssertionError("built without the libraries")
    monkeypatch.setattr(subprocess, "check_call", refuse)
    with pytest.raises(FileNotFoundError) as e:
        tnl.NativeImageLoader(path, resolution=32, batch=4)
    for part in ("libjpeg-*.so.62*", "libpng16-*.so.16*", str(empty)):
        assert part in str(e.value)
    assert tnl._LIB is None


def test_native_loader_library_directories_in_order(tmp_path):
    """Each library comes from the first directory that holds it: libpng16
    from the second where the first (Pillow's) lacks it; the first match
    wins where both hold one."""
    first, second = tmp_path / "pillow.libs", tmp_path / "opencv_python.libs"
    first.mkdir()
    second.mkdir()
    for f in (first / "libjpeg-aa.so.62.4.0", second / "libjpeg-bb.so.62.3",
              second / "libpng16-cc.so.16.58.0", first / "libz-dd.so.1"):
        f.write_bytes(b"")
    dirs = [str(first), str(second)]
    assert tnl._find_libraries(dirs) == [
        str(first / "libjpeg-aa.so.62.4.0"),
        str(second / "libpng16-cc.so.16.58.0")]
    (first / "libpng16-ee.so.16.53.0").write_bytes(b"")
    assert tnl._find_libraries(dirs)[1] == str(
        first / "libpng16-ee.so.16.53.0")
    dirs = tnl._library_dirs()
    assert [os.path.basename(d) for d in dirs] == ["pillow.libs",
                                                   "opencv_python.libs"]


def test_native_loader_rebuilds_a_library_linked_elsewhere(monkeypatch):
    """A library whose link line differs from this interpreter's (a build
    directory copied from another machine) is built again, and its link
    line kept beside it."""
    tnl.linked_libraries()
    so = os.path.join(REPO, "build", "torch_native", "libgt_loader.so")
    with open(so + ".link") as f:
        line = f.read()
    before = os.stat(so).st_ino
    with open(so + ".link", "w") as f:
        f.write("-I\n/elsewhere/include\n/elsewhere/libjpeg-0.so.62")
    monkeypatch.setattr(tnl, "_LIB", None)
    assert tnl.linked_libraries() == line.split("\n")[2:4]
    assert os.stat(so).st_ino != before
    with open(so + ".link") as f:
        assert f.read() == line
