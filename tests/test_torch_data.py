"""The port's data layer (data/lmdb_io.py, data/dataset.py, data/prepare.py
and cli/prepare_data.py) against the JAX package's, on the CPU.

Everything here is host code, so the tolerance is equality: LMDB files
equal to the byte, each package reading the other's files, the same
exceptions on the same corrupt files, datasets and loaders giving equal
arrays in the same order for the same seeds, and the dataset helpers
and builds equal on seeded inputs.
"""

import io
import json
import os
import struct
from importlib import import_module

import numpy as np
import pytest
import torch

from gangealing_torch.cli import prepare_data as tprep_cli
from gangealing_torch.data import dataset as tds
from gangealing_torch.data import lmdb_io as tio
from gangealing_torch.data import prepare as tprep

jio = import_module("gangealing_tpu.data.lmdb_io")
jds = import_module("gangealing_tpu.data.dataset")
jprep = import_module("gangealing_tpu.data.prepare")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _items(rng, n=60, psize=4096):
    """Values on both sides of the inline limit and over several pages."""
    max_inline = (psize - tio.PAGEHDRSZ) // 2 - tio.NODESZ - 64
    sizes = [0, 1, 7, max_inline - 1, max_inline, max_inline + 1,
             psize - tio.PAGEHDRSZ, psize - tio.PAGEHDRSZ + 1,
             3 * psize + 13]
    sizes += [int(s) for s in rng.randint(1, 4 * psize, n - len(sizes))]
    items = {f"key-{i:04d}".encode(): bytes(rng.randint(0, 256, s,
                                                        dtype=np.uint8))
             for i, s in enumerate(sizes)}
    items[b"length"] = str(len(sizes)).encode()
    return items


def _mdb(path):
    with open(os.path.join(path, "data.mdb"), "rb") as f:
        return f.read()


@pytest.mark.parametrize("psize", [512, 1024, 4096, 8192])
def test_write_lmdb_byte_equal_to_jax(tmp_path, psize):
    items = _items(np.random.RandomState(psize), psize=psize)
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    tio.write_lmdb(ours, items, psize=psize)
    jio.write_lmdb(ref, items, psize=psize)
    assert _mdb(ours) == _mdb(ref)
    assert os.path.exists(os.path.join(ours, "lock.mdb"))


def test_write_lmdb_many_keys_and_empty_byte_equal(tmp_path):
    """Enough keys for more than one branch level, and no keys at all."""
    many = {f"k{i:08d}".encode(): f"v{i}".encode() for i in range(20000)}
    for name, items in (("many", many), ("empty", {})):
        tio.write_lmdb(str(tmp_path / f"o{name}"), items)
        jio.write_lmdb(str(tmp_path / f"r{name}"), items)
        assert _mdb(str(tmp_path / f"o{name}")) == \
            _mdb(str(tmp_path / f"r{name}"))
        assert tio.iterate_keys(str(tmp_path / f"o{name}")) == \
            jio.iterate_keys(str(tmp_path / f"r{name}")) == sorted(items)


def test_each_package_reads_the_others_file(tmp_path):
    items = _items(np.random.RandomState(1))
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    tio.write_lmdb(ours, items)
    jio.write_lmdb(ref, items)
    readers = [tio.LMDBReader(ref), tio._PyReader(ref),
               jio.LMDBReader(ours), jio._PyReader(ours)]
    for r in readers:
        assert r.entries == len(items)
        for k, v in items.items():
            assert r.get(k) == v
        assert r.get(b"absent") is None


def test_port_uses_its_own_native_reader(tmp_path):
    """The port builds lmdb_kv.cc from its own copy into
    build/torch_native/, apart from the JAX package's native/build/."""
    path = str(tmp_path / "env")
    tio.write_lmdb(path, {b"a": b"1", b"length": b"0"})
    r = tio.LMDBReader(path)
    assert r._h is not None, "native reader failed to build/load"
    assert r.entries == 2 and r.get(b"a") == b"1"
    so = os.path.join(REPO, "build", "torch_native", "liblmdb_kv.so")
    assert os.path.exists(so)
    assert tio._LIB._name == so


def test_write_rejects_what_jax_rejects(tmp_path):
    for psize in (3000, 256):
        for mod in (tio, jio):
            with pytest.raises(ValueError):
                mod.write_lmdb(str(tmp_path / "x"), {b"a": b"b"},
                               psize=psize)
    for mod in (tio, jio):
        with pytest.raises(ValueError, match="key too long"):
            mod.write_lmdb(str(tmp_path / "y"), {b"k" * 512: b"v"})


def _patched(src, dst, patches):
    os.makedirs(dst, exist_ok=True)
    buf = bytearray(_mdb(src))
    for off, val in patches:
        buf[off:off + len(val)] = val
    with open(os.path.join(dst, "data.mdb"), "wb") as f:
        f.write(bytes(buf))
    return dst


META = tio.PAGEHDRSZ
CORRUPT = {  # the cases of tests/test_lmdb.py: patches of both metas
    "bad magic": (META, struct.pack("<I", 0xDEADBEEF), None),
    "bad version": (META + 4, struct.pack("<I", 999), "version"),
    "dupsort main db": (META + 24 + 48 + 4, struct.pack("<H", 0x04),
                        "[Uu]nsupported"),
    "bad page size": (META + 24, struct.pack("<I", 3000), "page size"),
}


@pytest.mark.parametrize("case", sorted(CORRUPT))
def test_format_errors_match_jax(tmp_path, case):
    rng = np.random.RandomState(2)
    items = {f"k{i}".encode(): bytes(rng.randint(0, 256, 100,
                                                 dtype=np.uint8))
             for i in range(10)}
    valid = str(tmp_path / "valid")
    tio.write_lmdb(valid, items)
    off, val, match = CORRUPT[case]
    bad = _patched(valid, str(tmp_path / "bad"), [(off, val),
                                                  (4096 + off, val)])
    errors = []
    for mod in (tio, jio):
        for reader in (mod.LMDBReader, mod._PyReader):
            with pytest.raises((mod.LMDBFormatError, IOError),
                               match=match) as e:
                reader(bad)
            errors.append((reader.__name__, type(e.value).__name__,
                           str(e.value)))
    assert errors[:2] == errors[2:]


def test_truncated_files_match_jax(tmp_path):
    """A file too small for the metas, and an overflow chain cut short:
    LMDBFormatError from both readers of both packages, on open or on the
    read that runs off the end."""
    short = str(tmp_path / "short")
    os.makedirs(short)
    with open(os.path.join(short, "data.mdb"), "wb") as f:
        f.write(b"\x00" * 64)
    big = bytes(np.random.RandomState(3).randint(0, 256, 64_000,
                                                 dtype=np.uint8))
    cut = str(tmp_path / "cut")
    tio.write_lmdb(cut, {b"big": big, b"small": b"x", b"length": b"1"})
    full = _mdb(cut)
    with open(os.path.join(cut, "data.mdb"), "wb") as f:
        f.write(full[:len(full) - 40_000])
    for mod in (tio, jio):
        with pytest.raises((mod.LMDBFormatError, IOError)):
            mod.LMDBReader(short)
        with pytest.raises(mod.LMDBFormatError):
            mod._PyReader(short)
        for reader in (mod.LMDBReader(cut), mod._PyReader(cut)):
            assert reader.get(b"small") == b"x"
            with pytest.raises(mod.LMDBFormatError,
                               match="overflow|beyond|truncated"):
                reader.get(b"big")


def _png(arr):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def pck_lmdb(tmp_path_factory):
    """12 images of 16 px with keypoints, visibility and SPair-shaped
    sidecars; a copy without pairs.pt for the seeded pairs."""
    rng = np.random.RandomState(4)
    n, res, P = 12, 16, 5
    items = {b"length": str(n).encode()}
    for i in range(n):
        items[f"{res}-{str(i).zfill(5)}".encode()] = _png(
            (rng.rand(res, res, 3) * 255).astype(np.uint8))
    root = tmp_path_factory.mktemp("pck")
    paths = {}
    for name in ("fixed", "seeded"):
        path = str(root / name)
        tio.write_lmdb(path, items)
        kps = np.concatenate([rng.rand(n, P, 2) * (res - 1),
                              rng.rand(n, P, 1) > 0.3], 2).astype(np.float32)
        torch.save(torch.from_numpy(kps), os.path.join(path, "keypoints.pt"))
        torch.save([1, 0, 2, 4, 3], os.path.join(path, "permutation.pt"))
        torch.save(torch.from_numpy(rng.rand(n).astype(np.float32) * 9 + 1),
                   os.path.join(path, "pck_thresholds.pt"))
        torch.save(torch.from_numpy(rng.rand(n, 3).astype(np.float32)),
                   os.path.join(path, "inverse_coordinates.pt"))
        paths[name] = path
    torch.save(torch.arange(n).view(n // 2, 2)[[2, 0, 5, 1, 4, 3]],
               os.path.join(paths["fixed"], "pairs.pt"))
    return paths, res


def _equal(ours, ref):
    if isinstance(ref, dict):
        assert set(ours) == set(ref)
        for k in ref:
            _equal(ours[k], ref[k])
    elif isinstance(ref, (tuple, list)):
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            _equal(a, b)
    else:
        a, b = np.asarray(ours), np.asarray(ref)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_multiresolution_dataset_matches_jax(pck_lmdb):
    paths, res = pck_lmdb
    for ri in (False, True):
        ours = tds.MultiResolutionDataset(paths["fixed"], res, ri)
        ref = jds.MultiResolutionDataset(paths["fixed"], res, ri)
        assert len(ours) == len(ref) == 12
        for i in range(len(ref)):
            _equal(ours[i], ref[i])
            assert ours.raw_bytes(i) == ref.raw_bytes(i)
    with pytest.raises(KeyError):
        tds.MultiResolutionDataset(paths["fixed"], res + 1)[0]


def test_pck_dataset_matches_jax(pck_lmdb):
    """Fixed pairs with every sidecar, seeded pairs and their redraws, and
    the fixed pairs' bootstrap draws."""
    paths, res = pck_lmdb
    for name, seed in (("fixed", 0), ("seeded", 0), ("seeded", 7)):
        ours = tds.PCKDataset(paths[name], res, seed=seed)
        ref = jds.PCKDataset(paths[name], res, seed=seed)
        for attr in ("keypoints", "pairs", "mirror_permutation",
                     "thresholds", "inverse_ops"):
            _equal(getattr(ours, attr), getattr(ref, attr))
        assert len(ours) == len(ref)
        for i in range(len(ref)):
            _equal(ours[i], ref[i])
        if name == "fixed":
            ours.randomize_fixed_pairs(11)
            ref.randomize_fixed_pairs(11)
        else:
            ours.randomize_pairs(11)
            ref.randomize_pairs(11)
        _equal(ours.pairs, ref.pairs)


@pytest.mark.parametrize("shuffle,drop_last,shards", [
    (False, False, 1), (True, True, 1), (True, False, 3), (False, True, 5),
    (True, False, 20)])
def test_dataloader_matches_jax(pck_lmdb, shuffle, drop_last, shards):
    """The seeded shuffle, the epochs, the tail batch and the per-process
    striding (tiled when there are more shards than images)."""
    paths, res = pck_lmdb
    ours = tds.MultiResolutionDataset(paths["fixed"], res, True)
    ref = jds.MultiResolutionDataset(paths["fixed"], res, True)
    for shard in range(shards):
        kw = dict(batch_size=5, shuffle=shuffle, seed=3,
                  drop_last=drop_last, num_shards=shards, shard_index=shard)
        lo, lr = tds.DataLoader(ours, **kw), jds.DataLoader(ref, **kw)
        for epoch in (0, 4):
            lo.set_epoch(epoch)
            lr.set_epoch(epoch)
            assert len(lo) == len(lr)
            _equal(list(lo), list(lr))


def test_loaders_and_subset_match_jax(pck_lmdb):
    """img_dataloader (infinite, over a Subset, finite with indices) and
    pck_dataloader across epoch boundaries."""
    paths, res = pck_lmdb
    subset = [3, 1, 4, 1, 5, 9, 2, 6]
    its = [m.img_dataloader(paths["fixed"], res, seed=5, batch_size=3,
                            subset=subset) for m in (tds, jds)]
    _equal([next(its[0]) for _ in range(7)], [next(its[1]) for _ in range(7)])
    loaders = [m.img_dataloader(paths["fixed"], res, batch_size=5,
                                shuffle=False, return_indices=True,
                                infinite=False, drop_last=False)
               for m in (tds, jds)]
    _equal(list(loaders[0]), list(loaders[1]))
    its = [m.pck_dataloader(paths["seeded"], res, seed=2, batch_size=4)
           for m in (tds, jds)]
    _equal([next(its[0]) for _ in range(5)], [next(its[1]) for _ in range(5)])


@pytest.mark.parametrize("n", [0.5, 1.5, 2.5, -0.5, -1.5, 2.675, 3.4999,
                               7.0, -2.5000001])
def test_python2_round_matches_jax(n):
    assert tprep.python2_round(n) == jprep.python2_round(n)


def test_bbox_helpers_and_acsm_crop_match_jax():
    rng = np.random.RandomState(5)
    img = (rng.rand(40, 52, 3) * 255).astype(np.uint8)
    for _ in range(6):
        x0, y0 = rng.uniform(-10, 30, 2)
        bbox = [x0, y0, x0 + rng.uniform(5, 40), y0 + rng.uniform(5, 40)]
        for py2 in (True, False):
            assert tprep.square_bbox(bbox, py2) == \
                jprep.square_bbox(bbox, py2)
            sq = tprep.square_bbox(bbox, py2)
            for border in (True, False):
                _equal(tprep.acsm_crop(img, sq, 7, border, py2),
                       jprep.acsm_crop(img, sq, 7, border, py2))
        np.random.seed(6)
        ours = tprep.perturb_bbox(bbox, 0.05, 0.1)
        np.random.seed(6)
        assert ours == jprep.perturb_bbox(bbox, 0.05, 0.1)
        kps = np.concatenate([rng.rand(15, 2) * 50, rng.rand(15, 1) > 0.5],
                             1).astype(np.float32)
        _equal(tprep.preprocess_kps_box_crop(kps, sq, 64),
               jprep.preprocess_kps_box_crop(kps, sq, 64))
    for w, h in ((52, 40), (40, 52), (33, 33)):
        kps = np.concatenate([rng.rand(15, 2) * 30, rng.rand(15, 1) > 0.5],
                             1).astype(np.float32)
        _equal(tprep.preprocess_kps_pad(kps, w, h, 64),
               jprep.preprocess_kps_pad(kps, w, h, 64))


@pytest.mark.parametrize("pad", ["zero", "border", "center", "none",
                                 "resize_small_side", "cub_crop"])
def test_pads_and_resize_and_convert_match_jax(pad):
    from PIL import Image
    rng = np.random.RandomState(7)
    for w, h in ((52, 40), (40, 52), (33, 33)):
        img = Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8))
        bbox = tprep.square_bbox([3.2, 4.7, 30.1, 28.9])
        for fmt in ("png", "jpeg"):
            assert tprep.resize_and_convert(img, 24, pad, format=fmt,
                                            bbox=bbox) == \
                jprep.resize_and_convert(img, 24, pad, format=fmt, bbox=bbox)
        for fn in ("black_bar_pad", "border_pad"):
            # unresized, an image is padded to its own square
            for resize, res in ((True, 64), (False, max(w, h))):
                _equal(getattr(tprep, fn)(img, res, resize, False),
                       getattr(jprep, fn)(img, res, resize, False))


def _image_folder(root, n=9):
    from PIL import Image
    rng = np.random.RandomState(8)
    src = root / "src"
    src.mkdir()
    for i in range(n):
        Image.fromarray((rng.rand(30 + i, 40, 3) * 255).astype(
            np.uint8)).save(str(src / f"{i:05d}.png"))
    (src / "00004.png").write_bytes(b"not an image")  # skipped, compacted
    return str(src)


def test_create_dataset_matches_jax(tmp_path):
    """An image folder at two sizes (threads and sequential), an LMDB of
    encoded images as input, and the CLI: byte-equal LMDBs."""
    src = _image_folder(tmp_path)
    kw = dict(pad="border", format="png", progress=False)
    n = [tprep.create_dataset(str(tmp_path / "o1"), src, "32,16", workers=1,
                              **kw),
         tprep.create_dataset(str(tmp_path / "o8"), src, "32,16", workers=4,
                              **kw),
         jprep.create_dataset(str(tmp_path / "r"), src, "32,16", workers=1,
                              **kw)]
    assert n == [8, 8, 8]
    assert _mdb(str(tmp_path / "o1")) == _mdb(str(tmp_path / "o8")) == \
        _mdb(str(tmp_path / "r"))
    assert tprep.create_dataset(str(tmp_path / "ol"), str(tmp_path / "r"),
                                "24", pad="center", input_is_lmdb=True,
                                progress=False) == \
        jprep.create_dataset(str(tmp_path / "rl"), str(tmp_path / "r"),
                             "24", pad="center", input_is_lmdb=True,
                             progress=False) == 16
    assert _mdb(str(tmp_path / "ol")) == _mdb(str(tmp_path / "rl"))
    assert tprep_cli.main(["--out", str(tmp_path / "cli"), "--path", src,
                           "--size", "32,16", "--pad", "border", "--format",
                           "png", "--workers", "2"]) == 8
    assert _mdb(str(tmp_path / "cli")) == _mdb(str(tmp_path / "r"))


def test_spair_loader_matches_jax(tmp_path):
    """A synthetic SPair-71K tree (pair and image annotations): the file
    list and every sidecar equal."""
    rng = np.random.RandomState(9)
    root = tmp_path / "spair"
    for sub in ("PairAnnotation/test", "ImageAnnotation/cat",
                "JPEGImages/cat"):
        (root / sub).mkdir(parents=True)
    (root / "ImageAnnotation/cat/a.json").write_text(
        json.dumps({"kps": {str(i): None for i in range(15)}}))
    for p in range(4):
        sizes = [[int(rng.randint(30, 80)), int(rng.randint(30, 80)), 3]
                 for _ in range(2)]
        ids = sorted(rng.choice(14, 6, replace=False).tolist())
        pair = {"category": "cat", "mirror": 0,
                "src_imname": f"s{p}.jpg", "trg_imname": f"t{p}.jpg",
                "src_imsize": sizes[0], "trg_imsize": sizes[1],
                "src_bndbox": rng.randint(0, 30, 4).tolist(),
                "trg_bndbox": rng.randint(0, 30, 4).tolist(),
                "kps_ids": [str(i) for i in ids],
                "src_kps": (rng.rand(6, 2) * 30).tolist(),
                "trg_kps": (rng.rand(6, 2) * 30).tolist()}
        (root / f"PairAnnotation/test/{p:06d}-s-t:cat.json").write_text(
            json.dumps(pair))
    outs = [tmp_path / "o", tmp_path / "r"]
    for o in outs:
        o.mkdir()
    got = tprep.load_spair_data(str(root), 64, str(outs[0]), "cat", "test")
    want = jprep.load_spair_data(str(root), 64, str(outs[1]), "cat", "test")
    assert got == want
    for name in ("pairs.pt", "pck_thresholds.pt", "inverse_coordinates.pt",
                 "keypoints.pt", "permutation.pt"):
        a = torch.load(outs[0] / name, weights_only=False)
        b = torch.load(outs[1] / name, weights_only=False)
        if torch.is_tensor(b):
            assert a.dtype == b.dtype and torch.equal(a, b), name
        else:
            assert a == b, name


def test_cub_acsm_loader_matches_jax(tmp_path):
    """A synthetic CUB tree (the 11,788 x 15 part locations) and an ACSM
    .mat of 5 images: files, boxes and sidecars equal."""
    from scipy.io import savemat
    rng = np.random.RandomState(10)
    (tmp_path / "cub" / "parts").mkdir(parents=True)
    rows = np.arange(11788 * 15)
    locs = np.stack([rows // 15 + 1, rows % 15 + 1,
                     np.round(rng.rand(len(rows)) * 300, 1),
                     np.round(rng.rand(len(rows)) * 300, 1),
                     rng.randint(0, 2, len(rows))], 1)
    np.savetxt(tmp_path / "cub" / "parts" / "part_locs.txt", locs,
               fmt=["%d", "%d", "%.1f", "%.1f", "%d"])
    n = 5
    box = np.dtype([("x1", "O"), ("y1", "O"), ("x2", "O"), ("y2", "O")])
    images = np.zeros((1, n), dtype=[("rel_path", "O"), ("id", "O"),
                                     ("bbox", "O")])
    for i in range(n):
        b = np.zeros((1, 1), box)
        x1, y1 = rng.uniform(1, 100, 2)
        for k, v in zip(box.names, (x1, y1, x1 + rng.uniform(20, 150),
                                    y1 + rng.uniform(20, 150))):
            b[0, 0][k] = np.array([[v]])
        images[0, i] = (np.array([f"d/{i}.jpg"]),
                        np.array([[int(rng.randint(1, 11789))]]), b)
    mat = str(tmp_path / "val.mat")
    savemat(mat, {"images": images})
    outs = [tmp_path / "o", tmp_path / "r"]
    results = []
    for mod, o in zip((tprep, jprep), outs):
        o.mkdir()
        np.random.seed(11)
        results.append(mod.load_acsm_data(str(tmp_path / "cub"), mat, 64,
                                          str(o)))
    assert results[0][0] == results[1][0]
    _equal(results[0][1], results[1][1])
    assert torch.equal(torch.load(outs[0] / "keypoints.pt"),
                       torch.load(outs[1] / "keypoints.pt"))
    assert torch.load(outs[0] / "permutation.pt") == \
        torch.load(outs[1] / "permutation.pt")


@pytest.mark.cuda
def test_native_reader_feeds_the_card(tmp_path):
    """On the card's machine: the port's native reader built under
    build/torch_native/ and a batch it decoded moved to the card
    unchanged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    imgs = (np.random.RandomState(12).rand(6, 16, 16, 3) * 255).astype(
        np.uint8)
    items = {f"16-{str(i).zfill(5)}".encode(): _png(im)
             for i, im in enumerate(imgs)}
    items[b"length"] = b"6"
    path = str(tmp_path / "env")
    tio.write_lmdb(path, items)
    dset = tds.MultiResolutionDataset(path, 16)
    assert dset.reader._h is not None
    assert tio._LIB._name == os.path.join(REPO, "build", "torch_native",
                                          "liblmdb_kv.so")
    batch = next(iter(tds.DataLoader(dset, batch_size=6)))
    on_card = torch.from_numpy(batch).cuda()
    assert torch.equal(on_card.cpu(), torch.from_numpy(batch))
    np.testing.assert_array_equal(
        batch, imgs.transpose(0, 3, 1, 2).astype(np.float32) / 255 * 2 - 1)
