"""Datasets: multi-resolution LMDB image store + PCK pair dataset + loaders.

The port's own copy of gangealing_tpu/data/dataset.py: the same numpy
batches, the same seeded shuffles, pair draws and index striding.

Capability reference: datasets/dataset.py (MultiResolutionDataset,
sample_infinite_data), datasets/pck_dataset.py (PCKDataset,
sample_infinite_pck_data), datasets/__init__.py (img_dataloader,
pck_dataloader).

Host-side numpy pipeline: decode on CPU with PIL, one image at a time,
batch, then the caller moves the batch to the device. Per-process
sharding of indices replicates DistributedSampler's rank striding.
"""

import io
import os
from typing import Iterator

import numpy as np

from gangealing_torch.data.lmdb_io import LMDBReader


def _decode_image(img_bytes: bytes) -> np.ndarray:
    """Encoded image bytes -> (C, H, W) float32 in [-1, 1]."""
    from PIL import Image
    img = Image.open(io.BytesIO(img_bytes))
    arr = np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0
    arr = arr.transpose(2, 0, 1)
    return arr * 2.0 - 1.0


class MultiResolutionDataset:
    """Images stored under keys f'{resolution}-{index:05}'
    (datasets/dataset.py:38)."""

    def __init__(self, path: str, resolution: int = 256,
                 return_indices: bool = False):
        self.reader = LMDBReader(path)
        length = self.reader.get(b"length")
        if length is None:
            raise IOError(f"no 'length' key in lmdb at {path}")
        self.length = int(length.decode())
        self.resolution = resolution
        self.return_indices = return_indices

    def __len__(self):
        return self.length

    def raw_bytes(self, index: int) -> bytes:
        key = f"{self.resolution}-{str(index).zfill(5)}".encode()
        data = self.reader.get(key)
        if data is None:
            raise KeyError(f"missing key {key!r}")
        return data

    def __getitem__(self, index: int):
        img = _decode_image(self.raw_bytes(index))
        if self.return_indices:
            return img, index
        return img


class PCKDataset(MultiResolutionDataset):
    """Image/keypoint pairs for PCK-Transfer eval
    (datasets/pck_dataset.py:10-91). Sidecar tensors are torch .pt files."""

    def __init__(self, path: str, resolution: int = 256, seed: int = 0):
        super().__init__(path, resolution)
        import torch
        kp_path = os.path.join(path, "keypoints.pt")
        assert os.path.isfile(kp_path), "Could not find a keypoints.pt file"
        self.keypoints = np.asarray(torch.load(kp_path, weights_only=False),
                                    dtype=np.float32)
        pairs_path = os.path.join(path, "pairs.pt")
        if os.path.isfile(pairs_path):
            self.fixed_pairs = np.asarray(
                torch.load(pairs_path, weights_only=False), dtype=np.int64)
            self.pairs = self.fixed_pairs
            self.rng = None
        else:
            self.fixed_pairs = None
            self.rng = np.random.RandomState(seed)
            self.randomize_pairs(seed)
        perm_path = os.path.join(path, "permutation.pt")
        self.mirror_permutation = (
            np.asarray(torch.load(perm_path, weights_only=False),
                       dtype=np.int64)
            if os.path.isfile(perm_path) else None)
        th_path = os.path.join(path, "pck_thresholds.pt")
        inv_path = os.path.join(path, "inverse_coordinates.pt")
        assert os.path.isfile(th_path) == os.path.isfile(inv_path)
        if os.path.isfile(th_path):
            self.thresholds = np.asarray(
                torch.load(th_path, weights_only=False), dtype=np.float32)
            self.inverse_ops = np.asarray(
                torch.load(inv_path, weights_only=False), dtype=np.float32)
        else:
            self.thresholds = None
            self.inverse_ops = None
        assert self.pairs.ndim == 2 and self.pairs.shape[-1] == 2

    def randomize_pairs(self, seed=None):
        if self.rng is None:
            return
        if seed is not None:
            self.rng = np.random.RandomState(seed % (2 ** 32))
        indices = self.rng.permutation(self.length)
        if indices.shape[0] % 2 == 1:
            indices = indices[:-1]
        self.pairs = indices.reshape(-1, 2)

    def randomize_fixed_pairs(self, seed=None):
        rng = np.random.RandomState(seed % (2 ** 32)) if seed is not None \
            else np.random
        indices = rng.randint(0, len(self), size=(len(self),))
        self.pairs = self.fixed_pairs[indices]

    def __len__(self):
        return self.pairs.shape[0]

    def __getitem__(self, index: int):
        ixA, ixB = int(self.pairs[index][0]), int(self.pairs[index][1])
        out = {
            "imgsA": MultiResolutionDataset.__getitem__(self, ixA),
            "imgsB": MultiResolutionDataset.__getitem__(self, ixB),
            "kpsA": self.keypoints[ixA],
            "kpsB": self.keypoints[ixB],
            "index": index,
        }
        if self.thresholds is not None:
            out["threshA"] = self.thresholds[ixA]
            out["scaleA"] = self.inverse_ops[ixA, 2]
            out["threshB"] = self.thresholds[ixB]
            out["scaleB"] = self.inverse_ops[ixB, 2]
        return out


def _collate(samples):
    if isinstance(samples[0], dict):
        return {k: _collate([s[k] for s in samples]) for k in samples[0]}
    if isinstance(samples[0], tuple):
        return tuple(_collate([s[i] for s in samples])
                     for i in range(len(samples[0])))
    return np.stack([np.asarray(s) for s in samples])


class DataLoader:
    """Minimal batching loader with optional shuffling and per-process
    (multi-host) index striding — the DistributedSampler equivalent."""

    def __init__(self, dataset, batch_size=64, shuffle=False, seed=0,
                 drop_last=True, num_shards=1, shard_index=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.drop_last = drop_last
        self.num_shards = num_shards
        self.shard_index = shard_index

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _indices(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState((self.seed + self.epoch) % (2 ** 32))
            idx = rng.permutation(n)
        else:
            idx = np.arange(n)
        # rank striding (DistributedSampler semantics: pad to world size,
        # TILING the index list when n < num_shards so every shard gets
        # the same count — unequal shards make lock-step multi-host loops
        # enter collectives a different number of times and deadlock)
        if self.num_shards > 1:
            total = ((n + self.num_shards - 1) // self.num_shards
                     * self.num_shards)
            if total > n:
                reps = np.tile(idx, (total - n + n - 1) // n)
                idx = np.concatenate([idx, reps[:total - n]])
            idx = idx[self.shard_index::self.num_shards]
        return idx

    def _shard_len(self):
        # per-shard index count, arithmetically (no O(n) permutation)
        n = len(self.dataset)
        if self.num_shards > 1:
            return (n + self.num_shards - 1) // self.num_shards
        return n

    def __len__(self):
        n = self._shard_len()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator:
        idx = self._indices()
        nb = len(self)
        for b in range(nb):
            chunk = idx[b * self.batch_size:(b + 1) * self.batch_size]
            yield _collate([self.dataset[int(i)] for i in chunk])


def img_dataloader(path=None, resolution=256, seed=0, batch_size=64,
                   shuffle=True, dset=None, return_indices=False,
                   infinite=True, subset=None, drop_last=True,
                   num_shards=1, shard_index=0):
    """(datasets/__init__.py:20-30)."""
    if dset is None:
        dset = MultiResolutionDataset(path, resolution, return_indices)
    if subset is not None:
        dset = Subset(dset, subset)
    loader = DataLoader(dset, batch_size=batch_size, shuffle=shuffle,
                        seed=seed, drop_last=drop_last,
                        num_shards=num_shards, shard_index=shard_index)
    if infinite:
        return sample_infinite_data(loader, seed)
    return loader


def pck_dataloader(path, resolution=256, seed=0, batch_size=64,
                   infinite=True, num_shards=1, shard_index=0):
    dset = PCKDataset(path, resolution, seed)
    loader = DataLoader(dset, batch_size=batch_size, shuffle=False,
                        seed=seed, drop_last=False, num_shards=num_shards,
                        shard_index=shard_index)
    if infinite:
        return sample_infinite_pck_data(loader, seed)
    return loader


class Subset:
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]


def sample_infinite_data(loader: DataLoader, seed=0):
    """Epoch-reshuffling infinite iterator (datasets/dataset.py:51-63)."""
    rng = np.random.RandomState(seed)
    while True:
        loader.set_epoch(int(rng.randint(0, 2 ** 31)))
        for batch in loader:
            yield batch


def sample_infinite_pck_data(loader: DataLoader, seed=0):
    """Pair-resampling infinite iterator (datasets/pck_dataset.py:93-104)."""
    rng = np.random.RandomState(seed)
    while True:
        loader.dataset.randomize_pairs(int(rng.randint(0, 2 ** 31)))
        for batch in loader:
            yield batch
