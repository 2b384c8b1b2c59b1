"""LMDB key-value store: native C++ mmap reader + pure-Python bulk writer.

The port's own copy of gangealing_tpu/data/lmdb_io.py. The reference stores
datasets as LMDB environments of encoded images (datasets/dataset.py:12-48)
written via the python lmdb package (prepare_data.py:317-384). Neither
liblmdb nor the python package is needed: the on-disk format (public LMDB
v0.9 spec) is implemented directly, and both packages write and read the
same files byte for byte:

  * Reading (training/eval hot path): gangealing_torch/native/lmdb_kv.cc,
    a copy of native/lmdb_kv.cc — mmap + B+tree descent, zero-copy values,
    loaded via ctypes and built with g++ into build/torch_native/ beside
    the package (the JAX package builds into native/build/, so the two
    never race on one .so). A pure-Python fallback reader exists for
    environments without a compiler.
  * Writing (offline dataset builds): a bottom-up bulk B+tree writer —
    sorted keys packed into leaf pages, overflow pages for big values,
    branch levels, dual meta pages.
"""

import ctypes
import os
import struct
import subprocess
from typing import Dict, List, Optional, Tuple

MDB_MAGIC = 0xBEEFC0DE
MDB_VERSION = 1  # lmdb 0.9.x on-disk format
P_BRANCH, P_LEAF, P_OVERFLOW, P_META = 0x01, 0x02, 0x04, 0x08
P_LEAF2 = 0x20
F_BIGDATA, F_SUBDATA, F_DUPDATA = 0x01, 0x02, 0x04
# REVERSEKEY | DUPSORT | INTEGERKEY | DUPFIXED | INTEGERDUP | REVERSEDUP
DB_UNSUPPORTED_FLAGS = 0x3F
PAGEHDRSZ = 16
PSIZE = 4096
P_INVALID = 0xFFFFFFFFFFFFFFFF
NODESZ = 8


class LMDBFormatError(Exception):
    """The file is not an LMDB data file we can read — either corrupt or
    using format features the from-scratch reader intentionally rejects
    (DUPSORT sub-DBs, LEAF2 pages, non-0.9 versions). Raised instead of
    silently misreading (offline-compat risk: this reader is validated
    against our own writer only; see native/lmdb_kv.cc header)."""


# ---------------------------------------------------------------------------
# native reader (ctypes)
# ---------------------------------------------------------------------------

_LIB = None


def _native_lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    from gangealing_torch.data._native_build import build_shared_lib
    package = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = os.path.join(package, "native", "lmdb_kv.cc")
    so = os.path.join(os.path.dirname(package), "build", "torch_native",
                      "liblmdb_kv.so")
    build_shared_lib([src], so)
    lib = ctypes.CDLL(so)
    lib.gt_lmdb_open.restype = ctypes.c_void_p
    lib.gt_lmdb_open.argtypes = [ctypes.c_char_p]
    lib.gt_lmdb_close.argtypes = [ctypes.c_void_p]
    lib.gt_lmdb_entries.restype = ctypes.c_int64
    lib.gt_lmdb_entries.argtypes = [ctypes.c_void_p]
    lib.gt_lmdb_get.restype = ctypes.c_int64
    lib.gt_lmdb_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_size_t,
                                ctypes.POINTER(ctypes.c_void_p)]
    lib.gt_lmdb_last_error.restype = ctypes.c_char_p
    lib.gt_lmdb_last_error.argtypes = []
    _LIB = lib
    return lib


class LMDBReader:
    """Read-only LMDB environment (native if a compiler exists)."""

    def __init__(self, path: str, prefer_native: bool = True):
        self.path = path
        self._h = None
        self._py = None
        if prefer_native:
            lib = None
            try:
                lib = _native_lib()
            except (OSError, subprocess.CalledProcessError):
                pass  # no compiler: pure-Python fallback below
            if lib is not None:
                self._h = lib.gt_lmdb_open(path.encode())
                if not self._h:
                    err = (lib.gt_lmdb_last_error() or b"").decode()
                    environmental = any(s in err for s in (
                        "cannot open file", "fstat failed", "mmap failed"))
                    if err and not environmental:
                        # a real format problem — do not silently fall back
                        raise LMDBFormatError(f"{path}: {err}")
                    # environmental (missing file / mmap-hostile fs): the
                    # read()-based _PyReader below still works, or raises a
                    # clear FileNotFoundError itself
                else:
                    self._lib = lib
        if self._h is None:
            self._py = _PyReader(path)

    def get(self, key: bytes) -> Optional[bytes]:
        if self._h is not None:
            out = ctypes.c_void_p()
            n = self._lib.gt_lmdb_get(self._h, key, len(key),
                                      ctypes.byref(out))
            if n < 0:
                err = (self._lib.gt_lmdb_last_error() or b"").decode()
                if err:  # unsupported format feature, not a plain miss
                    raise LMDBFormatError(f"{self.path}: {err}")
                return None
            return ctypes.string_at(out, n)
        return self._py.get(key)

    @property
    def entries(self) -> int:
        if self._h is not None:
            return self._lib.gt_lmdb_entries(self._h)
        return self._py.entries

    def close(self):
        if self._h is not None:
            self._lib.gt_lmdb_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class _PyReader:
    """Pure-Python fallback reader (same tree walk as the native one)."""

    def __init__(self, path: str):
        fpath = os.path.join(path, "data.mdb") if os.path.isdir(path) else path
        self.path = fpath
        with open(fpath, "rb") as f:
            self.buf = f.read()
        if len(self.buf) < 2 * (PAGEHDRSZ + 136):  # sizeof(MDBMeta) == 136
            raise LMDBFormatError(f"{fpath}: file too small for LMDB metas")
        m0 = self._meta(0, 4096)
        if m0 is None:
            raise LMDBFormatError(f"{fpath}: bad magic, not an LMDB file")
        psize = m0[0]
        if psize < 512 or psize > 65536 or psize & (psize - 1):
            raise LMDBFormatError(
                f"{fpath}: unsupported page size {psize} "
                "(expect power of two in 512..65536)")
        m0 = self._meta(0, psize)
        m1 = self._meta(1, psize)
        metas = [m for m in (m0, m1) if m]
        best = max(metas, key=lambda m: m[3])
        psize_, root, entries, _, version, flags = best
        if version != MDB_VERSION:
            raise LMDBFormatError(
                f"{fpath}: unsupported LMDB format version {version} "
                "(expect 0.9.x, version 1)")
        if flags & DB_UNSUPPORTED_FLAGS:
            raise LMDBFormatError(
                f"{fpath}: main DB uses unsupported flags 0x{flags:x} "
                "(DUPSORT/DUPFIXED/INTEGERKEY/REVERSEKEY)")
        self.psize, self.root, self.entries = psize_, root, entries

    def _meta(self, pgno, psize):
        off = pgno * psize + PAGEHDRSZ
        # The farthest field read below is txnid at off+128..136; guard the
        # FULL meta extent so a truncated file yields a clean format error
        # instead of struct.error.
        if off + 136 > len(self.buf):
            return None
        magic, version = struct.unpack_from("<II", self.buf, off)
        if magic != MDB_MAGIC:
            return None
        # real lmdb: psize lives in the free DB's pad field (mm_psize)
        pad0 = struct.unpack_from("<I", self.buf, off + 24)[0]
        flags1 = struct.unpack_from("<H", self.buf, off + 24 + 48 + 4)[0]
        root1 = struct.unpack_from("<Q", self.buf, off + 24 + 48 + 40)[0]
        entries1 = struct.unpack_from("<Q", self.buf, off + 24 + 48 + 32)[0]
        txnid = struct.unpack_from("<Q", self.buf, off + 24 + 96 + 8)[0]
        return (pad0, root1, entries1, txnid, version, flags1)

    def get(self, key: bytes) -> Optional[bytes]:
        if self.root == P_INVALID:
            return None
        pgno = self.root
        for _ in range(64):
            base = pgno * self.psize
            if base + self.psize > len(self.buf):
                raise LMDBFormatError(
                    f"page {pgno} lies beyond the end of the file "
                    "(truncated or corrupt LMDB)")
            flags = struct.unpack_from("<H", self.buf, base + 10)[0]
            lower = struct.unpack_from("<H", self.buf, base + 12)[0]
            nkeys = (lower - PAGEHDRSZ) >> 1
            ptrs = struct.unpack_from(f"<{nkeys}H", self.buf,
                                      base + PAGEHDRSZ)

            def node(i):
                noff = base + ptrs[i]
                lo, hi, nflags, ksize = struct.unpack_from("<HHHH", self.buf,
                                                           noff)
                k = self.buf[noff + NODESZ:noff + NODESZ + ksize]
                return lo, hi, nflags, k, noff

            if flags & P_BRANCH:
                pick = 0
                lo_i, hi_i = 1, nkeys
                while lo_i < hi_i:
                    mid = (lo_i + hi_i) // 2
                    _, _, _, k, _ = node(mid)
                    if k <= key:
                        pick = mid
                        lo_i = mid + 1
                    else:
                        hi_i = mid
                lo, hi, nflags, _, _ = node(pick)
                pgno = lo | (hi << 16) | (nflags << 32)
            elif flags & P_LEAF:
                if flags & P_LEAF2:
                    raise LMDBFormatError(
                        f"{self.path}: LEAF2 (DUPFIXED) pages are not "
                        "supported")
                lo_i, hi_i = 0, nkeys
                while lo_i < hi_i:
                    mid = (lo_i + hi_i) // 2
                    lo, hi, nflags, k, noff = node(mid)
                    if k == key:
                        if nflags & (F_SUBDATA | F_DUPDATA):
                            raise LMDBFormatError(
                                "DUPSORT sub-databases are not supported")
                        dsize = lo | (hi << 16)
                        doff = noff + NODESZ + len(k)
                        if nflags & F_BIGDATA:
                            opg = struct.unpack_from("<Q", self.buf, doff)[0]
                            start = opg * self.psize + PAGEHDRSZ
                            if start + dsize > len(self.buf):
                                raise LMDBFormatError(
                                    f"overflow page {opg} extends beyond "
                                    "the end of the file (truncated LMDB)")
                            return self.buf[start:start + dsize]
                        return self.buf[doff:doff + dsize]
                    if k < key:
                        lo_i = mid + 1
                    else:
                        hi_i = mid
                return None
            else:
                return None
        return None


# ---------------------------------------------------------------------------
# bulk writer
# ---------------------------------------------------------------------------

def _page_header(pgno, flags, lower=0, upper=0, pages=0):
    if flags == P_OVERFLOW:
        return struct.pack("<QHHI", pgno, 0, flags, pages)
    return struct.pack("<QHHHH", pgno, 0, flags, lower, upper)


def _even(n):
    return (n + 1) & ~1


def write_lmdb(path: str, items: Dict[bytes, bytes], map_extra=0,
               psize: int = PSIZE):
    """Write a fresh single-file LMDB environment containing ``items``.

    Produces <path>/data.mdb (path treated as a directory, like lmdb.open).
    Keys are sorted bytewise (LMDB default compare). ``psize`` sets the
    page size (power of two, 512..65536; real lmdb defaults to the OS page
    size, usually 4096)."""
    if psize < 512 or psize > 65536 or psize & (psize - 1):
        raise ValueError(f"invalid LMDB page size {psize}")
    os.makedirs(path, exist_ok=True)
    keys = sorted(items.keys())
    for k in keys:
        if len(k) > 511:
            raise ValueError("key too long for LMDB")

    pages: List[bytes] = [b"", b""]  # meta pages filled at the end
    next_pgno = 2
    n_overflow = 0

    # max node payload that fits inline (conservative: half a page)
    max_inline = (psize - PAGEHDRSZ) // 2 - NODESZ - 64

    # 1. build leaves
    leaf_first_key: List[bytes] = []
    leaf_pgnos: List[int] = []
    cur_nodes: List[bytes] = []
    cur_space = psize - PAGEHDRSZ

    def flush_leaf():
        nonlocal cur_nodes, cur_space, next_pgno
        if not cur_nodes:
            return
        pgno = next_pgno
        next_pgno += 1
        nkeys = len(cur_nodes)
        lower = PAGEHDRSZ + 2 * nkeys
        body = b"".join(cur_nodes)
        upper = psize - len(body)
        ptrs = []
        off = upper
        for nd in cur_nodes:
            ptrs.append(off)
            off += len(nd)
        page = (_page_header(pgno, P_LEAF, lower, upper)
                + struct.pack(f"<{nkeys}H", *ptrs)
                + b"\x00" * (upper - lower) + body)
        assert len(page) == psize
        pages.append(page)
        leaf_pgnos.append(pgno)
        cur_nodes = []
        cur_space = psize - PAGEHDRSZ

    overflow_chunks: List[Tuple[int, bytes]] = []  # (pgno, data)

    for k in keys:
        v = items[k]
        big = len(v) > max_inline
        if big:
            # overflow chains must be contiguous pages; we allocate later,
            # after all leaves — use a placeholder resolved in pass 2.
            node_payload = struct.pack("<Q", 0)  # patched below
        else:
            node_payload = v
        node = struct.pack("<HHHH", len(v) & 0xFFFF, (len(v) >> 16) & 0xFFFF,
                           F_BIGDATA if big else 0, len(k)) + k + node_payload
        node = node + b"\x00" * (_even(len(node)) - len(node))
        need = len(node) + 2  # + ptr entry
        if need > cur_space:
            flush_leaf()
        if not cur_nodes:
            leaf_first_key.append(k)
        cur_nodes.append(node)
        cur_space -= need
    flush_leaf()

    # 2. allocate overflow pages after the leaves and patch BIGDATA pgnos
    big_values = [(k, items[k]) for k in keys if len(items[k]) > max_inline]
    ov_pgno_of = {}
    for k, v in big_values:
        # LMDB OVPAGES macro: ((PAGEHDRSZ - 1 + size) // psize) + 1
        npg = (PAGEHDRSZ - 1 + len(v)) // psize + 1
        # LMDB overflow data is contiguous from the first page's payload
        # across whole raw pages: only the first page carries a header.
        ov_pgno_of[k] = next_pgno
        raw = _page_header(next_pgno, P_OVERFLOW, pages=npg) + v
        pad = npg * psize - len(raw)
        raw += b"\x00" * pad
        for i in range(npg):
            pages.append(raw[i * psize:(i + 1) * psize])
        next_pgno += npg
        n_overflow += npg

    # patch leaf nodes with real overflow pgnos (rebuild pages)
    if big_values:
        ov_iter = dict(ov_pgno_of)
        for li, pg in enumerate(leaf_pgnos):
            raw = bytearray(pages[pg])
            lower = struct.unpack_from("<H", raw, 12)[0]
            nkeys = (lower - PAGEHDRSZ) >> 1
            ptrs = struct.unpack_from(f"<{nkeys}H", raw, PAGEHDRSZ)
            for off in ptrs:
                lo, hi, fl, ks = struct.unpack_from("<HHHH", raw, off)
                if fl & F_BIGDATA:
                    k = bytes(raw[off + NODESZ:off + NODESZ + ks])
                    struct.pack_into("<Q", raw, off + NODESZ + ks,
                                     ov_iter[k])
            pages[pg] = bytes(raw)

    # 3. build branch levels
    level_keys = leaf_first_key
    level_pgnos = leaf_pgnos
    n_branch = 0
    depth = 1
    while len(level_pgnos) > 1:
        new_keys, new_pgnos = [], []
        cur: List[Tuple[bytes, int]] = []
        space = psize - PAGEHDRSZ

        def flush_branch():
            nonlocal cur, space, next_pgno, n_branch
            if not cur:
                return
            pgno = next_pgno
            next_pgno += 1
            n_branch += 1
            nodes = []
            for i, (k, child) in enumerate(cur):
                kk = b"" if i == 0 else k
                nd = struct.pack("<HHHH", child & 0xFFFF,
                                 (child >> 16) & 0xFFFF,
                                 (child >> 32) & 0xFFFF, len(kk)) + kk
                nd = nd + b"\x00" * (_even(len(nd)) - len(nd))
                nodes.append(nd)
            nkeys = len(nodes)
            lower = PAGEHDRSZ + 2 * nkeys
            body = b"".join(nodes)
            upper = psize - len(body)
            ptrs = []
            off = upper
            for nd in nodes:
                ptrs.append(off)
                off += len(nd)
            page = (_page_header(pgno, P_BRANCH, lower, upper)
                    + struct.pack(f"<{nkeys}H", *ptrs)
                    + b"\x00" * (upper - lower) + body)
            assert len(page) == psize
            pages.append(page)
            new_keys.append(cur[0][0])
            new_pgnos.append(pgno)
            cur = []
            space = psize - PAGEHDRSZ

        for k, child in zip(level_keys, level_pgnos):
            need = _even(NODESZ + len(k)) + 2
            if need > space:
                flush_branch()
            cur.append((k, child))
            space -= need
        flush_branch()
        level_keys, level_pgnos = new_keys, new_pgnos
        depth += 1

    root = level_pgnos[0] if level_pgnos else P_INVALID
    if not keys:
        depth = 0

    last_pg = next_pgno - 1
    mapsize = (last_pg + 1) * psize + map_extra

    def meta(pgno, txnid):
        free_db = struct.pack("<IHHQQQQQ", psize, 0, 0, 0, 0, 0, 0, P_INVALID)
        main_db = struct.pack("<IHHQQQQQ", 0, 0, depth, n_branch,
                              len(leaf_pgnos), n_overflow, len(keys), root)
        m = struct.pack("<IIQQ", MDB_MAGIC, MDB_VERSION, 0, mapsize) \
            + free_db + main_db + struct.pack("<QQ", last_pg, txnid)
        page = _page_header(pgno, P_META) + m
        return page + b"\x00" * (psize - len(page))

    pages[0] = meta(0, 0)
    pages[1] = meta(1, 1)

    with open(os.path.join(path, "data.mdb"), "wb") as f:
        for p in pages:
            f.write(p)
    # an (empty) lock file for compatibility with real lmdb clients
    open(os.path.join(path, "lock.mdb"), "ab").close()


def iterate_keys(path):
    """Walk the B+tree and return all keys in order (cursor equivalent,
    used for LSUN-LMDB inputs to create_dataset). Returns [] for an
    empty environment; raises LMDBFormatError on pages get() would also
    reject (LEAF2/DUPSORT) instead of silently misreading them as keys."""
    r = _PyReader(path)
    out = []
    if r.root == P_INVALID:
        return out

    def walk(pgno):
        base = pgno * r.psize
        if base + r.psize > len(r.buf):
            raise LMDBFormatError(
                f"{r.path}: page {pgno} lies beyond the end of the file "
                "(truncated or corrupt LMDB)")
        flags = struct.unpack_from("<H", r.buf, base + 10)[0]
        if flags & P_LEAF2:
            raise LMDBFormatError(
                f"{r.path}: LEAF2 (DUPFIXED) pages are not supported")
        lower = struct.unpack_from("<H", r.buf, base + 12)[0]
        nkeys = (lower - PAGEHDRSZ) >> 1
        ptrs = struct.unpack_from(f"<{nkeys}H", r.buf, base + PAGEHDRSZ)
        for i in range(nkeys):
            noff = base + ptrs[i]
            lo, hi, nflags, ksize = struct.unpack_from("<HHHH", r.buf, noff)
            k = r.buf[noff + NODESZ:noff + NODESZ + ksize]
            if flags & P_BRANCH:
                walk(lo | (hi << 16) | (nflags << 32))
            else:
                if nflags & (F_SUBDATA | F_DUPDATA):
                    raise LMDBFormatError(
                        f"{r.path}: DUPSORT sub-databases are not supported")
                out.append(k)

    walk(r.root)
    return out
