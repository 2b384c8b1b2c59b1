// Minimal read-only LMDB (Lightning Memory-Mapped Database) reader.
//
// The reference framework stores datasets as LMDB files of encoded images
// (reference datasets/dataset.py:12-48). This container has neither liblmdb
// nor the python lmdb package, so we implement the on-disk format directly:
// mmap the file, pick the newest valid meta page, and walk the main DB's
// B+tree for point lookups. Read-only, single data file (data.mdb).
//
// Format reference: the public LMDB spec (mdb.c / lmdb.h, OpenLDAP, v0.9).
// Covers: branch/leaf pages, overflow (BIGDATA) values, 2-byte indx offsets.
// Not covered (unused by the reference datasets): DUPSORT/DUPFIXED subpages,
// named sub-databases, LEAF2 pages.
//
// Exposed via a C ABI for ctypes.

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t MDB_MAGIC = 0xBEEFC0DE;
constexpr uint32_t MDB_DATA_VERSION = 1;  // lmdb 0.9.x on-disk format
constexpr uint16_t P_BRANCH = 0x01;
constexpr uint16_t P_LEAF = 0x02;
constexpr uint16_t P_OVERFLOW = 0x04;
constexpr uint16_t P_META = 0x08;
constexpr uint16_t P_LEAF2 = 0x20;
constexpr uint16_t F_BIGDATA = 0x01;
constexpr uint16_t F_SUBDATA = 0x02;
constexpr uint16_t F_DUPDATA = 0x04;
// main-DB flags we cannot read (lmdb.h): REVERSEKEY, DUPSORT, INTEGERKEY,
// DUPFIXED, INTEGERDUP, REVERSEDUP
constexpr uint16_t DB_UNSUPPORTED_FLAGS = 0x3F;
constexpr size_t PAGEHDRSZ = 16;
constexpr uint64_t P_INVALID = ~uint64_t{0};

thread_local char g_err[256] = "";

void set_err(const char* msg) {
  snprintf(g_err, sizeof(g_err), "%s", msg);
}

#pragma pack(push, 1)
struct PageHeader {
  uint64_t pgno;
  uint16_t pad;
  uint16_t flags;
  union {
    struct {
      uint16_t lower;
      uint16_t upper;
    } pb;
    uint32_t pages;  // overflow page count
  };
};

struct MDBDb {
  uint32_t pad;             // psize for FREE_DBI slot in meta
  uint16_t flags;
  uint16_t depth;
  uint64_t branch_pages;
  uint64_t leaf_pages;
  uint64_t overflow_pages;
  uint64_t entries;
  uint64_t root;
};

struct MDBMeta {
  uint32_t magic;
  uint32_t version;
  uint64_t address;
  uint64_t mapsize;
  MDBDb dbs[2];
  uint64_t last_pg;
  uint64_t txnid;
};

struct NodeHeader {
  uint16_t lo;
  uint16_t hi;
  uint16_t flags;
  uint16_t ksize;
};
#pragma pack(pop)

struct Env {
  const uint8_t* map = nullptr;
  size_t size = 0;
  size_t psize = 4096;
  uint64_t root = P_INVALID;
  uint64_t entries = 0;
  int fd = -1;
};

inline const PageHeader* page(const Env* e, uint64_t pgno) {
  if ((pgno + 1) * e->psize > e->size) return nullptr;
  return reinterpret_cast<const PageHeader*>(e->map + pgno * e->psize);
}

inline size_t numkeys(const PageHeader* p) {
  return (p->pb.lower - PAGEHDRSZ) >> 1;
}

inline const NodeHeader* node(const Env* e, const PageHeader* p, size_t i) {
  const uint16_t* ptrs = reinterpret_cast<const uint16_t*>(
      reinterpret_cast<const uint8_t*>(p) + PAGEHDRSZ);
  return reinterpret_cast<const NodeHeader*>(
      reinterpret_cast<const uint8_t*>(p) + ptrs[i]);
}

inline const uint8_t* node_key(const NodeHeader* n) {
  return reinterpret_cast<const uint8_t*>(n) + sizeof(NodeHeader);
}

inline uint64_t branch_pgno(const NodeHeader* n) {
  return uint64_t(n->lo) | (uint64_t(n->hi) << 16) |
         (uint64_t(n->flags) << 32);
}

inline uint64_t leaf_datasize(const NodeHeader* n) {
  return uint64_t(n->lo) | (uint64_t(n->hi) << 16);
}

int cmp(const uint8_t* a, size_t alen, const uint8_t* b, size_t blen) {
  size_t m = alen < blen ? alen : blen;
  int c = memcmp(a, b, m);
  if (c) return c;
  return (alen > blen) - (alen < blen);
}

}  // namespace

extern "C" {

const char* gt_lmdb_last_error() { return g_err; }

void* gt_lmdb_open(const char* path) {
  set_err("");
  Env* e = new Env();
  // Accept either a directory (containing data.mdb) or a file path.
  char buf[4096];
  struct stat st;
  const char* fpath = path;
  if (stat(path, &st) == 0 && S_ISDIR(st.st_mode)) {
    snprintf(buf, sizeof(buf), "%s/data.mdb", path);
    fpath = buf;
  }
  e->fd = open(fpath, O_RDONLY);
  if (e->fd < 0) { set_err("cannot open file"); delete e; return nullptr; }
  if (fstat(e->fd, &st) != 0) {
    set_err("fstat failed"); close(e->fd); delete e; return nullptr;
  }
  e->size = size_t(st.st_size);
  if (e->size < 2 * (PAGEHDRSZ + sizeof(MDBMeta))) {
    set_err("file too small for LMDB meta pages");
    close(e->fd); delete e; return nullptr;
  }
  e->map = static_cast<const uint8_t*>(
      mmap(nullptr, e->size, PROT_READ, MAP_SHARED, e->fd, 0));
  if (e->map == MAP_FAILED) {
    set_err("mmap failed"); close(e->fd); delete e; return nullptr;
  }

  auto fail = [&](const char* msg) -> void* {
    set_err(msg);
    munmap(const_cast<uint8_t*>(e->map), e->size);
    close(e->fd);
    delete e;
    return nullptr;
  };

  // meta pages live at pgno 0 and 1; psize unknown until we read meta, but
  // meta 0 is always at offset 0 (real lmdb stores psize in the free DB's
  // pad field, mdb.c: #define mm_psize mm_dbs[FREE_DBI].md_pad).
  const MDBMeta* m0 = reinterpret_cast<const MDBMeta*>(e->map + PAGEHDRSZ);
  if (m0->magic != MDB_MAGIC)
    return fail("bad magic: not an LMDB data file");
  size_t psize = m0->dbs[0].pad;
  if (psize < 512 || psize > 65536 || (psize & (psize - 1)) != 0)
    return fail("unsupported page size (expect power of two in 512..65536)");
  if (2 * psize > e->size)
    return fail("file too small for both meta pages");
  const MDBMeta* m1 =
      reinterpret_cast<const MDBMeta*>(e->map + psize + PAGEHDRSZ);
  const MDBMeta* best = m0;
  if (m1->magic == MDB_MAGIC && m1->txnid > best->txnid) best = m1;
  if (best->version != MDB_DATA_VERSION)
    return fail("unsupported LMDB format version (expect 0.9.x, version 1)");
  if (best->dbs[1].flags & DB_UNSUPPORTED_FLAGS)
    return fail("main DB uses unsupported flags "
                "(DUPSORT/DUPFIXED/INTEGERKEY/REVERSEKEY)");
  e->psize = psize;
  e->root = best->dbs[1].root;
  e->entries = best->dbs[1].entries;
  return e;
}

void gt_lmdb_close(void* h) {
  Env* e = static_cast<Env*>(h);
  if (!e) return;
  if (e->map) munmap(const_cast<uint8_t*>(e->map), e->size);
  if (e->fd >= 0) close(e->fd);
  delete e;
}

int64_t gt_lmdb_entries(void* h) {
  return static_cast<Env*>(h)->entries;
}

// Point lookup. On hit, *val points INTO the mmap (zero copy) and the value
// length is returned. Returns -1 on miss / error.
int64_t gt_lmdb_get(void* h, const uint8_t* key, size_t klen,
                    const uint8_t** val) {
  set_err("");  // distinguishes plain misses from format errors
  const Env* e = static_cast<const Env*>(h);
  if (e->root == P_INVALID) return -1;
  uint64_t pgno = e->root;
  for (int depth = 0; depth < 64; ++depth) {
    const PageHeader* p = page(e, pgno);
    if (!p) {
      set_err("page lies beyond the end of the file (truncated LMDB)");
      return -1;
    }
    size_t n = numkeys(p);
    if (p->flags & P_BRANCH) {
      // find the last child whose separator key <= key (node 0 has no key)
      size_t lo = 1, hi = n, pick = 0;
      while (lo < hi) {
        size_t mid = (lo + hi) / 2;
        const NodeHeader* nd = node(e, p, mid);
        if (cmp(node_key(nd), nd->ksize, key, klen) <= 0) {
          pick = mid;
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      pgno = branch_pgno(node(e, p, pick));
    } else if (p->flags & P_LEAF) {
      if (p->flags & P_LEAF2) {
        set_err("LEAF2 (DUPFIXED) pages are not supported");
        return -1;
      }
      size_t lo = 0, hi = n;
      while (lo < hi) {
        size_t mid = (lo + hi) / 2;
        const NodeHeader* nd = node(e, p, mid);
        int c = cmp(node_key(nd), nd->ksize, key, klen);
        if (c == 0) {
          if (nd->flags & (F_SUBDATA | F_DUPDATA)) {
            set_err("DUPSORT sub-databases are not supported");
            return -1;
          }
          uint64_t dsize = leaf_datasize(nd);
          const uint8_t* data = node_key(nd) + nd->ksize;
          if (nd->flags & F_BIGDATA) {
            uint64_t opg;
            memcpy(&opg, data, 8);
            const PageHeader* op = page(e, opg);
            if (!op || !(op->flags & P_OVERFLOW)) {
              set_err("BIGDATA node points at a missing/non-overflow page "
                      "(truncated or corrupt LMDB)");
              return -1;
            }
            // the value spans op->pages contiguous raw pages from the
            // first page's payload: the WHOLE extent must be inside the
            // file, or the zero-copy pointer would read past the mmap
            if (opg * e->psize + PAGEHDRSZ + dsize > e->size ||
                uint64_t(op->pages) * e->psize <
                    PAGEHDRSZ + dsize) {
              set_err("overflow value extends beyond the end of the file "
                      "(truncated LMDB)");
              return -1;
            }
            *val = reinterpret_cast<const uint8_t*>(op) + PAGEHDRSZ;
          } else {
            *val = data;
          }
          return int64_t(dsize);
        }
        if (c < 0) lo = mid + 1; else hi = mid;
      }
      return -1;
    } else {
      set_err("unexpected page type during descent (corrupt LMDB)");
      return -1;
    }
  }
  set_err("B+tree deeper than 64 levels (corrupt LMDB)");
  return -1;
}

}  // extern "C"
