"""LMDB (Lightning Memory-Mapped Database) reader and writer.

Port of `dpm_solver_tpu/utils/lmdb.py`, with one difference: iteration and
`entry_table` always take the native B+tree walker
(`native/lmdb_walk.cpp`, through `utils/lmdb_native.py`), which raises if
it does not build; the pure-Python walk `_walk` is its plain twin.

The reference's LSUN dataset stores images as values in an LMDB B+tree
(``datasets/lsun.py:12-58`` opens the environment read-only and iterates
``txn.cursor()``).  This image has no ``lmdb`` C module, so we read the
on-disk format directly: LMDB files are just an array of fixed-size pages
holding two meta pages and a B+tree of key-sorted nodes, all little-endian
and fully specified by the struct layouts in upstream ``mdb.c``.

Supported: 64-bit LMDB data files (the only variant torchvision/LSUN
ships), read-only access — ``get``, ordered iteration, ``stat()`` — plus a
single-transaction writer that emits a valid LMDB file (meta pages, leaf /
branch levels, overflow pages) so LSUN-style databases can be built from
local image folders and so the reader is testable hermetically.

Not supported (not needed for LSUN): named sub-databases, DUPSORT
duplicates, MDB_INTEGERKEY, 32-bit files, concurrent writers.
"""

from __future__ import annotations

import os
import struct
from typing import Iterable, Iterator, List, Optional, Tuple

# ---------------------------------------------------------------------------
# On-disk constants (mdb.c)
# ---------------------------------------------------------------------------

MAGIC = 0xBEEFC0DE
DATA_VERSION = 1
PAGEHDRSZ = 16
P_INVALID = 0xFFFFFFFFFFFFFFFF

# page flags
P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_LEAF2 = 0x20
P_SUBP = 0x40

# node flags
F_BIGDATA = 0x01
F_SUBDATA = 0x02
F_DUPDATA = 0x04

_META = struct.Struct("<II QQ" + "IHHQQQQQ" * 2 + "QQ")  # from page offset 16


def _db_struct(buf, off):
    """MDB_db: (pad, flags, depth, branch_pages, leaf_pages, overflow_pages,
    entries, root) at byte offset ``off``."""
    return struct.unpack_from("<IHHQQQQQ", buf, off)


class LMDBError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------


class LMDBReader:
    """Read-only cursor over an LMDB data file's main database.

    ``path`` may be the environment directory (containing ``data.mdb``) or
    the data file itself — matching ``lmdb.open(root, readonly=True)`` in
    the reference loader (``datasets/lsun.py:20-27``).
    """

    def __init__(self, path: str):
        import mmap

        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        # mmap, not read(): real LSUN environments are tens of GB; pages are
        # faulted in lazily exactly as the C library does
        self._file = open(path, "rb")
        try:
            self._buf = mmap.mmap(self._file.fileno(), 0,
                                  access=mmap.ACCESS_READ)
        except ValueError as e:
            self._file.close()
            raise LMDBError(f"{path}: cannot map ({e})")
        if len(self._buf) < 2 * PAGEHDRSZ + _META.size:
            raise LMDBError(f"{path}: too small to be an LMDB file")
        self.path = path

        # psize lives in meta.mm_dbs[FREE_DBI].md_pad; read it from meta 0
        # (page 0 always starts at offset 0) to locate meta page 1.
        m0 = self._parse_meta(0)
        psize = m0["psize"]
        if psize < 512 or psize & (psize - 1):
            raise LMDBError(f"{path}: implausible page size {psize}")
        self.psize = psize
        m1 = self._parse_meta(psize)
        meta = m0 if m0["txnid"] >= m1["txnid"] else m1
        self._main = meta["main"]
        if self._main[1] & 0x04:  # MDB_DUPSORT on the main DB
            raise LMDBError(f"{path}: DUPSORT databases are not supported")

    # -- meta ------------------------------------------------------------

    def _parse_meta(self, base: int):
        flags = struct.unpack_from("<H", self._buf, base + 10)[0]
        if not flags & P_META:
            raise LMDBError(f"{self.path}: page at {base} is not a meta page")
        vals = _META.unpack_from(self._buf, base + PAGEHDRSZ)
        magic, version = vals[0], vals[1]
        if magic != MAGIC:
            raise LMDBError(f"{self.path}: bad magic {magic:#x}")
        if version != DATA_VERSION:
            raise LMDBError(f"{self.path}: unsupported format version {version}")
        free_db = vals[4:12]
        main_db = vals[12:20]
        return {
            "psize": free_db[0],
            "main": main_db,
            "last_pg": vals[20],
            "txnid": vals[21],
        }

    # -- public API ------------------------------------------------------

    def close(self) -> None:
        if getattr(self, "_buf", None) is not None:
            self._buf.close()
            self._buf = None
        if getattr(self, "_file", None) is not None:
            self._file.close()
            self._file = None

    def __enter__(self) -> "LMDBReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # best-effort; close() is the real API
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

    def __len__(self) -> int:
        return self._main[6]

    def stat(self) -> dict:
        """Mirror ``txn.stat()`` keys used by callers (``entries`` etc.)."""
        pad, flags, depth, branch, leaf, overflow, entries, root = self._main
        return {
            "psize": self.psize,
            "depth": depth,
            "branch_pages": branch,
            "leaf_pages": leaf,
            "overflow_pages": overflow,
            "entries": entries,
        }

    def keys(self) -> List[bytes]:
        """All keys in order WITHOUT touching value bytes — on a mmap'd
        multi-GB LSUN file this walks only the B+tree pages, like the
        reference's keys-only cursor cache (datasets/lsun.py:31-36)."""
        out: List[bytes] = []

        def walk(pgno: int, depth: int = 0):
            if depth > 64:
                raise LMDBError(f"{self.path}: B+tree too deep (cycle?)")
            base = pgno * self.psize
            flags = struct.unpack_from("<H", self._buf, base + 10)[0]
            if flags & P_LEAF:
                for i in range(self._nkeys(base)):
                    off = self._node_off(base, i)
                    ksize = struct.unpack_from("<H", self._buf, off + 6)[0]
                    out.append(bytes(self._buf[off + 8 : off + 8 + ksize]))
            elif flags & P_BRANCH:
                for i in range(self._nkeys(base)):
                    walk(self._branch_entry(base, i)[1], depth + 1)
            else:
                raise LMDBError(
                    f"{self.path}: unexpected page flags {flags:#x}")

        root = self._main[7]
        if root != P_INVALID:
            walk(root)
        return out

    def values(self) -> Iterator[bytes]:
        for _, v in self.items():
            yield v

    def read(self, offset: int, length: int) -> bytes:
        """Raw mmap slice — pairs with `entry_table()` rows for zero-copy
        random access to keys/values."""
        return self._buf[offset:offset + length]

    def entry_table(self):
        """(n, 4) uint64 rows of (key_off, key_len, val_off, val_len) in key
        order from the native C++ walker (native/lmdb_walk.cpp); raises
        LMDBError on a corrupt file."""
        import numpy as np

        root = self._main[7]
        if root == P_INVALID:
            return np.empty((0, 4), dtype=np.uint64)
        from dpm_solver_tpu_torch.utils import lmdb_native

        try:
            return lmdb_native.entry_table(self._buf, self.psize, root, self._main[6])
        except ValueError as e:
            raise LMDBError(f"{self.path}: {e}")

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        """Iterate all (key, value) pairs in key order (≡ ``txn.cursor()``):
        one C pass computes every record's offsets (`entry_table`), then
        values are served as zero-copy mmap slices."""
        table = self.entry_table()
        buf = self._buf
        # iterate columns without materializing a list-of-lists of boxed
        # ints for LSUN-scale (~millions of records) tables
        ko, kl = table[:, 0], table[:, 0] + table[:, 1]
        vo, vl = table[:, 2], table[:, 2] + table[:, 3]
        for i in range(table.shape[0]):
            yield buf[ko[i]:kl[i]], buf[vo[i]:vl[i]]

    def get(self, key: bytes, default: Optional[bytes] = None) -> Optional[bytes]:
        """Point lookup via B+tree descent (≡ ``txn.get(key)``)."""
        if isinstance(key, str):
            key = key.encode()
        pgno = self._main[7]
        if pgno == P_INVALID:
            return default
        for _ in range(self._main[2]):  # md_depth bounds the descent
            base = pgno * self.psize
            flags = struct.unpack_from("<H", self._buf, base + 10)[0]
            if flags & P_LEAF:
                for i in range(self._nkeys(base)):
                    k, v = self._leaf_node(base, i)
                    if k == key:
                        return v
                    if k > key:
                        break
                return default
            if not flags & P_BRANCH:
                raise LMDBError(f"{self.path}: page {pgno} is neither leaf nor branch")
            pgno = self._descend(base, key)
        raise LMDBError(f"{self.path}: B+tree deeper than md_depth")

    def __contains__(self, key) -> bool:
        return self.get(key) is not None

    def __iter__(self):
        return self.items()

    # -- page plumbing ---------------------------------------------------

    def _nkeys(self, base: int) -> int:
        lower = struct.unpack_from("<H", self._buf, base + 12)[0]
        n = (lower - PAGEHDRSZ) >> 1
        if n < 0 or PAGEHDRSZ + 2 * n > self.psize:
            raise LMDBError(f"{self.path}: corrupt page header at {base}")
        return n

    def _node_off(self, base: int, i: int) -> int:
        ptr = struct.unpack_from("<H", self._buf, base + PAGEHDRSZ + 2 * i)[0]
        return base + ptr

    def _leaf_node(self, base: int, i: int) -> Tuple[bytes, bytes]:
        off = self._node_off(base, i)
        lo, hi, flags, ksize = struct.unpack_from("<HHHH", self._buf, off)
        key = self._buf[off + 8 : off + 8 + ksize]
        dsize = lo | (hi << 16)
        doff = off + 8 + ksize
        if flags & F_BIGDATA:
            (ovpgno,) = struct.unpack_from("<Q", self._buf, doff)
            data = self._overflow(ovpgno, dsize)
        else:
            data = self._buf[doff : doff + dsize]
        if len(data) != dsize:
            raise LMDBError(f"{self.path}: truncated value for key {key!r}")
        return key, data

    def _branch_entry(self, base: int, i: int) -> Tuple[bytes, int]:
        off = self._node_off(base, i)
        lo, hi, flags, ksize = struct.unpack_from("<HHHH", self._buf, off)
        pgno = lo | (hi << 16) | (flags << 32)  # NODEPGNO: 48-bit page number
        return self._buf[off + 8 : off + 8 + ksize], pgno

    def _descend(self, base: int, key: bytes) -> int:
        """Child page for ``key``: largest i with key_i <= key; node 0's key
        is treated as -inf (mdb_page_search_root semantics)."""
        n = self._nkeys(base)
        lo_i, hi_i = 1, n - 1
        best = 0
        while lo_i <= hi_i:
            mid = (lo_i + hi_i) >> 1
            k, _ = self._branch_entry(base, mid)
            if k <= key:
                best = mid
                lo_i = mid + 1
            else:
                hi_i = mid - 1
        return self._branch_entry(base, best)[1]

    def _overflow(self, pgno: int, size: int) -> bytes:
        base = pgno * self.psize
        flags = struct.unpack_from("<H", self._buf, base + 10)[0]
        if not flags & P_OVERFLOW:
            raise LMDBError(f"{self.path}: page {pgno} is not an overflow page")
        start = base + PAGEHDRSZ
        return self._buf[start : start + size]

    def _walk(self, pgno: int, depth: int = 0) -> Iterator[Tuple[bytes, bytes]]:
        if depth > 64:
            raise LMDBError(f"{self.path}: B+tree too deep (cycle?)")
        base = pgno * self.psize
        flags = struct.unpack_from("<H", self._buf, base + 10)[0]
        if flags & P_LEAF:
            for i in range(self._nkeys(base)):
                yield self._leaf_node(base, i)
        elif flags & P_BRANCH:
            for i in range(self._nkeys(base)):
                _, child = self._branch_entry(base, i)
                yield from self._walk(child, depth + 1)
        else:
            raise LMDBError(f"{self.path}: unexpected page flags {flags:#x} at page {pgno}")


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


def write_lmdb(path: str, items: Iterable[Tuple[bytes, bytes]], *,
               psize: int = 4096) -> str:
    """Write ``items`` as a complete, valid LMDB data file (one transaction).

    Keys are sorted bytewise (LMDB's default comparator). Returns the data
    file path. ``path`` may be a directory (a ``data.mdb`` is created
    inside, like ``lmdb.open``) or a file path.
    """
    if os.path.isdir(path) or not os.path.splitext(path)[1]:
        os.makedirs(path, exist_ok=True)
        fname = os.path.join(path, "data.mdb")
    else:
        fname = path

    pairs = sorted(
        [(bytes(k) if not isinstance(k, bytes) else k,
          bytes(v) if not isinstance(v, bytes) else v) for k, v in items]
    )
    for k, _ in pairs:
        if not 0 < len(k) <= 511:  # MDB_MAXKEYSIZE default
            raise LMDBError(f"key length {len(k)} out of range (1..511)")

    pages: List[bytes] = []  # data pages, page number = 2 + index

    def alloc(raw: bytes) -> int:
        pages.append(raw)
        return 1 + len(pages)  # pgno (meta pages are 0 and 1)

    def page_header(pgno, flags, lower, upper) -> bytes:
        return struct.pack("<QHHHH", pgno, 0, flags, lower, upper)

    # Nodes bigger than half the usable page go to overflow pages — the
    # reader only honours F_BIGDATA, but staying under LMDB's own
    # threshold keeps files interoperable with the real library.
    nodemax = (psize - PAGEHDRSZ) // 2
    n_overflow = 0

    def build_level(entries, leaf: bool) -> List[Tuple[bytes, int]]:
        """Pack (key, payload) entries into pages; return (first_key, pgno)
        per page. For leaves payload is the value; for branches, a pgno."""
        nonlocal n_overflow
        out: List[Tuple[bytes, int]] = []
        cur: List[bytes] = []  # serialized nodes
        cur_keys: List[bytes] = []
        used = 0  # node bytes + ptr slots

        def flush():
            nonlocal cur, cur_keys, used
            if not cur:
                return
            n = len(cur)
            lower = PAGEHDRSZ + 2 * n
            # place nodes back-to-front from the page end (as mdb does)
            offs, pos = [], psize
            for node in reversed(cur):
                pos -= len(node)
                offs.append(pos)
            offs.reverse()
            body = bytearray(psize - PAGEHDRSZ)
            for off, node in zip(offs, cur):
                body[off - PAGEHDRSZ : off - PAGEHDRSZ + len(node)] = node
            struct.pack_into("<%dH" % n, body, 0, *offs)
            pgno = len(pages) + 2
            raw = page_header(pgno, P_LEAF if leaf else P_BRANCH, lower, offs[0]) + bytes(body)
            assert len(raw) == psize
            assert alloc(raw) == pgno
            out.append((cur_keys[0], pgno))
            cur, cur_keys, used = [], [], 0

        for key, payload in entries:
            if leaf:
                value = payload
                big = 8 + len(key) + len(value) > nodemax
                if big:
                    # mdb.c OVPAGES: one 16-byte header on the FIRST page
                    # only, value bytes contiguous across the whole run
                    n_ov = (len(value) + PAGEHDRSZ + psize - 1) // psize
                    first_ov = len(pages) + 2
                    hdr = struct.pack("<QHHI", first_ov, 0, P_OVERFLOW, n_ov)
                    blob = (hdr + value).ljust(n_ov * psize, b"\0")
                    for j in range(n_ov):
                        alloc(blob[j * psize : (j + 1) * psize])
                    n_overflow += n_ov
                    node = struct.pack("<HHHH", len(value) & 0xFFFF,
                                       len(value) >> 16, F_BIGDATA, len(key))
                    node += key + struct.pack("<Q", first_ov)
                else:
                    node = struct.pack("<HHHH", len(value) & 0xFFFF,
                                       len(value) >> 16, 0, len(key))
                    node += key + value
            else:
                child = payload
                node = struct.pack("<HHHH", child & 0xFFFF,
                                   (child >> 16) & 0xFFFF,
                                   (child >> 32) & 0xFFFF, len(key))
                node += key
            need = len(node) + 2
            if cur and used + need > psize - PAGEHDRSZ:
                flush()
            cur.append(node)
            cur_keys.append(key)
            used += need
        flush()
        return out

    depth = 0
    n_branch = 0
    if pairs:
        level = build_level(pairs, leaf=True)
        n_leaf = len(level)
        depth = 1
        while len(level) > 1:
            level = build_level(level, leaf=False)
            n_branch += len(level)
            depth += 1
        root = level[0][1]
    else:
        root, n_leaf = P_INVALID, 0

    last_pg = len(pages) + 1
    mapsize = max((last_pg + 1) * psize, 1 << 20)

    def meta_page(pgno: int, txnid: int) -> bytes:
        hdr = page_header(pgno, P_META, 0, 0)
        free_db = struct.pack("<IHHQQQQQ", psize, 0, 0, 0, 0, 0, 0, P_INVALID)
        main_db = struct.pack("<IHHQQQQQ", 0, 0, depth, n_branch, n_leaf,
                              n_overflow, len(pairs), root)
        meta = struct.pack("<IIQQ", MAGIC, DATA_VERSION, 0, mapsize)
        meta += free_db + main_db + struct.pack("<QQ", last_pg, txnid)
        return (hdr + meta).ljust(psize, b"\0")

    with open(fname, "wb") as f:
        f.write(meta_page(0, 0))
        f.write(meta_page(1, 1))
        for raw in pages:
            f.write(raw)
    return fname
