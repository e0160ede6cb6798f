"""A read-only OCDBT key-value store: the store under an orbax step.

The JAX package's orbax checkpoints keep their arrays in tensorstore's
OCDBT ("optionally cooperative distributed B+tree") format.  This module
reads it without tensorstore, over the port's native zstd decoder and
CRC-32C (``nativelib.py``, ``native/nns_zstd.cc``).

Layout read (format version 0):

- ``manifest.ocdbt``: magic ``0x0cdb3a2a``; the file's length (u64 LE);
  the format version and the compression (varints; 0 raw, 1 zstd); the
  body; a CRC-32C of everything before it.  The body holds the config
  (uuid, manifest kind, inline value and node size limits, the version
  tree's arity, the compression method), then, for manifest kind 0
  ("single"), the newest versions of the version tree: a data-file
  table, then per version its generation, root height, root node
  reference (data file, offset, length), its statistics and commit
  time, then references to older version nodes (not read: only the
  newest version is, which is what a restore gives).
- manifest kind 1 ("numbered"): ``manifest.ocdbt`` holds the config
  alone, and each commit writes ``manifest.<generation as 16 hex
  digits>``, framed and checked as above, holding the same config (the
  same uuid, kind 0) and the version tree.  The highest-numbered one is
  read.
- b-tree nodes (magic ``0x0cdb20de``, the same framing): the height, a
  data-file table, the entries' keys as shared-prefix lengths, suffix
  lengths and suffix bytes, then for an interior node each child's
  common-prefix length, reference and statistics, for a leaf each
  value's length and kind (inline bytes in the node, or a range of a
  data file).
- data-file tables: paths given as (shared prefix with the previous
  path, suffix, base-path length); a file lives at base path + relative
  path under the store's root, so a root manifest reaches files under
  ``ocdbt.process_N/d/`` that a process wrote.

Every node's length and CRC-32C are checked before it is decoded, its
decoded size is bounded by the config's ``max_decoded_node_bytes``, and
every varint, table, offset and path is bounds-checked: a damaged store
raises :class:`OcdbtError` (a ``ValueError``).

Refused: format versions above 0 (tensorstore writes version 0; orbax
and this port write nothing else, so a later version is a format this
reader has never been held against), compression methods other than
none and zstd, and value kinds other than inline and indirect.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Tuple, Union

from ..nativelib import crc32c, zstd_decompress

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
MANIFEST = "manifest.ocdbt"
NUMBERED = "manifest."             # + 16 hex digits: a numbered manifest

#: a value: inline bytes, or (data file, offset, length)
Value = Union[bytes, Tuple[str, int, int]]


class OcdbtError(ValueError):
    """The store is damaged or in a form this reader does not read."""


class _Cursor:
    """Bounds-checked reads over one decoded body."""

    def __init__(self, data: bytes, what: str):
        self.data = data
        self.i = 0
        self.what = what

    def fail(self, why: str):
        raise OcdbtError(f"{self.what}: {why}")

    def take(self, n: int) -> bytes:
        if n < 0 or self.i + n > len(self.data):
            self.fail("truncated")
        out = self.data[self.i:self.i + n]
        self.i += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        v = shift = 0
        while True:
            if self.i >= len(self.data):
                self.fail("truncated varint")
            c = self.data[self.i]
            self.i += 1
            v |= (c & 0x7F) << shift
            if not c & 0x80:
                return v
            shift += 7
            if shift > 63:
                self.fail("varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def count(self, limit: int = 1 << 24) -> int:
        n = self.varint()
        if n > limit or n > len(self.data) - self.i + 1:
            self.fail(f"count {n} exceeds the data")
        return n

    def done(self) -> None:
        if self.i != len(self.data):
            self.fail(f"{len(self.data) - self.i} trailing bytes")


def _unwrap(raw: bytes, magic: int, what: str, limit: int) -> bytes:
    """The body of one framed OCDBT file or node: magic, length, version,
    compression and CRC-32C checked, zstd bodies decoded."""
    if len(raw) < 12 + 2 + 4:
        raise OcdbtError(f"{what}: {len(raw)} bytes, too short")
    got_magic, length = struct.unpack(">I", raw[:4])[0], \
        struct.unpack("<Q", raw[4:12])[0]
    if got_magic != magic:
        raise OcdbtError(f"{what}: magic {got_magic:#010x}, expected "
                         f"{magic:#010x}")
    if length != len(raw):
        raise OcdbtError(f"{what}: length field {length}, {len(raw)} bytes "
                         "read")
    (want_crc,) = struct.unpack("<I", raw[-4:])
    if crc32c(raw[:-4]) != want_crc:
        raise OcdbtError(f"{what}: CRC-32C mismatch")
    head = _Cursor(raw[12:-4], what)
    version = head.varint()
    if version != 0:
        raise OcdbtError(f"{what}: format version {version} is not read")
    compression = head.varint()
    body = raw[12 + head.i:-4]
    if compression == 0:
        return body
    if compression == 1:
        try:
            return zstd_decompress(body, limit=limit).tobytes()
        except ValueError as e:
            raise OcdbtError(f"{what}: {e}") from None
    raise OcdbtError(f"{what}: compression {compression} is not read")


def _file_table(c: _Cursor) -> List[str]:
    """A data-file table: each path relative to the store's root."""
    n = c.count()
    prefix = [0] + c.varints(n - 1) if n else []
    suffix = c.varints(n)
    base = c.varints(n)
    paths: List[str] = []
    prev = b""
    for k in range(n):
        if prefix[k] > len(prev):
            c.fail("data-file path prefix longer than the previous path")
        path = prev[:prefix[k]] + c.take(suffix[k])
        if base[k] > len(path):
            c.fail("data-file base path longer than the path")
        paths.append(path.decode("utf-8", errors="strict"))
        prev = path
    return paths


def _keys(c: _Cursor, n: int) -> Tuple[List[int], List[int]]:
    """The shared-prefix and suffix lengths of ``n`` keys."""
    prefix = [0] + c.varints(n - 1) if n else []
    suffix = c.varints(n)
    return prefix, suffix


def _key_bytes(c: _Cursor, prefix: List[int], suffix: List[int]
               ) -> List[bytes]:
    keys: List[bytes] = []
    prev = b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            c.fail("key prefix longer than the previous key")
        prev = prev[:p] + c.take(s)
        keys.append(prev)
    return keys


class Ocdbt:
    """The newest version of the OCDBT store under ``root``:
    :meth:`list` its keys, :meth:`read` a value."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self._fds: Dict[str, int] = {}
        self.values: Dict[bytes, Value] = {}
        self._files: Dict[str, str] = {}
        self.generation = 0
        path = os.path.join(self.root, MANIFEST)
        c = self._manifest(path)
        uuid, kind = self._config(c)
        if kind == 1:                    # numbered: the config alone here
            c.done()
            path = self._numbered()
            if path is None:                        # nothing written yet
                return
            c = self._manifest(path)
            if self._config(c) != (uuid, 0):
                raise OcdbtError(f"{path}: not a version manifest of the "
                                 f"store {MANIFEST} describes")
        elif kind != 0:
            raise OcdbtError(f"{path}: manifest kind {kind} is not read")
        files = _file_table(c)
        n = c.count()
        gens = c.varints(n)
        heights = list(c.take(n))
        fids, offs, lens = c.varints(n), c.varints(n), c.varints(n)
        c.varints(3 * n)                            # statistics
        c.take(8 * n)                               # commit times
        m = c.count()                               # older version nodes
        c.varints(4 * m + m)                        # gen, file, off, len, n
        c.take(8 * m)                               # commit times
        c.take(m)                                   # heights
        c.done()
        if n == 0:
            return
        k = max(range(n), key=gens.__getitem__)
        self.generation = gens[k]
        try:
            if lens[k]:
                self._node(files, fids[k], offs[k], lens[k], heights[k],
                           b"")
        except BaseException:
            self.close()
            raise

    @staticmethod
    def _manifest(path: str) -> _Cursor:
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError as e:
            raise OcdbtError(f"{path}: {e}") from None
        return _Cursor(_unwrap(raw, MANIFEST_MAGIC, path, limit=1 << 30),
                       path)

    def _config(self, c: _Cursor) -> Tuple[bytes, int]:
        """(the store's uuid, the manifest kind) of a manifest's config;
        keeps its node size limit."""
        uuid = c.take(16)
        kind = c.varint()
        c.varint()                                  # max_inline_value_bytes
        self.max_node = c.varint()                  # max_decoded_node_bytes
        c.byte()                                    # version_tree_arity_log2
        method = c.varint()
        if method == 1:
            c.take(4)                               # zstd level (int32 LE)
        elif method != 0:
            c.fail(f"compression method {method} is not read")
        return uuid, kind

    def _numbered(self) -> Optional[str]:
        """The path of the newest numbered manifest, or None."""
        try:
            names = os.listdir(self.root)
        except OSError as e:
            raise OcdbtError(f"{self.root}: {e}") from None
        gens = [int(n[len(NUMBERED):], 16) for n in names
                if n.startswith(NUMBERED) and len(n) == len(NUMBERED) + 16
                and all(ch in "0123456789abcdef" for ch in n[-16:])]
        if not gens:
            return None
        return os.path.join(self.root, f"{NUMBERED}{max(gens):016x}")

    def close(self, _close=os.close) -> None:
        """Close the data files :meth:`read` keeps open (``os.close`` held
        here: a store collected at interpreter exit outlives ``os``)."""
        fds, self._fds = self._fds, {}
        for fd in fds.values():
            _close(fd)

    def __del__(self) -> None:
        self.close()

    # -- files ------------------------------------------------------------------

    def _path(self, rel: str) -> str:
        """A data file's path, which must stay under the root."""
        full = self._files.get(rel)
        if full is None:
            full = os.path.normpath(os.path.join(self.root, rel))
            if os.path.commonpath([full, self.root]) != self.root:
                raise OcdbtError(f"data file {rel!r} lies outside "
                                 f"{self.root}")
            self._files[rel] = full
        return full

    def _range(self, rel: str, offset: int, length: int) -> bytes:
        path = self._path(rel)
        try:
            fd = self._fds.get(path)
            if fd is None:
                fd = self._fds[path] = os.open(path, os.O_RDONLY)
            data = os.pread(fd, length, offset)
        except OSError as e:
            raise OcdbtError(f"{path}: {e}") from None
        if len(data) != length:
            raise OcdbtError(f"{path}: [{offset}, {offset + length}) runs "
                             "past the end of the file")
        return data

    # -- the b-tree -------------------------------------------------------------

    def _node(self, files: List[str], fid: int, offset: int, length: int,
              height: int, prefix: bytes) -> None:
        if fid >= len(files):
            raise OcdbtError(f"node reference to data file {fid} of "
                             f"{len(files)}")
        what = f"{files[fid]}@{offset}"
        body = _unwrap(self._range(files[fid], offset, length), BTREE_MAGIC,
                       what, self.max_node)
        c = _Cursor(body, what)
        if c.byte() != height:
            c.fail(f"height is not the {height} its parent gives")
        table = _file_table(c)
        n = c.count()
        kp, ks = _keys(c, n)
        if height > 0:
            common = c.varints(n)
            keys = _key_bytes(c, kp, ks)
            cf, co, cl = c.varints(n), c.varints(n), c.varints(n)
            c.varints(3 * n)                        # statistics
            c.done()
            for k in range(n):
                if common[k] > len(keys[k]):
                    c.fail("subtree prefix longer than its key")
                self._node(table, cf[k], co[k], cl[k], height - 1,
                           prefix + keys[k][:common[k]])
            return
        keys = _key_bytes(c, kp, ks)
        vlen = c.varints(n)
        kinds = c.varints(n)
        if any(k > 1 for k in kinds):
            c.fail("value kind other than inline (0) or indirect (1)")
        nind = sum(kinds)
        vf, vo = c.varints(nind), c.varints(nind)
        j = 0
        for k in range(n):
            if kinds[k]:
                if vf[j] >= len(table):
                    c.fail(f"value in data file {vf[j]} of {len(table)}")
                self.values[prefix + keys[k]] = (table[vf[j]], vo[j],
                                                 vlen[k])
                j += 1
            else:
                self.values[prefix + keys[k]] = c.take(vlen[k])
        c.done()

    # -- the store --------------------------------------------------------------

    def list(self) -> List[str]:
        """Every key, sorted."""
        return sorted(k.decode("utf-8", errors="replace")
                      for k in self.values)

    def read(self, key: str) -> Optional[bytes]:
        """The value of ``key``, or None where the store has no such key."""
        v = self.values.get(key.encode("utf-8"))
        if v is None or isinstance(v, bytes):
            return v
        return self._range(*v)
