"""A read-only OCDBT key-value store: the layout tensorstore writes under an
Orbax checkpoint of the JAX package (``<checkpoint>/state/``).

An OCDBT directory holds a ``manifest.ocdbt`` and b-tree node and data
files under ``d/`` (or under another directory the node files name, such
as ``ocdbt.process_<n>/d/``). Every manifest and node begins with a
4-byte big-endian magic (``0x0cdb3a2a`` manifest, ``0x0cdb20de`` node),
the file's length as a little-endian u64, a varint format version (0)
and a varint compression (0 none, 1 zstd), and ends with a little-endian
CRC32C of everything before it; the body between is zstd-compressed when
the header says so. All integers in a body are LEB128 varints unless
said otherwise, and every per-entry field is stored as a column.

- The manifest body: the config (16-byte uuid, manifest kind, maximum
  inline value bytes, maximum decoded node bytes, version-tree arity log2
  as one byte, compression with a little-endian i32 zstd level), then the
  versions inline: a data-file table, their count, and columns of
  generation, root height (a byte), root location (data file, offset,
  length), root statistics (keys, tree bytes, indirect value bytes) and
  commit time (u64). The latest generation's root is the store.
- A data-file table: the count of files, then columns of path prefix
  length (shared with the previous path; from the second file on), path
  suffix length and base path length, then the suffixes. A path is read
  relative to the base path of the file that holds the table (empty for
  the manifest), so a node under ``ocdbt.process_0/`` names its
  neighbours as ``d/...``.
- A node body: its height (a byte), its data-file table and its entry
  count; then the keys (prefix length from the second entry on, suffix
  length, and for an interior node the length of the prefix common to
  the child's subtree, then the suffixes). An interior node follows with
  each child's location and statistics; a leaf with each value's length
  and kind (0 inline, 1 in a data file), the data file and offset of the
  values stored out of line, and the inline values' bytes. A child's
  keys leave out its subtree's common prefix.

The format is tensorstore's (its ``kvstore/ocdbt`` documentation);
``tests/test_torch_orbax_read.py`` holds this reader against the
directories tensorstore writes. A check that fails (magic, length,
version, compression, CRC32C, a node's height, trailing or missing bytes)
raises ``ValueError`` naming the file; nothing is returned from a file
that fails one.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict, List, Tuple

from midi_vae_tpu_torch.native import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_HEADER_FIXED = 12  # magic + length
_NO_ROOT = (1 << 64) - 1
_MAX_HEIGHT = 64


class _Cursor:
    """Reads a body front to back; running past its end raises."""

    def __init__(self, data: bytes, what: str):
        self.data, self.at, self.what = data, 0, what

    def fail(self, why: str):
        raise ValueError(f"{self.what}: {why}")

    def byte(self) -> int:
        if self.at >= len(self.data):
            self.fail("truncated body")
        self.at += 1
        return self.data[self.at - 1]

    def varint(self) -> int:
        value = shift = 0
        while True:
            b = self.byte()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                self.fail("varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if n < 0 or self.at + n > len(self.data):
            self.fail("truncated body")
        self.at += n
        return self.data[self.at - n:self.at]


def _unframe(blob: bytes, magic: int, what: str) -> bytes:
    """The body of one manifest or node, after checking its framing."""
    if len(blob) < _HEADER_FIXED + 2 + 4:
        raise ValueError(f"{what}: {len(blob)} bytes, too short for an OCDBT file")
    (found,) = struct.unpack(">I", blob[:4])
    if found != magic:
        raise ValueError(f"{what}: magic {found:#010x}, expected {magic:#010x}")
    (length,) = struct.unpack("<Q", blob[4:12])
    if length != len(blob):
        raise ValueError(f"{what}: header says {length} bytes, the file holds {len(blob)}")
    (crc,) = struct.unpack("<I", blob[-4:])
    if zstd.crc32c(blob[:-4]) != crc:
        raise ValueError(f"{what}: CRC32C mismatch (corrupt file)")
    head = _Cursor(blob[:-4], what)
    head.at = _HEADER_FIXED
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise ValueError(f"{what}: format version {version}, this reader knows 0")
    body = blob[head.at:-4]
    if compression == 1:
        return zstd.decompress(body)
    if compression != 0:
        raise ValueError(f"{what}: unknown compression {compression}")
    return body


@dataclass(frozen=True)
class _DataFile:
    base: str  # the base path, relative to the store's directory
    path: str  # base + relative path


def _data_file_table(c: _Cursor, transitive: str) -> List[_DataFile]:
    n = c.varint()
    prefix = [0] + c.varints(n - 1) if n else []
    suffix = c.varints(n)
    base = c.varints(n)
    files, previous = [], b""
    for i in range(n):
        if prefix[i] > len(previous):
            c.fail("data-file path prefix longer than the previous path")
        full = previous[:prefix[i]] + c.take(suffix[i])
        if base[i] > len(full):
            c.fail("data-file base path longer than its path")
        previous = full
        name = full.decode()
        files.append(_DataFile(base=transitive + name[:base[i]], path=transitive + name))
    return files


@dataclass(frozen=True)
class _Ref:
    """A location in a data file: the file, an offset and a length."""

    file: _DataFile
    offset: int
    length: int


@dataclass(frozen=True)
class Manifest:
    """The latest version of a store: its generation and its tree's root."""

    generation: int
    root_height: int
    root: "_Ref | None"  # None: the store is empty
    num_keys: int


def _pick(files: List[_DataFile], index: int, c: _Cursor) -> _DataFile:
    if index >= len(files):
        c.fail(f"data file {index} of a table of {len(files)}")
    return files[index]


def parse_manifest(blob: bytes, what: str = "manifest.ocdbt") -> Manifest:
    """The latest version's root of a manifest file."""
    c = _Cursor(_unframe(blob, MANIFEST_MAGIC, what), what)
    c.take(16)  # uuid
    kind = c.varint()
    c.varint(), c.varint()  # maximum inline value bytes, maximum decoded node bytes
    c.byte()  # version-tree arity log2
    compression = c.varint()
    if compression == 1:
        c.take(4)  # zstd level, a little-endian i32
    elif compression != 0:
        c.fail(f"unknown node compression {compression}")
    if kind != 0:
        c.fail(f"manifest kind {kind}: only single-file manifests are read")
    files = _data_file_table(c, "")
    n = c.varint()
    if n == 0:
        c.fail("no versions")
    generation = c.varints(n)
    height = [c.byte() for _ in range(n)]
    file_id, offset, length = c.varints(n), c.varints(n), c.varints(n)
    num_keys = c.varints(n)
    c.varints(n), c.varints(n)  # tree bytes, indirect value bytes
    c.take(8 * n)  # commit times
    c.varint()  # references to older versions' nodes: not needed for the latest
    latest = max(range(n), key=generation.__getitem__)
    root = None
    if not (offset[latest] == _NO_ROOT and length[latest] == _NO_ROOT):
        root = _Ref(_pick(files, file_id[latest], c), offset[latest], length[latest])
    return Manifest(generation[latest], height[latest], root, num_keys[latest])


def _keys(c: _Cursor, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    prefix = [0] + c.varints(n - 1) if n else []
    suffix = c.varints(n)
    common = c.varints(n) if interior else [0] * n
    keys, previous = [], b""
    for i in range(n):
        if prefix[i] > len(previous):
            c.fail("key prefix longer than the previous key")
        key = previous[:prefix[i]] + c.take(suffix[i])
        if common[i] > len(key):
            c.fail("subtree prefix longer than its key")
        keys.append(key)
        previous = key
    return keys, common


class OcdbtStore:
    """The latest version of the OCDBT store under ``directory``:
    :meth:`list` its keys, :meth:`read` a value."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        path = os.path.join(self.directory, "manifest.ocdbt")
        with open(path, "rb") as f:
            self.manifest = parse_manifest(f.read(), path)
        self._values: Dict[bytes, "bytes | _Ref"] = {}
        if self.manifest.root is not None:
            self._walk(self.manifest.root, self.manifest.root_height, b"")
        if len(self._values) != self.manifest.num_keys:
            raise ValueError(f"{path}: the manifest counts {self.manifest.num_keys} keys, the tree holds "
                             f"{len(self._values)}")

    def _region(self, ref: _Ref) -> bytes:
        path = os.path.join(self.directory, ref.file.path)
        with open(path, "rb") as f:
            f.seek(ref.offset)
            blob = f.read(ref.length)
        if len(blob) != ref.length:
            raise ValueError(f"{path}: {ref.length} bytes at {ref.offset} run past the file's end")
        return blob

    def _walk(self, ref: _Ref, height: int, prefix: bytes) -> None:
        what = f"{os.path.join(self.directory, ref.file.path)}@{ref.offset}"
        c = _Cursor(_unframe(self._region(ref), NODE_MAGIC, what), what)
        found = c.byte()
        if found != height or height > _MAX_HEIGHT:
            c.fail(f"node of height {found} where {height} was expected")
        files = _data_file_table(c, ref.file.base)
        n = c.varint()
        keys, common = _keys(c, n, interior=height > 0)
        if height > 0:
            file_id, offset, length = c.varints(n), c.varints(n), c.varints(n)
            c.varints(n), c.varints(n), c.varints(n)  # statistics
            children = [_Ref(_pick(files, file_id[i], c), offset[i], length[i]) for i in range(n)]
            if c.at != len(c.data):
                c.fail("bytes after the node's last column")
            for key, shared, child in zip(keys, common, children):
                self._walk(child, height - 1, prefix + key[:shared])
            return
        length = c.varints(n)
        kind = [c.byte() for _ in range(n)]
        if any(k > 1 for k in kind):
            c.fail("unknown value kind")
        out_of_line = [i for i in range(n) if kind[i] == 1]
        file_id, offset = c.varints(len(out_of_line)), c.varints(len(out_of_line))
        for i, fid, off in zip(out_of_line, file_id, offset):
            self._values[prefix + keys[i]] = _Ref(_pick(files, fid, c), off, length[i])
        for i in range(n):
            if kind[i] == 0:
                self._values[prefix + keys[i]] = c.take(length[i])
        if c.at != len(c.data):
            c.fail("bytes after the node's inline values")

    def list(self) -> List[str]:
        """Every key, sorted."""
        return sorted(k.decode() for k in self._values)

    def __contains__(self, key: str) -> bool:
        return key.encode() in self._values

    def read(self, key: str) -> bytes:
        """The value stored under ``key``; ``KeyError`` when there is none."""
        value = self._values[key.encode()]
        return value if isinstance(value, bytes) else self._region(value)
