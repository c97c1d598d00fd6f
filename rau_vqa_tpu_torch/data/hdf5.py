"""Reader and writer of the HDF5 subset the ``data_prepro.h5`` bundle uses,
without ``h5py``.

The bundle is a flat group of integer arrays.  ``h5py`` writes such a file,
with its defaults (libver "earliest"), as:

- a version 0 superblock with 8-byte offsets and lengths;
- the root group as a symbol table: a v1 B-tree (``TREE``) over symbol
  table nodes (``SNOD``), the names in a local heap (``HEAP``);
- one version 1 object header a dataset;
- each dataset's elements in one contiguous block (layout class 1), or no
  block at all (the undefined address) when it holds no element.

``read_h5`` reads that subset: little-endian fixed-point datasets of 1, 2,
4 or 8 bytes, signed or unsigned, of any rank; it walks the B-tree to any
depth, skips the header messages it does not need and follows continuation
messages.  It refuses, naming it, anything else: chunked or compact layout,
a filter pipeline, v2 object headers (``OHDR``, libver "latest"),
big-endian, floats, strings, nested groups.  ``write_h5`` writes the same
subset from a ``{name: integer ndarray}`` dict, in the layout ``h5py``
reads (and writes) by default; names sorted into leaves of at most 8
entries (the group leaf K of 4), under as many B-tree levels as they need.
Format: the HDF5 File Format Specification, version 2.0 (sections II-IV).
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF           # the undefined address
LEAF_K = 4                           # symbol table node: up to 2K entries
NODE_K = 16                          # group B-tree node: up to 2K children
HEADER_MIN = 256                     # h5py's object header size (padded by NIL)

# header message types (spec IV.A.2)
MSG_NIL, MSG_DATASPACE, MSG_DATATYPE = 0x0000, 0x0001, 0x0003
MSG_FILL = 0x0005
MSG_LAYOUT, MSG_FILTERS, MSG_CONTINUATION = 0x0008, 0x000B, 0x0010
MSG_SYMBOL_TABLE = 0x0011
_DTYPE_CLASS = {0: "fixed-point", 1: "floating-point", 2: "time",
                3: "string", 4: "bitfield", 5: "opaque", 6: "compound",
                7: "reference", 8: "enumerated", 9: "variable-length",
                10: "array"}
_LAYOUT_CLASS = {0: "compact", 1: "contiguous", 2: "chunked", 3: "virtual"}
_FILTERS = {1: "deflate (gzip)", 2: "shuffle", 3: "fletcher32", 4: "szip",
            5: "nbit", 6: "scaleoffset"}


class UnsupportedHDF5(ValueError):
    """A file, or a dataset of it, outside the subset ``read_h5`` reads."""


def _pad8(n: int) -> int:
    return (n + 7) & ~7


# ---------------------------------------------------------------- reading

class _File:
    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self.buf = f.read()

    def at(self, addr: int, n: int) -> bytes:
        if addr + n > len(self.buf):
            raise UnsupportedHDF5(f"{self.path}: truncated: {n} bytes at {addr} "
                                  f"past the end ({len(self.buf)} bytes)")
        return self.buf[addr:addr + n]

    def u(self, addr: int, n: int) -> int:
        return int.from_bytes(self.at(addr, n), "little")


def _superblock(f: _File) -> int:
    """The root group's object header address."""
    if f.at(0, 8) != SIGNATURE:
        raise UnsupportedHDF5(f"{f.path}: no HDF5 signature at offset 0 (a user "
                              f"block, or not an HDF5 file)")
    version = f.buf[8]
    if version != 0:
        raise UnsupportedHDF5(
            f"{f.path}: superblock version {version}: only version 0 is read "
            f"(h5py's default); files written with libver 'latest' or 'v108'+ "
            f"carry v2 object headers ('OHDR') and link messages")
    size_off, size_len = f.buf[13], f.buf[14]
    if (size_off, size_len) != (8, 8):
        raise UnsupportedHDF5(f"{f.path}: {size_off}-byte offsets and {size_len}-byte "
                              f"lengths: only 8 and 8 are read")
    base = f.u(24, 8)
    if base != 0:
        raise UnsupportedHDF5(f"{f.path}: base address {base}: only 0 is read")
    # the root group's symbol table entry (spec II.A, III.C) at 56
    return f.u(64, 8)


def _messages(f: _File, addr: int) -> List[Tuple[int, int, bytes]]:
    """The (type, flags, data) of each message of the version 1 object
    header at ``addr``, continuation blocks included."""
    if f.at(addr, 4) == b"OHDR":
        raise UnsupportedHDF5(f"{f.path}: a v2 object header ('OHDR') at {addr} "
                              f"(libver 'latest'): only version 1 headers are read")
    version = f.buf[addr]
    if version != 1:
        raise UnsupportedHDF5(f"{f.path}: object header version {version} at {addr}: "
                              f"only version 1 is read")
    n_msgs = f.u(addr + 2, 2)
    chunks = [(addr + 16, f.u(addr + 8, 4))]
    out: List[Tuple[int, int, bytes]] = []
    while chunks and len(out) < n_msgs:
        start, size = chunks.pop(0)
        p, end = start, start + size
        while p + 8 <= end and len(out) < n_msgs:
            mtype, msize, flags = f.u(p, 2), f.u(p + 2, 2), f.buf[p + 4]
            data = f.at(p + 8, msize)
            out.append((mtype, flags, data))
            if mtype == MSG_CONTINUATION:
                chunks.append((int.from_bytes(data[0:8], "little"),
                               int.from_bytes(data[8:16], "little")))
            p += 8 + msize
    return out


def _heap_data(f: _File, addr: int) -> Tuple[int, int]:
    """(data segment address, size) of the local heap at ``addr``."""
    if f.at(addr, 4) != b"HEAP":
        raise UnsupportedHDF5(f"{f.path}: no local heap ('HEAP') at {addr}")
    return f.u(addr + 24, 8), f.u(addr + 8, 8)


def _heap_name(f: _File, heap: Tuple[int, int], offset: int) -> str:
    data, size = heap
    if offset >= size:
        raise UnsupportedHDF5(f"{f.path}: name offset {offset} past the heap's {size}")
    end = f.buf.index(b"\0", data + offset)
    return f.buf[data + offset:end].decode("utf-8")


def _walk_group(f: _File, btree: int, heap: Tuple[int, int]
                ) -> Iterable[Tuple[str, int, int]]:
    """(name, object header address, cache type) of every entry under the
    group B-tree node at ``btree``, in name order, at any depth."""
    if f.at(btree, 4) != b"TREE":
        raise UnsupportedHDF5(f"{f.path}: no B-tree node ('TREE') at {btree}")
    node_type, level, used = f.buf[btree + 4], f.buf[btree + 5], f.u(btree + 6, 2)
    if node_type != 0:
        raise UnsupportedHDF5(f"{f.path}: B-tree node type {node_type} at {btree} "
                              f"where a group node (0) belongs")
    p = btree + 24 + 8                          # past key 0
    for i in range(used):
        child = f.u(p + 16 * i, 8)
        if level > 0:
            yield from _walk_group(f, child, heap)
            continue
        if f.at(child, 4) != b"SNOD":
            raise UnsupportedHDF5(f"{f.path}: no symbol table node ('SNOD') at {child}")
        for j in range(f.u(child + 6, 2)):
            e = child + 8 + 40 * j
            yield (_heap_name(f, heap, f.u(e, 8)), f.u(e + 8, 8), f.u(e + 16, 4))


def _dtype(f: _File, name: str, data: bytes) -> np.dtype:
    cls, version = data[0] & 0x0F, data[0] >> 4
    bits = data[1]
    size = int.from_bytes(data[4:8], "little")
    kind = _DTYPE_CLASS.get(cls, f"class {cls}")
    if cls != 0:
        what = {1: "a float", 3: "a string", 9: "a variable-length type"}.get(cls, kind)
        raise UnsupportedHDF5(f"{f.path}: dataset {name!r} is {what} ({kind} "
                              f"datatype): only integers are read")
    if bits & 1:
        raise UnsupportedHDF5(f"{f.path}: dataset {name!r} is big-endian: only "
                              f"little-endian integers are read")
    offset, precision = (int.from_bytes(data[8:10], "little"),
                         int.from_bytes(data[10:12], "little"))
    if size not in (1, 2, 4, 8) or offset != 0 or precision != 8 * size or version != 1:
        raise UnsupportedHDF5(f"{f.path}: dataset {name!r}: a {size}-byte integer with "
                              f"bit offset {offset}, precision {precision} (datatype "
                              f"version {version}): only whole 1, 2, 4 and 8-byte "
                              f"integers are read")
    return np.dtype(f"<{'i' if bits & 8 else 'u'}{size}")


def _shape(f: _File, name: str, data: bytes) -> Tuple[int, ...]:
    version, rank = data[0], data[1]
    if version == 1:
        dims = data[8:8 + 8 * rank]
    elif version == 2:
        if data[3] == 2:
            raise UnsupportedHDF5(f"{f.path}: dataset {name!r} has a null dataspace")
        dims = data[4:4 + 8 * rank]
    else:
        raise UnsupportedHDF5(f"{f.path}: dataset {name!r}: dataspace version {version}")
    return tuple(int.from_bytes(dims[8 * i:8 * i + 8], "little") for i in range(rank))


def _dataset(f: _File, name: str, addr: int) -> np.ndarray:
    dtype = shape = layout = None
    for mtype, flags, data in _messages(f, addr):
        if flags & 2 and mtype in (MSG_DATATYPE, MSG_DATASPACE, MSG_FILL, MSG_LAYOUT):
            raise UnsupportedHDF5(f"{f.path}: dataset {name!r}: a shared "
                                  f"(committed) message of type {mtype}")
        if mtype == MSG_FILTERS:
            nf = data[1]
            if data[0] == 1:
                fid = int.from_bytes(data[8:10], "little") if nf else 0
            else:
                fid = int.from_bytes(data[2:4], "little") if nf else 0
            raise UnsupportedHDF5(
                f"{f.path}: dataset {name!r} has a filter pipeline "
                f"({_FILTERS.get(fid, f'filter {fid}')}): only unfiltered data is read")
        if mtype == MSG_SYMBOL_TABLE:
            raise UnsupportedHDF5(f"{f.path}: {name!r} is a nested group: only the "
                                  f"root group's datasets are read")
        if mtype == MSG_DATATYPE:
            dtype = data
        elif mtype == MSG_DATASPACE:
            shape = _shape(f, name, data)
        elif mtype == MSG_LAYOUT:
            layout = data
    if dtype is None or shape is None or layout is None:
        raise UnsupportedHDF5(f"{f.path}: {name!r} is not a dataset (no datatype, "
                              f"dataspace or layout message)")
    if layout[0] != 3:
        raise UnsupportedHDF5(f"{f.path}: dataset {name!r}: layout message version "
                              f"{layout[0]}: only version 3 is read")
    if layout[1] != 1:
        raise UnsupportedHDF5(f"{f.path}: dataset {name!r} has "
                              f"{_LAYOUT_CLASS.get(layout[1], 'unknown')} layout "
                              f"(class {layout[1]}): only contiguous layout is read")
    dt = _dtype(f, name, dtype)
    n = int(np.prod(shape, dtype=np.int64))
    start = int.from_bytes(layout[2:10], "little")
    if start == UNDEF:
        # no storage: h5py allocates none for a dataset of no element
        if n:
            raise UnsupportedHDF5(f"{f.path}: dataset {name!r} has {n} elements but no "
                                  f"storage (never written): only written datasets are read")
        return np.zeros(shape, dt)
    size = int.from_bytes(layout[10:18], "little")
    if size != n * dt.itemsize:
        raise UnsupportedHDF5(f"{f.path}: dataset {name!r}: {size} bytes of storage "
                              f"for {n} elements of {dt.itemsize} bytes")
    return np.frombuffer(f.at(start, size), dt).reshape(shape).copy()


def _root(f: _File) -> Tuple[int, Tuple[int, int]]:
    """(root B-tree address, root local heap) from the root group's header."""
    for mtype, _, data in _messages(f, _superblock(f)):
        if mtype == MSG_SYMBOL_TABLE:
            return (int.from_bytes(data[0:8], "little"),
                    _heap_data(f, int.from_bytes(data[8:16], "little")))
    raise UnsupportedHDF5(f"{f.path}: the root group has no symbol table message "
                          f"(a new-style group: libver 'latest')")


def h5_names(path: str) -> List[str]:
    """The names of the root group's entries, in name order."""
    f = _File(path)
    btree, heap = _root(f)
    return [name for name, _, _ in _walk_group(f, btree, heap)]


def read_h5(path: str, names: Optional[Iterable[str]] = None) -> Dict[str, np.ndarray]:
    """The root group's datasets (or those of ``names``; a missing one
    raises ``KeyError``) as arrays in their stored type (native order)."""
    f = _File(path)
    btree, heap = _root(f)
    entries = {name: (addr, cache) for name, addr, cache in _walk_group(f, btree, heap)}
    want = list(entries) if names is None else list(names)
    out = {}
    for name in want:
        if name not in entries:
            raise KeyError(f"{path}: no dataset {name!r} (has {sorted(entries)})")
        addr, cache = entries[name]
        if cache == 1:
            raise UnsupportedHDF5(f"{path}: {name!r} is a nested group: only the "
                                  f"root group's datasets are read")
        out[name] = _dataset(f, name, addr)
    return out


# ---------------------------------------------------------------- writing

def _message(mtype: int, data: bytes, flags: int = 0) -> bytes:
    data = data + b"\0" * (_pad8(len(data)) - len(data))
    return struct.pack("<HHB3x", mtype, len(data), flags) + data


def _object_header(messages: List[bytes], min_size: int = 0) -> bytes:
    body = b"".join(messages)
    n = len(messages)
    if len(body) < min_size:
        # the rest of the block as one NIL message, as the library pads
        body += _message(MSG_NIL, b"\0" * (min_size - len(body) - 8))
        n += 1
    return struct.pack("<BBHII4x", 1, 0, n, 1, len(body)) + body


def _dataset_header(arr: np.ndarray, addr: int) -> bytes:
    rank = arr.ndim
    dims = b"".join(struct.pack("<Q", d) for d in arr.shape)
    space = struct.pack("<BBBB4x", 1, rank, 1, 0) + dims + dims     # max dims = dims
    bits = 0x08 if arr.dtype.kind == "i" else 0x00
    dtype = struct.pack("<BBBBIHH", 0x10, bits, 0, 0, arr.dtype.itemsize,
                        0, 8 * arr.dtype.itemsize)
    fill = struct.pack("<BBBBI", 2, 2, 2, 1, 0)          # late, if set, default
    layout = struct.pack("<BBQQ", 3, 1, addr, arr.nbytes)
    return _object_header([_message(MSG_DATASPACE, space),
                           _message(MSG_DATATYPE, dtype, flags=1),
                           _message(MSG_FILL, fill, flags=1),
                           _message(MSG_LAYOUT, layout)], HEADER_MIN)


def _entry(name_off: int, ohdr: int, cache: int = 0, scratch: bytes = b"") -> bytes:
    return struct.pack("<QQI4x", name_off, ohdr, cache) + scratch.ljust(16, b"\0")


def _checked(arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    out = {}
    for name, a in arrays.items():
        if not name or "/" in name or "\0" in name or name in (".",):
            raise ValueError(f"dataset name {name!r}: a plain name is needed")
        a = np.asarray(a)
        if a.dtype.kind not in "iu" or a.dtype.itemsize not in (1, 2, 4, 8):
            raise ValueError(f"dataset {name!r}: {a.dtype} — only 1, 2, 4 and 8-byte "
                             f"integers are written")
        if a.ndim == 0:
            raise ValueError(f"dataset {name!r}: a scalar; arrays of rank >= 1 are written")
        out[name] = np.ascontiguousarray(a, a.dtype.newbyteorder("<"))
    return out


def write_h5(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """Write ``arrays`` (integer ndarrays, rank >= 1) as the root group's
    datasets, in the subset ``read_h5`` reads; the file goes to ``path``
    through a temporary name."""
    arrays = _checked(arrays)
    names = sorted(arrays, key=lambda s: s.encode("utf-8"))   # strcmp order

    # the local heap: "" at 0 (B-tree key 0), then each name, 8-aligned
    heap = bytearray(8)
    name_off = {}
    for name in names:
        name_off[name] = len(heap)
        raw = name.encode("utf-8") + b"\0"
        heap += raw + b"\0" * (_pad8(len(raw)) - len(raw))

    # leaves of up to 2K entries; B-tree levels of up to 2K children each
    leaves = [names[i:i + 2 * LEAF_K] for i in range(0, len(names), 2 * LEAF_K)]
    levels: List[List[List[int]]] = [[list(range(i, min(i + 2 * NODE_K, len(leaves))))
                                      for i in range(0, len(leaves), 2 * NODE_K)] or [[]]]
    while len(levels[-1]) > 1:
        below = len(levels[-1])
        levels.append([list(range(i, min(i + 2 * NODE_K, below)))
                       for i in range(0, below, 2 * NODE_K)])

    # addresses: superblock, root header, B-tree nodes (top level first),
    # heap header and data, leaves, dataset headers, then the data
    node_size = 24 + (2 * NODE_K) * 8 + (2 * NODE_K + 1) * 8
    leaf_size = 8 + 2 * LEAF_K * 40
    root_hdr_size = 16 + 8 + 16
    p = 96
    root_hdr = p
    p += root_hdr_size
    node_addr: List[List[int]] = [[] for _ in levels]
    for lv in reversed(range(len(levels))):
        for _ in levels[lv]:
            node_addr[lv].append(p)
            p += node_size
    heap_hdr = p
    p += 32
    heap_data = p
    p += len(heap)
    leaf_addr = []
    for _ in leaves:
        leaf_addr.append(p)
        p += leaf_size
    ds_hdr = {}
    for name in names:
        ds_hdr[name] = p
        p += len(_dataset_header(arrays[name], 0))
    data_addr = {}
    for name in names:
        if arrays[name].size:
            p = _pad8(p)
            data_addr[name] = p
            p += arrays[name].nbytes
        else:
            data_addr[name] = UNDEF
    eof = p

    out = bytearray(eof)

    def put(addr: int, b: bytes) -> None:
        out[addr:addr + len(b)] = b

    root_scratch = struct.pack("<QQ", node_addr[-1][0], heap_hdr)
    put(0, SIGNATURE + struct.pack("<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0,
                                   LEAF_K, NODE_K, 0)
        + struct.pack("<QQQQ", 0, UNDEF, eof, UNDEF)
        + _entry(0, root_hdr, 1, root_scratch))
    put(root_hdr, _object_header([_message(MSG_SYMBOL_TABLE, root_scratch)]))

    def last_name(lv: int, i: int) -> str:
        """The greatest name under node ``i`` of level ``lv`` (-1: a leaf)."""
        while lv >= 0:
            i = levels[lv][i][-1]
            lv -= 1
        return leaves[i][-1] if leaves[i] else ""

    for lv, nodes in enumerate(levels):
        for i, children in enumerate(nodes):
            left = node_addr[lv][i - 1] if i > 0 else UNDEF
            right = node_addr[lv][i + 1] if i + 1 < len(nodes) else UNDEF
            b = bytearray(b"TREE" + struct.pack("<BBHQQ", 0, lv, len(children), left, right))
            b += struct.pack("<Q", 0)
            for c in children:
                child = leaf_addr[c] if lv == 0 else node_addr[lv - 1][c]
                b += struct.pack("<QQ", child, name_off.get(last_name(lv - 1, c), 0))
            put(node_addr[lv][i], bytes(b))
    put(heap_hdr, b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap), 1, heap_data))
    put(heap_data, bytes(heap))
    for addr, leaf in zip(leaf_addr, leaves):
        put(addr, b"SNOD" + struct.pack("<BBH", 1, 0, len(leaf))
            + b"".join(_entry(name_off[n], ds_hdr[n]) for n in leaf))
    for name in names:
        put(ds_hdr[name], _dataset_header(arrays[name], data_addr[name]))
        if arrays[name].size:
            put(data_addr[name], arrays[name].tobytes())

    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as fh:
        fh.write(out)
    os.replace(tmp, path)
