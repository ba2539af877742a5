"""A read-only HDF5 reader in numpy and zlib, for the event streams of raw
EDS sequences (`events.h5`), without h5py (the GPU machine has none).

    with hdf5.File(path) as f:
        x = f["x"]                  # a dataset reads as a numpy array
        sub = f["group"]["name"]    # or f["group/name"]
        names = f.keys()

What it reads:
  - superblocks version 0 to 3, object headers version 1 and 2;
  - groups as symbol tables (v1 B-tree, symbol nodes, local heap) and as
    link messages (hard links, compact storage);
  - contiguous, compact and chunked layouts (data layout messages version
    3 and 4); chunks indexed by a v1 B-tree, by the single-chunk index or
    by a fixed array (paged or not), as `libver="latest"` writes them;
  - the deflate (gzip), shuffle and lzf filters, honouring each chunk's
    filter mask;
  - little- and big-endian integers of 1, 2, 4 and 8 bytes, IEEE floats
    of 2, 4 and 8 bytes, and booleans (h5py's enum FALSE = 0, TRUE = 1 over
    int8), in a simple or scalar dataspace.

Anything else raises ValueError naming it: another filter (fletcher32,
szip, nbit, scaleoffset, ...), an implicit, extensible-array or v2-B-tree
chunk index, dense link storage (a fractal heap), soft or external links,
a shared or committed datatype, another datatype class (strings,
compounds, other enums, ...), a virtual layout, or storage that was never
allocated (a missing chunk, a contiguous dataset never written): nothing
is filled in silently. Checksums are not verified.

This feature set follows what h5py writes (each part is held to h5py in
tests/test_torch_eds_to_esim.py), not a real EDS recording: none is in
the repository, so which of these features a real `events.h5` uses, and
its sizes and filters, are unverified. The lzf decoder is pure Python (one
loop iteration a token), far slower than deflate's zlib: a long
lzf-compressed recording takes minutes to read.
"""

import mmap
import zlib

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"

# object header message types
_MSG_DATASPACE, _MSG_LINK_INFO, _MSG_DATATYPE = 0x01, 0x02, 0x03
_MSG_LINK, _MSG_LAYOUT, _MSG_FILTERS = 0x06, 0x08, 0x0B
_MSG_CONTINUATION, _MSG_SYMBOL_TABLE = 0x10, 0x11

_FILTER_DEFLATE, _FILTER_SHUFFLE, _FILTER_LZF = 1, 2, 32000
_FILTER_NAMES = {3: "fletcher32", 4: "szip", 5: "nbit", 6: "scaleoffset"}
_INDEX_NAMES = {2: "implicit", 4: "extensible array", 5: "v2 B-tree"}

# IEEE layouts by size: (precision, exponent location, exponent size,
# mantissa location, mantissa size, exponent bias)
_IEEE = {2: (16, 10, 5, 0, 10, 15), 4: (32, 23, 8, 0, 23, 127),
         8: (64, 52, 11, 0, 52, 1023)}


def _uint(buf, offset, size):
    return int.from_bytes(buf[offset:offset + size], "little")


def lzf_decompress(data):
    """LZF (liblzf's format, as h5py's lzf filter writes each chunk)."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        ctrl = data[i]
        i += 1
        if ctrl < 32:  # a literal run of ctrl + 1 bytes
            out += data[i:i + ctrl + 1]
            i += ctrl + 1
            continue
        length = ctrl >> 5
        if length == 7:
            length += data[i]
            i += 1
        ref = len(out) - ((ctrl & 0x1F) << 8) - data[i] - 1
        i += 1
        length += 2
        if ref < 0:
            raise ValueError("lzf: a back reference before the output")
        if ref + length <= len(out):
            out += out[ref:ref + length]
        else:  # the copy overlaps what it writes: a repeating pattern
            period = len(out) - ref
            pattern = bytes(out[ref:])
            out += (pattern * (length // period + 1))[:length]
    return bytes(out)


def unshuffle(data, itemsize):
    """Undo HDF5's shuffle filter: the chunk holds byte 0 of every element,
    then byte 1, ...; a tail shorter than one element stays as it is."""
    n = len(data) // itemsize
    if itemsize == 1 or n == 0:
        return data
    planes = np.frombuffer(data, np.uint8, n * itemsize).reshape(itemsize, n)
    return planes.T.tobytes() + data[n * itemsize:]


class _Object:
    """An object header's messages: [(type, data bytes, flags)]."""

    def __init__(self, messages):
        self.messages = messages

    def find(self, kind):
        return [(data, flags) for t, data, flags in self.messages
                if t == kind]

    def one(self, kind, what):
        found = self.find(kind)
        if len(found) != 1:
            raise ValueError(f"{what}: {len(found)} messages of type "
                             f"{kind:#x}, expected one")
        data, flags = found[0]
        if flags & 0x02:
            raise ValueError(f"{what}: a shared message of type {kind:#x} "
                             f"(a committed datatype) is not supported")
        return data


class File:
    """An HDF5 file opened for reading (memory-mapped); the root group."""

    def __init__(self, path):
        self.path = str(path)
        self._file = open(path, "rb")
        try:
            self._buf = mmap.mmap(self._file.fileno(), 0,
                                  access=mmap.ACCESS_READ)
        except ValueError:  # an empty file
            self._file.close()
            raise ValueError(f"{path}: not an HDF5 file (empty)") from None
        try:
            self._root = self._superblock()
        except BaseException:
            self.close()
            raise

    def close(self):
        if self._buf is not None:
            self._buf.close()
            self._buf = None
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def keys(self):
        return Group(self, self._root, "/").keys()

    def __contains__(self, name):
        return name in Group(self, self._root, "/")

    def __getitem__(self, name):
        return Group(self, self._root, "/")[name]

    # ---------------------------------------------------------------- file
    def _superblock(self):
        buf = self._buf
        at = 0
        while buf[at:at + 8] != SIGNATURE:
            at = 512 if at == 0 else 2 * at
            if at + 8 > len(buf):
                raise ValueError(f"{self.path}: no HDF5 signature")
        version = buf[at + 8]
        if version in (0, 1):
            self.O, self.L = buf[at + 13], buf[at + 14]
            fields = at + (24 if version == 0 else 28)
            self.base = _uint(buf, fields, self.O)
            entry = fields + 4 * self.O  # the root group's symbol entry
            return self._addr(entry + self.O)
        if version in (2, 3):
            self.O, self.L = buf[at + 9], buf[at + 10]
            fields = at + 12
            self.base = _uint(buf, fields, self.O)
            return self._addr(fields + 3 * self.O)
        raise ValueError(f"{self.path}: superblock version {version} is not "
                         f"supported")

    def _addr(self, offset):
        """The address stored at `offset` (None if undefined), absolute."""
        value = _uint(self._buf, offset, self.O)
        if value == (1 << (8 * self.O)) - 1:
            return None
        return self.base + value

    def _header(self, address):
        """The object header at `address`, continuation blocks included."""
        buf = self._buf
        messages = []
        if buf[address:address + 4] == b"OHDR":
            if buf[address + 4] != 2:
                raise ValueError(f"object header version {buf[address + 4]}"
                                 f" is not supported")
            flags = buf[address + 5]
            at = address + 6 + (16 if flags & 0x20 else 0) \
                + (4 if flags & 0x10 else 0)
            width = 1 << (flags & 0x03)
            size = _uint(buf, at, width)
            blocks = [(at + width, at + width + size)]
            head = 6 if flags & 0x04 else 4
            while blocks:
                at, end = blocks.pop(0)
                while at + head <= end:
                    kind, size = buf[at], _uint(buf, at + 1, 2)
                    data = buf[at + head:at + head + size]
                    messages.append((kind, data, buf[at + 3]))
                    if kind == _MSG_CONTINUATION:
                        start = self._addr(at + head)
                        length = _uint(buf, at + head + self.O, self.L)
                        if buf[start:start + 4] != b"OCHK":
                            raise ValueError("an object header continuation "
                                             "without its OCHK signature")
                        blocks.append((start + 4, start + length - 4))
                    at += head + size
        else:
            if buf[address] != 1:
                raise ValueError(f"object header version {buf[address]} is "
                                 f"not supported")
            size = _uint(buf, address + 8, 4)
            blocks = [(address + 16, address + 16 + size)]
            while blocks:
                at, end = blocks.pop(0)
                while at + 8 <= end:
                    kind, size = _uint(buf, at, 2), _uint(buf, at + 2, 2)
                    data = buf[at + 8:at + 8 + size]
                    messages.append((kind, data, buf[at + 4]))
                    if kind == _MSG_CONTINUATION:
                        start = self._addr(at + 8)
                        length = _uint(buf, at + 8 + self.O, self.L)
                        blocks.append((start, start + length))
                    at += 8 + size
        return _Object(messages)

    # -------------------------------------------------------------- groups
    def _links(self, obj, what):
        """{name: object header address} of a group, or None if `obj` is
        not a group."""
        table = obj.find(_MSG_SYMBOL_TABLE)
        if table:
            data = table[0][0]
            btree = self.base + _uint(data, 0, self.O)
            heap = self.base + _uint(data, self.O, self.O)
            return self._symbol_table(btree, heap)
        info = obj.find(_MSG_LINK_INFO)
        links = obj.find(_MSG_LINK)
        if not info and not links:
            return None
        if info:
            data = info[0][0]
            at = 2 + (8 if data[1] & 0x01 else 0)
            if _uint(data, at, self.O) != (1 << (8 * self.O)) - 1:
                raise ValueError(f"{what}: dense link storage (a fractal "
                                 f"heap) is not supported")
        return dict(self._link(data, what) for data, _ in links)

    def _link(self, data, what):
        flags = data[1]
        at = 2
        kind = 0
        if flags & 0x08:
            kind = data[at]
            at += 1
        if flags & 0x04:
            at += 8
        if flags & 0x10:
            at += 1
        width = 1 << (flags & 0x03)
        length = _uint(data, at, width)
        at += width
        name = bytes(data[at:at + length]).decode("utf-8")
        if kind != 0:
            raise ValueError(f"{what}/{name}: a soft or external link (type "
                             f"{kind}) is not supported")
        return name, self.base + _uint(data, at + length, self.O)

    def _symbol_table(self, btree, heap):
        buf = self._buf
        if buf[heap:heap + 4] != b"HEAP":
            raise ValueError("a group's local heap without its signature")
        names_at = self._addr(heap + 8 + 2 * self.L)
        links = {}
        entry = 2 * self.O + 24
        for node in self._btree_children(btree, 0):
            if buf[node:node + 4] != b"SNOD":
                raise ValueError("a symbol table node without its signature")
            for k in range(_uint(buf, node + 6, 2)):
                at = node + 8 + k * entry
                offset = _uint(buf, at, self.O)
                end = buf.find(b"\x00", names_at + offset)
                name = bytes(buf[names_at + offset:end]).decode("utf-8")
                links[name] = self._addr(at + self.O)
        return links

    def _btree_children(self, address, node_type, key_size=None):
        """The leaves' children of a v1 B-tree, in key order: symbol node
        addresses (type 0), or (key offset, chunk address) (type 1)."""
        buf = self._buf
        if buf[address:address + 4] != b"TREE":
            raise ValueError("a v1 B-tree node without its signature")
        if buf[address + 4] != node_type:
            raise ValueError(f"a v1 B-tree of type {buf[address + 4]}, "
                             f"expected {node_type}")
        level, used = buf[address + 5], _uint(buf, address + 6, 2)
        key = self.L if node_type == 0 else key_size
        at = address + 8 + 2 * self.O
        out = []
        for k in range(used):
            key_at = at + k * (key + self.O)
            child = self._addr(key_at + key)
            if level > 0:
                out += self._btree_children(child, node_type, key_size)
            elif node_type == 0:
                out.append(child)
            else:
                out.append((key_at, child))
        return out

    # ------------------------------------------------------------ datasets
    def _dataset(self, obj, what):
        shape = self._dataspace(obj.one(_MSG_DATASPACE, what), what)
        dtype = self._datatype(obj.one(_MSG_DATATYPE, what), what)
        layout = obj.one(_MSG_LAYOUT, what)
        filters = obj.find(_MSG_FILTERS)
        pipeline = self._filters(filters[0][0], what) if filters else []
        version, kind = layout[0], layout[1]
        if version not in (3, 4):
            raise ValueError(f"{what}: data layout message version "
                             f"{version} is not supported")
        n = int(np.prod(shape, dtype=np.int64))
        if kind == 0:  # compact
            size = _uint(layout, 2, 2)
            out = np.frombuffer(layout[4:4 + size], dtype, n).reshape(shape)
        elif kind == 1:  # contiguous
            address = self._addr_in(layout, 2)
            size = _uint(layout, 2 + self.O, self.L)
            if n == 0:
                out = np.zeros(shape, dtype)
            elif address is None:
                raise ValueError(f"{what}: contiguous storage was never "
                                 f"allocated (fill values are not supported)")
            else:
                if size < n * dtype.itemsize:
                    raise ValueError(f"{what}: contiguous storage of {size} "
                                     f"bytes holds fewer than {n} elements")
                out = np.frombuffer(
                    self._buf[address:address + n * dtype.itemsize], dtype
                ).reshape(shape)
        elif kind == 2:
            out = self._chunked(layout, shape, dtype, pipeline, what)
        else:
            raise ValueError(f"{what}: data layout class {kind} (virtual) is "
                             f"not supported")
        return out.astype(dtype.newbyteorder("="))

    def _addr_in(self, data, offset):
        value = _uint(data, offset, self.O)
        if value == (1 << (8 * self.O)) - 1:
            return None
        return self.base + value

    def _dataspace(self, data, what):
        version, rank, flags = data[0], data[1], data[2]
        if version == 1:
            at = 8
        elif version == 2:
            if data[3] == 2:
                raise ValueError(f"{what}: a null dataspace is not "
                                 f"supported")
            at = 4
        else:
            raise ValueError(f"{what}: dataspace version {version} is not "
                             f"supported")
        return tuple(_uint(data, at + k * self.L, self.L)
                     for k in range(rank))

    def _datatype(self, data, what):
        cls, version = data[0] & 0x0F, data[0] >> 4
        bits = _uint(data, 1, 3)
        size = _uint(data, 4, 4)
        if cls == 0:  # fixed point
            offset, precision = _uint(data, 8, 2), _uint(data, 10, 2)
            if size not in (1, 2, 4, 8) or offset or precision != 8 * size:
                raise ValueError(f"{what}: a {size}-byte integer with bit "
                                 f"offset {offset} and precision {precision}"
                                 f" is not supported")
            order = ">" if bits & 0x01 else "<"
            return np.dtype(f"{order}{'i' if bits & 0x08 else 'u'}{size}")
        if cls == 1:  # floating point
            layout = (_uint(data, 10, 2), data[12], data[13], data[14],
                      data[15], _uint(data, 16, 4))
            if bits & 0x40 or _IEEE.get(size) != layout \
                    or _uint(data, 8, 2) or (bits >> 8) & 0xFF != 8 * size - 1:
                raise ValueError(f"{what}: a {size}-byte float that is not "
                                 f"IEEE (layout {layout}) is not supported")
            return np.dtype(f"{'>' if bits & 0x01 else '<'}f{size}")
        if cls == 8:  # enumeration: only h5py's boolean
            members = bits & 0xFFFF
            base = self._datatype(data[8:], what)
            at = 8 + 12  # the base type's message: 8 bytes + 4 properties
            names = []
            for _ in range(members):
                end = bytes(data[at:]).index(b"\x00")
                names.append(bytes(data[at:at + end]).decode("utf-8"))
                at += end + 1
                if version < 3:
                    at = 8 + 12 + -(-(at - 20) // 8) * 8
            values = np.frombuffer(bytes(data[at:at + members
                                              * base.itemsize]), base)
            if base.kind != "i" or base.itemsize != 1 \
                    or names != ["FALSE", "TRUE"] \
                    or values.tolist() != [0, 1]:
                raise ValueError(f"{what}: an enumeration {names} over "
                                 f"{base} is not supported (only h5py's "
                                 f"boolean)")
            return np.dtype(np.bool_)
        raise ValueError(f"{what}: datatype class {cls} is not supported")

    def _filters(self, data, what):
        """[(filter id, client data)] in the order they were applied."""
        version, count = data[0], data[1]
        at = 8 if version == 1 else 2
        pipeline = []
        for _ in range(count):
            fid = _uint(data, at, 2)
            at += 2
            name_length = 0
            if version == 1 or fid >= 256:
                name_length = _uint(data, at, 2)
                at += 2
            n_values = _uint(data, at + 2, 2)
            at += 4 + name_length
            values = [_uint(data, at + 4 * k, 4) for k in range(n_values)]
            at += 4 * n_values
            if version == 1 and n_values % 2:
                at += 4
            if fid not in (_FILTER_DEFLATE, _FILTER_SHUFFLE, _FILTER_LZF):
                name = _FILTER_NAMES.get(fid, f"id {fid}")
                raise ValueError(f"{what}: the {name} filter is not "
                                 f"supported (deflate, shuffle and lzf are)")
            pipeline.append((fid, values))
        return pipeline

    def _decode(self, raw, pipeline, mask, itemsize):
        for k in range(len(pipeline) - 1, -1, -1):
            if mask >> k & 1:
                continue
            fid = pipeline[k][0]
            if fid == _FILTER_DEFLATE:
                raw = zlib.decompress(raw)
            elif fid == _FILTER_SHUFFLE:
                raw = unshuffle(raw, itemsize)
            else:
                raw = lzf_decompress(raw)
        return raw

    def _chunked(self, layout, shape, dtype, pipeline, what):
        """Read a chunked dataset: [(chunk origin, address, stored size,
        filter mask)] from its index, each chunk decoded into place."""
        version = layout[0]
        rank = len(shape)
        if version == 3:
            dims = layout[2]
            address = self._addr_in(layout, 3)
            at = 3 + self.O
            chunk = tuple(_uint(layout, at + 4 * k, 4) for k in range(dims))
            index = 0
        else:
            flags, dims, width = layout[2], layout[3], layout[4]
            if flags & 0x01:
                raise ValueError(f"{what}: unfiltered partial edge chunks "
                                 f"are not supported")
            at = 5
            chunk = tuple(_uint(layout, at + width * k, width)
                          for k in range(dims))
            at += width * dims
            index = layout[at]
            at += 1
        if dims != rank + 1 or chunk[-1] != dtype.itemsize:
            raise ValueError(f"{what}: chunk dimensions {chunk} do not fit "
                             f"shape {shape} of {dtype}")
        chunk = chunk[:-1]
        out = np.empty(shape, dtype)
        if out.size == 0:
            return out
        grid = tuple(-(-s // c) for s, c in zip(shape, chunk))
        chunk_bytes = int(np.prod(chunk)) * dtype.itemsize
        if index == 0:  # a v1 B-tree (layout version 3)
            if address is None:
                raise ValueError(f"{what}: no chunk was ever allocated")
            key = 8 + 8 * dims
            entries = []
            for key_at, child in self._btree_children(address, 1, key):
                origin = tuple(_uint(self._buf, key_at + 8 + 8 * k, 8)
                               for k in range(rank))
                entries.append((origin, child, _uint(self._buf, key_at, 4),
                                _uint(self._buf, key_at + 4, 4)))
        elif index == 1:  # a single chunk
            if flags & 0x02:
                size, mask = _uint(layout, at, self.L), \
                    _uint(layout, at + self.L, 4)
                at += self.L + 4
            else:
                size, mask = chunk_bytes, 0
            entries = [((0,) * rank, self._addr_in(layout, at), size, mask)]
        elif index == 3:  # a fixed array
            entries = self._fixed_array(self._addr_in(layout, at + 1), grid,
                                        chunk, chunk_bytes, what)
        else:
            raise ValueError(f"{what}: the {_INDEX_NAMES.get(index, index)} "
                             f"chunk index is not supported")
        seen = set()
        for origin, address, size, mask in entries:
            if address is None:
                raise ValueError(f"{what}: the chunk at {origin} was never "
                                 f"allocated (fill values are not supported)")
            raw = self._decode(bytes(self._buf[address:address + size]),
                               pipeline, mask, dtype.itemsize)
            if len(raw) != chunk_bytes:
                raise ValueError(f"{what}: the chunk at {origin} decodes to "
                                 f"{len(raw)} bytes, not {chunk_bytes}")
            block = np.frombuffer(raw, dtype).reshape(chunk)
            where = tuple(slice(o, min(o + c, s))
                          for o, c, s in zip(origin, chunk, shape))
            out[where] = block[tuple(slice(0, w.stop - w.start)
                                     for w in where)]
            seen.add(origin)
        if len(seen) != int(np.prod(grid)):
            raise ValueError(f"{what}: {int(np.prod(grid)) - len(seen)} of "
                             f"{int(np.prod(grid))} chunks were never "
                             f"allocated (fill values are not supported)")
        return out

    def _fixed_array(self, header, grid, chunk, chunk_bytes, what):
        buf = self._buf
        if buf[header:header + 4] != b"FAHD":
            raise ValueError(f"{what}: a fixed array header without its "
                             f"signature")
        client, entry, page_bits = buf[header + 5], buf[header + 6], \
            buf[header + 7]
        count = _uint(buf, header + 8, self.L)
        block = self._addr(header + 8 + self.L)
        if count != int(np.prod(grid)):
            raise ValueError(f"{what}: a fixed array of {count} chunks for a "
                             f"grid of {grid}")
        if block is None or buf[block:block + 4] != b"FADB":
            raise ValueError(f"{what}: a fixed array without its data block")
        at = block + 6 + self.O
        per_page = 1 << page_bits
        positions = []  # (element address, initialized)
        if count > per_page:
            pages = -(-count // per_page)
            bitmap = bytes(buf[at:at + -(-pages // 8)])
            at += len(bitmap) + 4  # past the data block's checksum
            for k in range(count):
                page, slot = divmod(k, per_page)
                positions.append((at + page * (per_page * entry + 4)
                                  + slot * entry,
                                  bool(bitmap[page // 8] >> (7 - page % 8)
                                       & 1)))
        else:
            positions = [(at + k * entry, True) for k in range(count)]
        entries = []
        for k, (pos, initialized) in enumerate(positions):
            origin = tuple(int(i) * c for i, c in
                           zip(np.unravel_index(k, grid), chunk))
            address = self._addr(pos) if initialized else None
            if client == 0:
                entries.append((origin, address, chunk_bytes, 0))
            else:
                width = entry - self.O - 4
                entries.append((origin, address,
                                _uint(buf, pos + self.O, width),
                                _uint(buf, pos + self.O + width, 4)))
        return entries


class Group:
    """A group of an open `File`: `keys()`, `name in group`,
    `group["name"]` (a nested Group or a dataset's numpy array), and
    `group["a/b"]` for a path; `in` looks at the group's own links."""

    def __init__(self, file, address, name):
        self._file = file
        self.name = name
        obj = file._header(address)
        links = file._links(obj, name)
        if links is None:
            raise ValueError(f"{name}: not a group")
        self._links = links

    def keys(self):
        return list(self._links)

    def __contains__(self, name):
        return name in self._links

    def __getitem__(self, path):
        head, _, rest = path.strip("/").partition("/")
        if head not in self._links:
            raise KeyError(f"{self.name.rstrip('/')}/{head}: no such object "
                           f"in {self._file.path}")
        name = f"{self.name.rstrip('/')}/{head}"
        address = self._links[head]
        obj = self._file._header(address)
        if self._file._links(obj, name) is not None:
            group = Group(self._file, address, name)
            return group[rest] if rest else group
        if rest:
            raise KeyError(f"{name}: a dataset, not a group")
        if not obj.find(_MSG_LAYOUT):
            raise ValueError(f"{name}: neither a group nor a dataset (a "
                             f"committed datatype?)")
        return self._file._dataset(obj, name)
