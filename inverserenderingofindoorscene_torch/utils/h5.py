"""The cascade hand-off's HDF5 files, read and written by the port itself.

Each hand-off file holds one dataset, ``data``, LZF-compressed, as the
reference writes it with h5py (3.14, on HDF5 1.14.6): ``File(path,
"w").create_dataset("data", data=arr, compression="lzf")``.  ``write`` gives
that call's bytes and ``read`` reads such a file back; both are the port's
only route to the files, on every machine.

What ``write`` reproduces, in file order:

* a version-0 superblock, the root group's object header, its symbol-table
  B-tree, local heap and symbol node (all at fixed addresses), and the
  dataset's version-1 object header (dataspace, datatype, fill value, LZF
  pipeline, chunked layout, padded to HDF5's 256-byte minimum);
* h5py's chunk shape (``guess_chunk``, from ``h5py/_hl/filters.py``);
* the order in which libhdf5's 1 MiB chunk cache writes the chunks out
  (C order, except that partial edge chunks wait for the close), each
  LZF-compressed into at most its own size by ``ops/csrc/lzf.cpp``, or
  else stored raw with the filter mask set (the filter is optional);
* the chunk index, a version-1 B-tree of 64-entry nodes, grown by
  libhdf5's insertion and split rules, its root at the first node's
  address;
* libhdf5's file-space manager for that sequence of requests: the 2 KiB
  metadata and small-data aggregators, the free-space sections they give
  back, and the shrinking of the end of the file at close.

One thing is not reproduced: h5py's LZF compressor reads a hash table it
never initialises, so where a chunk repeats 3-byte patterns often (data
quantised to a few values), a stale entry left by an earlier chunk can
give h5py a match that a clean table does not, and its bytes then depend
on what the process wrote before.  ``lzf.cpp`` starts each chunk from an
empty table: on the hand-off's float maps the bytes are h5py's, and where
they are not, each package reads the other's file to the same array.

``read`` takes any file of that form: a version-0 superblock, a root group
with a symbol table holding the one dataset ``data``, a version-1 object
header with IEEE little-endian float32 or float64 data, contiguous or
chunked (a version-1 B-tree of any depth), unfiltered or LZF (chunks that
LZF did not shrink are raw).  Anything else raises ``H5FormatError``
naming what it does not read.
"""

from __future__ import annotations

import ctypes
import struct
from pathlib import Path

import numpy as np

UNDEF = 0xFFFFFFFFFFFFFFFF
SIGNATURE = b"\x89HDF\r\n\x1a\n"
LZF_ID = 32000

# libhdf5's defaults for a file h5py creates.
BLOCK = 2048  # H5F_META_BLOCK_SIZE_DEF and H5F_SDATA_BLOCK_SIZE_DEF
CHUNK_K = 32             # istore_k: 2K = 64 entries a chunk B-tree node
SPLIT_RATIOS = (0.1, 0.5, 0.9)  # H5D_XFER_BTREE_SPLIT_RATIO_DEF
OHDR_MIN = 256           # H5D_MINHDR_SIZE

# Fixed addresses of the metadata a new file with one dataset holds.
ROOT_OHDR = 0x60
GROUP_BTREE = 0x88
LOCAL_HEAP = 0x2A8
HEAP_DATA = 0x2C8
DSET_OHDR = 0x320
SYMBOL_NODE = 0x430
CHUNK_ROOT = 0x578

# h5py/_hl/filters.py
CHUNK_BASE = 16 * 1024
CHUNK_MIN = 8 * 1024
CHUNK_MAX = 1024 * 1024

# The datatype message body of each type the port writes: IEEE
# little-endian float, its size, precision, exponent and mantissa fields
# and bias.
_FLOAT_TYPES = {
    np.dtype("<f4"): bytes.fromhex("11201f0004000000000020001708001"
                                   "77f000000"),
    np.dtype("<f8"): bytes.fromhex("11203f000800000000004000340b003"
                                   "4ff030000"),
}


class H5FormatError(ValueError):
    """A file this reader does not read, or an array the writer does not
    write; the message names what is missing."""


# -- LZF (ops/csrc/lzf.cpp) ---------------------------------------------------

def _lzf():
    from inverserenderingofindoorscene_torch.ops import build

    lib = build.load_host("lzf")
    if not getattr(lib, "_typed", False):
        for fn in (lib.lzf_encode, lib.lzf_decode):
            fn.restype = ctypes.c_long
            fn.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p,
                           ctypes.c_long]
        lib._typed = True
    return lib


def lzf_compress(data: bytes, out_len: int) -> bytes | None:
    """LZF of ``data`` in at most ``out_len`` bytes, or None where it does
    not fit (h5py's filter then stores the chunk raw)."""
    out = ctypes.create_string_buffer(max(out_len, 1))
    n = _lzf().lzf_encode(data, len(data), out, out_len)
    return out.raw[:n] if n > 0 else None


def lzf_decompress(data: bytes, out_len: int) -> bytes:
    out = ctypes.create_string_buffer(max(out_len, 1))
    n = _lzf().lzf_decode(data, len(data), out, out_len)
    if n != out_len:
        raise H5FormatError(f"LZF chunk does not decode to {out_len} bytes")
    return out.raw[:out_len]


# -- h5py's chunk guess ---------------------------------------------------------

def guess_chunk(shape, typesize: int) -> tuple:
    """h5py's ``guess_chunk`` for a fixed-size dataset, in its float64
    arithmetic."""
    ndims = len(shape)
    if ndims == 0:
        raise H5FormatError("a scalar dataset has no chunks")
    chunks = np.array(shape, dtype="=f8")

    def product(nums):
        prod = 1
        for n in nums:
            prod *= n
        return prod

    dset_size = product(chunks) * typesize
    target_size = CHUNK_BASE * (2 ** np.log10(dset_size / (1024. * 1024)))
    if target_size > CHUNK_MAX:
        target_size = CHUNK_MAX
    elif target_size < CHUNK_MIN:
        target_size = CHUNK_MIN
    idx = 0
    while True:
        chunk_bytes = product(chunks) * typesize
        if (chunk_bytes < target_size
                or abs(chunk_bytes - target_size) / target_size < 0.5) \
                and chunk_bytes < CHUNK_MAX:
            break
        if product(chunks) == 1:
            break
        chunks[idx % ndims] = np.ceil(chunks[idx % ndims] / 2.0)
        idx += 1
    return tuple(int(x) for x in chunks)


# -- libhdf5's file-space manager, for the writer -----------------------------

class _Aggregator:
    """H5F_blk_aggr_t: a block at ``addr`` with ``size`` bytes left, of
    ``tot_size`` bytes handed out and left since it started."""

    __slots__ = ("addr", "size", "tot_size", "raw")

    def __init__(self, raw: bool):
        self.addr = self.size = self.tot_size = 0
        self.raw = raw

    def reset(self):
        self.addr = self.size = self.tot_size = 0

    def adjoins(self, addr: int, size: int) -> bool:
        return addr + size == self.addr or self.addr + self.size == addr


class _FileSpace:
    """libhdf5's file-space manager (H5MF) as it serves a file h5py creates:
    non-paged, strategy FSM_AGGR, no alignment, free space not persisted.
    An allocation takes the best-fitting free section of its kind (raw data
    or metadata), else goes through its aggregator; freed space merges with
    its neighbours and goes back to the end of the file or to an adjacent
    aggregator where it can."""

    def __init__(self, eoa: int, meta: tuple):
        self.eoa = eoa
        self.meta = _Aggregator(raw=False)
        self.meta.addr, self.meta.size, self.meta.tot_size = meta
        self.sdata = _Aggregator(raw=True)
        # [addr, size] sections by kind; None until a section that cannot
        # be given back starts the kind's free-space manager.
        self.free = {False: None, True: None}

    def aggregator(self, raw: bool) -> _Aggregator:
        return self.sdata if raw else self.meta

    def alloc(self, size: int, raw: bool) -> int:
        """H5MF_alloc."""
        sections = self.free[raw]
        fits = [s for s in sections or () if s[1] >= size]
        if fits:
            sect = min(fits, key=lambda s: (s[1], s[0]))
            sections.remove(sect)
            if sect[1] > size:
                self._add(raw, sect[0] + size, sect[1] - size)
            return sect[0]
        return self._aggr_alloc(self.aggregator(raw),
                                self.aggregator(not raw), size)

    def _aggr_alloc(self, aggr: _Aggregator, other: _Aggregator,
                    size: int) -> int:
        """H5MF__aggr_alloc."""
        if size <= aggr.size:
            addr = aggr.addr
            aggr.addr += size
            aggr.size -= size
            return addr
        at_eoa = aggr.addr > 0 and aggr.addr + aggr.size == self.eoa
        if size >= BLOCK:          # larger than a block: at the EOA
            if at_eoa:
                addr = aggr.addr
                self.eoa += size
                aggr.addr += size
                aggr.tot_size += size
                return addr
            self._release(other)
            addr = self.eoa
            self.eoa += size
            return addr
        if at_eoa:                      # another block, extending this one
            self.eoa += BLOCK
            aggr.size += BLOCK
            aggr.tot_size += BLOCK
        else:                           # another block, at the EOA
            self._release(other)
            new = self.eoa
            self.eoa += BLOCK
            if aggr.size > 0:
                self.xfree(aggr.addr, aggr.size, aggr.raw)
            aggr.addr, aggr.size, aggr.tot_size = new, BLOCK, BLOCK
        addr = aggr.addr
        aggr.addr += size
        aggr.size -= size
        return addr

    def _release(self, other: _Aggregator):
        """Give the other aggregator's rest back when it ends the file and
        has handed out a block's worth."""
        if (other.size > 0 and other.addr + other.size == self.eoa
                and other.tot_size > other.size
                and other.tot_size - other.size >= BLOCK):
            self.eoa = other.addr
            other.reset()

    def xfree(self, addr: int, size: int, raw: bool):
        """H5MF_xfree."""
        if self.free[raw] is None:
            # H5MF_try_shrink (the section may not take in an aggregator)
            aggr = self.aggregator(raw)
            if addr + size == self.eoa:
                self.eoa = addr
                return
            if aggr.adjoins(addr, size):
                self._aggr_takes(aggr, addr, size)
                return
            self.free[raw] = []
        if size > 0:
            self._add(raw, addr, size)

    @staticmethod
    def _aggr_takes(aggr: _Aggregator, addr: int, size: int):
        if addr + size == aggr.addr:
            aggr.addr -= size
            aggr.size += size
            aggr.tot_size -= min(aggr.tot_size, size)
        else:
            aggr.size += size

    def _add(self, raw: bool, addr: int, size: int):
        """H5FS_sect_add with H5FS_ADD_RETURNED_SPACE: merge with the
        neighbours, then shrink the file or feed an aggregator while the
        section (or, once it is gone, the last section) allows it."""
        sections = self.free[raw]
        merged = True
        while merged:
            merged = False
            for s in sections:
                if s[0] + s[1] == addr or addr + size == s[0]:
                    sections.remove(s)
                    addr, size = min(addr, s[0]), size + s[1]
                    merged = True
                    break
        sect, listed = [addr, size], False
        aggr = self.aggregator(raw)
        while sect is not None:
            if sect[0] + sect[1] == self.eoa:
                shrink = "eoa"
            elif aggr.adjoins(*sect):
                shrink = ("sect" if aggr.size + sect[1] >= BLOCK
                          else "aggr")
            else:
                break
            if listed:
                sections.remove(sect)
                listed = False
            if shrink == "eoa":
                self.eoa = sect[0]
                sect = None
            elif shrink == "sect":      # the section takes the aggregator
                if sect[0] + sect[1] == aggr.addr:
                    sect[1] += aggr.size
                else:
                    sect[0] -= aggr.size
                    sect[1] += aggr.size
                aggr.reset()
                continue
            else:
                self._aggr_takes(aggr, *sect)
                sect = None
            if sections:
                sect, listed = max(sections, key=lambda s: s[0]), True
        if sect is not None and not listed:
            sections.append(sect)

    def close(self) -> int:
        """H5MF_close: the aggregators' rests are freed (the later one
        first), then sections and aggregators at the end of the file go;
        returns the final end of the file."""
        for aggr in sorted((self.meta, self.sdata), key=lambda a: -a.addr):
            if aggr.size > 0:
                addr, size = aggr.addr, aggr.size
                aggr.reset()
                self.xfree(addr, size, aggr.raw)
        shrank = True
        while shrank:
            shrank = False
            for raw in (False, True):
                if self.free[raw]:
                    last = max(self.free[raw], key=lambda s: s[0])
                    if last[0] + last[1] == self.eoa:
                        self.free[raw].remove(last)
                        self.eoa = last[0]
                        shrank = True
            for aggr in (self.meta, self.sdata):
                if aggr.size > 0 and aggr.addr + aggr.size == self.eoa:
                    self.eoa = aggr.addr
                    aggr.reset()
                    shrank = True
        return self.eoa


# -- the chunk cache and the chunk index, for the writer ------------------------

RDCC_NBYTES = 1024 * 1024   # h5py's default chunk cache: 1 MiB,
RDCC_NSLOTS = 521           # 521 slots,
RDCC_W0 = 0.75              # preemption policy 0.75


def _flush_order(grid: tuple, edge: list, chunk_bytes: int) -> list:
    """The order in which libhdf5's chunk cache (H5D rdcc) writes out the
    chunks of one H5Dwrite of the whole dataset: chunks enter in C order;
    making room preempts, from the least recently used end, chunks that
    were written whole (method 0) and, once 75% of the list has been
    passed, any chunk (method 1); a chunk whose hash slot is taken evicts
    the holder; the rest are flushed in list order when the dataset
    closes.  A partial edge chunk is never written whole, so it waits.
    ``edge`` flags the partial chunks in C order."""
    bits = [max(n - 1, 0).bit_length() for n in grid]
    order, cache, slots, used = [], [], {}, 0
    for linear, index in enumerate(np.ndindex(*grid)):
        val = index[0]
        for b, s in zip(bits[1:], index[1:]):
            val = (val << b) ^ s
        slot = val % RDCC_NSLOTS
        if slot in slots:
            held = slots.pop(slot)
            cache.remove(held)
            used -= chunk_bytes
            order.append(held)
        # H5D__chunk_cache_prune
        w0 = int(len(cache) * RDCC_W0)
        p0, p1 = (0 if cache else None), None
        while (p0 is not None or p1 is not None) \
                and used + chunk_bytes > RDCC_NBYTES:
            if w0 == 0:
                p1 = 0 if cache else None
            n0 = None if p0 is None else p0 + 1
            n1 = None if p1 is None else p1 + 1
            for method in (0, 1):
                if used + chunk_bytes <= RDCC_NBYTES:
                    break
                cur = None
                if method == 0 and p0 is not None and not edge[cache[p0]]:
                    cur = p0
                elif method == 1 and p1 is not None:
                    cur = p1
                if cur is None:
                    continue
                victim = cache.pop(cur)
                slots.pop(next(k for k, v in slots.items() if v == victim))
                used -= chunk_bytes
                order.append(victim)
                # positions after the removed entry move down by one
                p0 = None if p0 == cur else (p0 - (p0 > cur)
                                             if p0 is not None else None)
                p1 = None if p1 == cur else (p1 - (p1 > cur)
                                             if p1 is not None else None)
                n0 = None if n0 is None else n0 - (n0 > cur)
                n1 = None if n1 is None else n1 - (n1 > cur)
            p0 = n0 if n0 is not None and n0 < len(cache) else None
            p1 = n1 if n1 is not None and n1 < len(cache) else None
            w0 -= 1
        cache.append(linear)
        slots[slot] = linear
        used += chunk_bytes
    return order + cache


class _Node:
    __slots__ = ("addr", "level", "keys", "children", "left", "right")

    def __init__(self, addr: int, level: int):
        self.addr, self.level = addr, level
        self.keys = []       # (nbytes, filter mask, scaled offset) x n + 1
        self.children = []   # chunk addresses, or the child nodes above
        self.left = self.right = UNDEF


class _ChunkTree:
    """libhdf5's version-1 B-tree of chunks (H5B driven by H5D's chunk
    class: no min/max branch following, left critical key).  A key is
    (nbytes, filter mask, scaled offset), the offset carrying the element
    dimension (0); keys compare by their offsets, lexicographically.  A
    chunk beyond the right edge key gets a new right key, its offset + 1
    in every dimension (H5D__btree_new_node); one below every key goes in
    front.  A full node splits 57/7 with no right sibling, 6/58 with no
    left one, else in halves (the default split ratios), and the root keeps
    its address when it splits."""

    NOOP, LEFT, RIGHT = 0, 1, 2

    def __init__(self, space: _FileSpace, node_size: int):
        self.space, self.node_size = space, node_size
        self.root = _Node(CHUNK_ROOT, 0)
        self.nodes = {CHUNK_ROOT: self.root}

    @staticmethod
    def _cmp3(lt_key, scaled, rt_key) -> int:
        if scaled >= rt_key[2]:
            return 1
        if scaled < lt_key[2]:
            return -1
        return 0

    def insert(self, scaled: tuple, nbytes: int, mask: int, addr: int):
        """H5B_insert of one chunk."""
        chunk = ((nbytes, mask, scaled), addr)
        # the root's caller has no keys around it
        ins, md_key, split = self._insert_helper(self.root, [None, None], 0,
                                                 chunk)[:3]
        if ins != self.RIGHT:
            return
        # The root split: its contents move to a new node, and the root,
        # at its address, holds the two halves.
        root = self.root
        moved = self._new_node(root.level)
        moved.keys, moved.children = root.keys, root.children
        moved.left, moved.right = UNDEF, split.addr
        split.left = moved.addr
        root.level += 1
        root.keys = [moved.keys[0], md_key, split.keys[-1]]
        root.children = [moved, split]
        root.left = root.right = UNDEF

    def _new_node(self, level: int) -> _Node:
        node = _Node(self.space.alloc(self.node_size, raw=False), level)
        self.nodes[node.addr] = node
        return node

    def _insert_helper(self, node: _Node, pkeys: list, pi: int, chunk):
        """H5B__insert_helper: ``pkeys[pi]`` and ``pkeys[pi + 1]`` are the
        caller's keys around this node, updated in place.  Returns
        (insertion, mid key, split node, left key changed, right key
        changed)."""
        key, addr = chunk
        keys = node.keys
        n = len(node.children)
        lt, rt, idx, cmp = 0, n, 0, -1
        while lt < rt and cmp:
            idx = (lt + rt) // 2
            cmp = self._cmp3(keys[idx], key[2], keys[idx + 1])
            if cmp < 0:
                rt = idx
            else:
                lt = idx + 1
        ins, md_key, child = self.NOOP, None, None
        lt_changed = rt_changed = False
        if n == 0:
            node.keys = [key, (0, 0, tuple(s + 1 for s in key[2]))]
            node.children = [addr]
            keys, idx = node.keys, 0
        elif cmp < 0 and idx == 0:
            if node.level > 0:
                ins, md_key, child, lt_changed, rt_changed = \
                    self._insert_helper(node.children[0], keys, 0, chunk)
            else:
                ins, md_key, child = self.LEFT, keys[0], addr
                keys[0] = key
                lt_changed = True
        elif cmp > 0 and idx + 1 >= n:
            idx = n - 1
            if node.level > 0:
                ins, md_key, child, lt_changed, rt_changed = \
                    self._insert_helper(node.children[idx], keys, idx, chunk)
            else:
                ins, md_key, child = self.RIGHT, key, addr
                keys[idx + 1] = (0, 0, tuple(s + 1 for s in key[2]))
                rt_changed = True
        elif cmp:
            raise AssertionError("chunk B-tree: no branch to follow")
        elif node.level > 0:
            ins, md_key, child, lt_changed, rt_changed = \
                self._insert_helper(node.children[idx], keys, idx, chunk)
        else:
            ins, md_key, child = self.RIGHT, key, addr
        if lt_changed:
            if idx > 0:
                lt_changed = False
            else:
                pkeys[pi] = keys[idx]
        if rt_changed:
            if idx + 1 < len(node.children):
                rt_changed = False
            else:
                pkeys[pi + 1] = keys[idx + 1]
        split = None
        if ins in (self.LEFT, self.RIGHT):
            target = node
            if len(node.children) == 2 * CHUNK_K:
                split = self._split(node, idx)
                if idx >= len(node.children):
                    idx -= len(node.children)
                    target = split
            # H5B__insert_child: the mid key goes in at idx + 1
            target.keys.insert(idx + 1, md_key)
            target.children.insert(idx + 1 if ins == self.RIGHT else idx,
                                   child)
        if split is not None:
            return self.RIGHT, split.keys[0], split, lt_changed, rt_changed
        return self.NOOP, None, None, lt_changed, rt_changed

    def _split(self, node: _Node, idx: int) -> _Node:
        """H5B__split: a new right sibling takes node's entries from
        nleft on."""
        two_k = 2 * CHUNK_K
        if node.right == UNDEF:
            nleft = int(two_k * SPLIT_RATIOS[2])
        elif node.left == UNDEF:
            nleft = int(two_k * SPLIT_RATIOS[0])
        else:
            nleft = two_k // 2
        if idx < nleft and nleft == two_k:
            nleft -= 1
        elif idx >= nleft and nleft == 0:
            nleft += 1
        new = self._new_node(node.level)
        new.keys, node.keys = node.keys[nleft:], node.keys[:nleft + 1]
        new.children, node.children = (node.children[nleft:],
                                       node.children[:nleft])
        new.left, new.right = node.addr, node.right
        if node.right != UNDEF:
            self.nodes[node.right].left = new.addr
        node.right = new.addr
        return new

    def encode(self, node: _Node, scale: tuple) -> bytes:
        out = bytearray(self.node_size)
        struct.pack_into("<4sBBHQQ", out, 0, b"TREE", 1, node.level,
                         len(node.children), node.left, node.right)
        pos = 24
        for i, (nbytes, mask, scaled) in enumerate(node.keys):
            struct.pack_into(f"<II{len(scale)}Q", out, pos, nbytes, mask,
                             *(s * d for s, d in zip(scaled, scale)))
            pos += 8 + 8 * len(scale)
            if i < len(node.children):
                child = node.children[i]
                struct.pack_into("<Q", out, pos, child if node.level == 0
                                 else child.addr)
                pos += 8
        return bytes(out)


# -- the writer ---------------------------------------------------------------------

def _message(mtype: int, flags: int, body: bytes) -> bytes:
    body = body + bytes(-len(body) % 8)
    return struct.pack("<HHB3x", mtype, len(body), flags) + body


def _dataset_header(shape, dtype, chunks) -> bytes:
    """The dataset's v1 object header, h5py's six messages."""
    rank = len(shape)
    space = struct.pack(f"<BBBx4x{rank}Q{rank}Q", 1, rank, 1, *shape, *shape)
    chunk_bytes = int(np.prod(chunks)) * dtype.itemsize
    pipeline = (struct.pack("<BB6x", 1, 1)
                + struct.pack("<HHHH", LZF_ID, 8, 1, 3) + b"lzf\0\0\0\0\0"
                + struct.pack("<III", 4, 0x105, chunk_bytes))
    layout = (struct.pack("<BBBQ", 3, 2, rank + 1, CHUNK_ROOT)
              + struct.pack(f"<{rank + 1}I", *chunks, dtype.itemsize))
    msgs = b"".join((
        _message(0x01, 0, space),
        _message(0x03, 1, _FLOAT_TYPES[dtype]),
        _message(0x05, 1, bytes.fromhex("0203020100000000")),
        _message(0x0B, 1, pipeline),
        _message(0x08, 0, layout),
    ))
    if len(msgs) + 8 > OHDR_MIN:
        raise H5FormatError(f"a rank-{rank} dataset's header does not fit "
                            f"h5py's {OHDR_MIN}-byte object header")
    msgs += _message(0x00, 0, bytes(OHDR_MIN - len(msgs) - 8))
    return struct.pack("<BxHII4x", 1, 6, 1, OHDR_MIN) + msgs


def _prefix(eof: int, dset_header: bytes) -> bytearray:
    """Bytes [0, CHUNK_ROOT): the superblock, the root group and the
    dataset's header, as libhdf5 lays out a new file with one dataset."""
    out = bytearray(CHUNK_ROOT)
    struct.pack_into("<8sBBBBBBBBHHIQQQQ", out, 0, SIGNATURE, 0, 0, 0, 0, 0,
                     8, 8, 0, 4, 16, 0, 0, UNDEF, eof, UNDEF)
    # the root group's symbol-table entry: cached B-tree and heap
    struct.pack_into("<QQII", out, 56, 0, ROOT_OHDR, 1, 0)
    struct.pack_into("<QQ", out, 80, GROUP_BTREE, LOCAL_HEAP)
    struct.pack_into("<BxHIIx4x", out, ROOT_OHDR, 1, 1, 1, 24)
    out[ROOT_OHDR + 16:ROOT_OHDR + 40] = _message(
        0x11, 0, struct.pack("<QQ", GROUP_BTREE, LOCAL_HEAP))
    struct.pack_into("<4sBBHQQQQQ", out, GROUP_BTREE, b"TREE", 0, 0, 1,
                     UNDEF, UNDEF, 0, SYMBOL_NODE, 8)
    struct.pack_into("<4sB3xQQQ", out, LOCAL_HEAP, b"HEAP", 0, 88, 16,
                     HEAP_DATA)
    out[HEAP_DATA + 8:HEAP_DATA + 12] = b"data"
    struct.pack_into("<QQ", out, HEAP_DATA + 16, 1, 72)
    out[DSET_OHDR:DSET_OHDR + len(dset_header)] = dset_header
    struct.pack_into("<4sBxHQQ", out, SYMBOL_NODE, b"SNOD", 1, 1, 8,
                     DSET_OHDR)
    return out


def _chunk_blocks(arr: np.ndarray, chunks: tuple):
    """(scaled offset, chunk bytes) in C order; edge chunks are padded with
    the fill value, 0."""
    grid = [-(-n // c) for n, c in zip(arr.shape, chunks)]
    for index in np.ndindex(*grid):
        sl = tuple(slice(i * c, (i + 1) * c) for i, c in zip(index, chunks))
        block = arr[sl]
        if block.shape != chunks:
            padded = np.zeros(chunks, arr.dtype)
            padded[tuple(slice(0, n) for n in block.shape)] = block
            block = padded
        yield index, np.ascontiguousarray(block).tobytes()


def encode(arr: np.ndarray) -> bytes:
    """The bytes h5py writes for ``File(path, "w").create_dataset("data",
    data=arr, compression="lzf")``."""
    arr = np.asarray(arr)
    dtype = arr.dtype.newbyteorder("<")
    if dtype not in _FLOAT_TYPES:
        raise H5FormatError(f"dtype {arr.dtype} (the writer takes float32 "
                            "and float64)")
    if arr.ndim == 0 or arr.size == 0:
        raise H5FormatError(f"shape {arr.shape} (the writer takes non-empty "
                            "arrays of rank >= 1)")
    arr = arr.astype(dtype, copy=False)
    rank = arr.ndim
    chunks = guess_chunk(arr.shape, dtype.itemsize)
    node_size = 24 + (2 * CHUNK_K + 1) * (8 + 8 * (rank + 1)) \
        + 2 * CHUNK_K * 8
    header = _dataset_header(arr.shape, dtype, chunks)
    # After the root group, the dataset's header and its symbol node, the
    # metadata aggregator's first 2 KiB block is at CHUNK_ROOT; the chunk
    # B-tree's root, larger than a block, extends the file from there.
    space = _FileSpace(BLOCK + node_size,
                       (CHUNK_ROOT + node_size, BLOCK - CHUNK_ROOT,
                        BLOCK + node_size))
    tree = _ChunkTree(space, node_size)
    blocks = list(_chunk_blocks(arr, chunks))
    grid = tuple(-(-n // c) for n, c in zip(arr.shape, chunks))
    edge = [any((i + 1) * c > n for i, c, n in zip(index, chunks, arr.shape))
            for index, _ in blocks]
    stored = []
    for linear in _flush_order(grid, edge, len(blocks[0][1])):
        index, raw = blocks[linear]
        packed = lzf_compress(raw, len(raw))
        data, mask = (raw, 1) if packed is None else (packed, 0)
        addr = space.alloc(len(data), raw=True)
        tree.insert(tuple(index) + (0,), len(data), mask, addr)
        stored.append((addr, data))
    eof = space.close()
    out = _prefix(eof, header)
    out.extend(bytes(eof - len(out)))
    scale = tuple(chunks) + (dtype.itemsize,)
    for addr, node in tree.nodes.items():
        out[addr:addr + node_size] = tree.encode(node, scale)
    for addr, data in stored:
        out[addr:addr + len(data)] = data
    return bytes(out)


def write(path, arr: np.ndarray) -> None:
    """Write ``arr`` as the one LZF dataset ``data`` of a new file."""
    Path(path).write_bytes(encode(arr))


# -- the reader ---------------------------------------------------------------------

class _File:
    def __init__(self, buf: bytes, path):
        self.buf, self.path = buf, path

    def fail(self, what: str):
        raise H5FormatError(f"{self.path}: {what}")

    def at(self, fmt: str, addr: int) -> tuple:
        size = struct.calcsize(fmt)
        if addr == UNDEF or addr + size > len(self.buf):
            self.fail(f"address {addr:#x} is outside the file")
        return struct.unpack_from(fmt, self.buf, addr)

    def span(self, addr: int, size: int) -> bytes:
        if addr == UNDEF or addr + size > len(self.buf):
            self.fail(f"address {addr:#x} is outside the file")
        return self.buf[addr:addr + size]

    def messages(self, addr: int) -> list:
        """(type, body) of a version-1 object header in one block."""
        if self.span(addr, 4) == b"OHDR":
            self.fail("a version-2 object header (this reader takes "
                      "version 1)")
        version, nmsgs, _, size = self.at("<BxHII", addr)
        if version != 1:
            self.fail(f"object header version {version} (this reader takes "
                      "version 1)")
        pos, end, out = addr + 16, addr + 16 + size, []
        while pos + 8 <= end and len(out) < nmsgs:
            mtype, msize = self.at("<HH", pos)
            out.append((mtype, self.span(pos + 8, msize)))
            pos += 8 + msize
        return out

    def root_entries(self) -> dict:
        """{name: object header address} of the root group."""
        if self.span(0, 8) != SIGNATURE:
            self.fail("no HDF5 signature at offset 0")
        version = self.buf[8]
        if version != 0:
            self.fail(f"superblock version {version} (this reader takes "
                      "version 0)")
        sizes = self.buf[13], self.buf[14]
        if sizes != (8, 8):
            self.fail(f"offsets/lengths of {sizes} bytes (this reader takes "
                      "8 and 8)")
        root = self.at("<Q", 56 + 8)[0]
        table = [b for t, b in self.messages(root) if t == 0x11]
        if not table:
            self.fail("a root group without a symbol table")
        btree, heap = struct.unpack_from("<QQ", table[0])
        if self.span(heap, 4) != b"HEAP":
            self.fail("no local heap for the root group")
        heap_size, _, heap_data = self.at("<QQQ", heap + 8)
        names = self.span(heap_data, heap_size)
        entries = {}
        for snod in self._group_leaves(btree):
            if self.span(snod, 4) != b"SNOD":
                self.fail("no symbol node in the root group's B-tree")
            for i in range(self.at("<H", snod + 6)[0]):
                name_off, header = self.at("<QQ", snod + 8 + 40 * i)
                name = names[name_off:names.index(b"\0", name_off)]
                entries[name.decode()] = header
        return entries

    def _group_leaves(self, addr: int) -> list:
        if self.span(addr, 4) != b"TREE":
            self.fail("no B-tree node for the root group")
        ntype, level, n = self.at("<BBH", addr + 4)
        if ntype != 0:
            self.fail(f"a type-{ntype} B-tree for the root group")
        children = [self.at("<Q", addr + 24 + 8 + 16 * i)[0]
                    for i in range(n)]
        if level == 0:
            return children
        return [leaf for c in children for leaf in self._group_leaves(c)]

    def chunks(self, addr: int, rank: int) -> list:
        """(offset, nbytes, filter mask, address) of every chunk under the
        B-tree node at ``addr``."""
        if self.span(addr, 4) != b"TREE":
            self.fail(f"no chunk B-tree node at {addr:#x}")
        ntype, level, n = self.at("<BBH", addr + 4)
        if ntype != 1:
            self.fail(f"a type-{ntype} B-tree for chunks")
        step = 8 + 8 * (rank + 1) + 8
        out = []
        for i in range(n):
            pos = addr + 24 + step * i
            nbytes, mask = self.at("<II", pos)
            offset = self.at(f"<{rank + 1}Q", pos + 8)[:rank]
            child = self.at("<Q", pos + step - 8)[0]
            if level == 0:
                out.append((offset, nbytes, mask, child))
            else:
                out.extend(self.chunks(child, rank))
        return out


def _dtype(f: _File, body: bytes) -> np.dtype:
    cls, version = body[0] & 0x0F, body[0] >> 4
    size = struct.unpack_from("<I", body, 4)[0]
    for dtype, known in _FLOAT_TYPES.items():
        if body[:len(known)] == known:
            return dtype
    if cls == 1 and body[1] & 1:
        f.fail(f"big-endian float{8 * size} data (this reader takes "
               "little-endian)")
    kinds = {0: "integer", 1: "float", 2: "time", 3: "string",
             4: "bitfield", 5: "opaque", 6: "compound", 7: "reference",
             8: "enum", 9: "variable-length", 10: "array"}
    f.fail(f"a {8 * size}-bit {kinds.get(cls, f'class-{cls}')} datatype "
           f"(version {version}; this reader takes IEEE float32 and "
           "float64)")


def _shape(f: _File, body: bytes) -> tuple:
    if body[0] != 1:
        f.fail(f"dataspace message version {body[0]} (this reader takes 1)")
    return struct.unpack_from(f"<{body[1]}Q", body, 8)


def _filters(f: _File, body: bytes) -> list:
    """The filter ids of a version-1 pipeline; any but LZF raises."""
    if body[0] != 1:
        f.fail(f"filter pipeline message version {body[0]} (this reader "
               "takes 1)")
    pos, ids = 8, []
    for _ in range(body[1]):
        fid, name_len, _, ncd = struct.unpack_from("<HHHH", body, pos)
        if fid != LZF_ID:
            names = {1: "deflate (gzip)", 2: "shuffle", 3: "fletcher32",
                     4: "szip", 5: "nbit", 6: "scaleoffset"}
            f.fail(f"filter {fid} ({names.get(fid, 'unknown')}; this reader "
                   "takes LZF, 32000, or none)")
        pos += 8 + name_len + -name_len % 8 + 4 * (ncd + ncd % 2)
        ids.append(fid)
    return ids


def read(path) -> np.ndarray:
    """The dataset ``data`` of a hand-off file, as stored."""
    f = _File(Path(path).read_bytes(), path)
    entries = f.root_entries()
    if list(entries) != ["data"]:
        f.fail(f"objects {sorted(entries)} in the root group (this reader "
               "takes the one dataset 'data')")
    shape = dtype = layout = None
    filters = []
    known = {0x00, 0x05, 0x12}  # NIL, fill value, modification time
    for mtype, body in f.messages(entries["data"]):
        if mtype == 0x01:
            shape = _shape(f, body)
        elif mtype == 0x03:
            dtype = _dtype(f, body)
        elif mtype == 0x08:
            layout = body
        elif mtype == 0x0B:
            filters = _filters(f, body)
        elif mtype not in known:
            f.fail(f"object header message type {mtype:#x} (this reader "
                   "takes dataspace, datatype, fill value, layout, filter "
                   "pipeline and modification time, in one block)")
    if shape is None or dtype is None or layout is None:
        f.fail("'data' is not a dataset")
    if layout[0] != 3:
        f.fail(f"layout message version {layout[0]} (this reader takes 3)")
    out = np.zeros(shape, dtype)
    if layout[1] == 1:                                  # contiguous
        addr, size = struct.unpack_from("<QQ", layout, 2)
        if filters:
            f.fail("a filtered contiguous dataset")
        if addr != UNDEF:
            out = np.frombuffer(f.span(addr, out.nbytes),
                                dtype).reshape(shape).copy()
        return out
    if layout[1] != 2:
        f.fail(f"layout class {layout[1]} (this reader takes contiguous "
               "and chunked)")
    rank = layout[2] - 1
    if rank != len(shape):
        f.fail(f"a rank-{rank} chunk layout for a rank-{len(shape)} space")
    btree = struct.unpack_from("<Q", layout, 3)[0]
    chunk = struct.unpack_from(f"<{rank}I", layout, 11)
    if btree == UNDEF:
        return out
    chunk_bytes = int(np.prod(chunk)) * dtype.itemsize
    for offset, nbytes, mask, addr in f.chunks(btree, rank):
        data = f.span(addr, nbytes)
        if filters and not mask & 1:
            data = lzf_decompress(data, chunk_bytes)
        elif len(data) != chunk_bytes:
            f.fail(f"a raw chunk of {len(data)} bytes (expected "
                   f"{chunk_bytes})")
        block = np.frombuffer(data, dtype).reshape(chunk)
        dst = tuple(slice(o, min(o + c, n))
                    for o, c, n in zip(offset, chunk, shape))
        out[dst] = block[tuple(slice(0, s.stop - s.start) for s in dst)]
    return out


def time_codec(repeats: int = 3, seed: int = 0) -> list:
    """Seconds to write and to read one full-size hand-off map [3, 240,
    320] and one SG tensor [84, 120, 160] of seeded uniform floats, each
    the least of ``repeats``; every round trip checked bit-equal.
    Returns [(name, shape, bytes, write s, read s)]."""
    import os
    import tempfile
    import time

    rng = np.random.default_rng(seed)
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "codec.h5")
        for name, shape in (("map", (3, 240, 320)),
                            ("SG tensor", (84, 120, 160))):
            arr = rng.random(shape, dtype=np.float32)
            times = [[], []]
            for _ in range(repeats):
                t0 = time.perf_counter()
                write(path, arr)
                t1 = time.perf_counter()
                back = read(path)
                times[0].append(t1 - t0)
                times[1].append(time.perf_counter() - t1)
                if not np.array_equal(back, arr):
                    raise AssertionError(f"the {name}'s round trip differs")
            out.append((name, shape, os.path.getsize(path), min(times[0]),
                        min(times[1])))
    return out


if __name__ == "__main__":
    # python -m inverserenderingofindoorscene_torch.utils.h5
    for name, shape, size, w, r in time_codec():
        print(f"{name} {shape} ({size} bytes): write {w:.4f} s, read "
              f"{r:.4f} s")
