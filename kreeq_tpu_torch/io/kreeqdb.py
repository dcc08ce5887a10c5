"""Reader/writer for `.kreeq` databases (phmap binary-archive format).

Counterpart of kreeq_tpu/io/kreeqdb.py: the same files, byte for byte.
A `.kreeq` DB is a directory with:
  /.index        two text lines: k, mapCount (reference:
                 src/kreeq-output.cpp:88-94; read src/input.cpp:56-74)
  /.map.N.bin    N in 0..mapCount-1, phmap dump of the u8 partition
                 (keys with key % mapCount == N)
  /.map.hc.bin   phmap dump of the u32 high-copy partition

phmap dump layout:
  u64 submap_count (256)
  per submap: u64 version (0xFFFFFFFFFFFFFFF5), u64 size, u64 capacity;
  if size > 0: ctrl bytes (capacity + 17: capacity ctrl + sentinel +
  16 clones), slots (capacity * slot_size), u64 growth_left.
  slot_size = 24 for u8 records (u64 key + DBGkmer{u8 fw[4],bw[4],cov}
  + 7 pad), 48 for u32 records (u64 key + DBGkmer32{u32 fw[4],bw[4],
  cov} + 4 pad).

The u8/u32 split follows the reference's overflow semantics: records
whose cov or any edge counter is >= 255 live in the u32 map with a
cov=255 tombstone in the u8 map (reference:
src/graph-builder.cpp:186-205).

Writes are placement-compatible with phmap: records sit at their
SwissTable probe positions (hash = phmap_mix of the identity
std::hash; submap = ((h>>8)^(h>>16)^(h>>24)) & 0xFF; slot via
find_first_non_full replay; ctrl = H2 bytes + sentinel + cloned
group-wrap bytes), so DBs written here load and probe correctly in the
reference binary via phmap_load's raw restore.

Everything here is host numpy on the files' u64 keys: hashing,
placement and `key % mapCount` work on u64, so keys cross to the port's
int64 form only at the KmerTable boundary (KmerTable.to_numpy on write;
on read the native loader biases them as it parses, after which the
rows are sorted on the table's device, or on the host for a table above
the device's row cap).
"""

from __future__ import annotations

import os
import struct
from typing import Tuple

import numpy as np
import torch

from ..constants import keys_from_u64, keys_to_u64
from ..core.table import MAP_COUNT, KmerTable, max_device_rows
from ..utils import log

PHMAP_VERSION = 0xFFFFFFFFFFFFFFF5
SUBMAP_COUNT = 256
SLOT_U8 = 24
SLOT_U32 = 48


def parse_phmap(data: bytes, slot_size: int):
    """Yield (key, value_bytes) from a phmap parallel-map dump."""
    off = 0
    if len(data) < 8:
        raise ValueError("corrupt phmap archive")
    (subcnt,) = struct.unpack_from("<Q", data, off)
    off += 8
    for _ in range(subcnt):
        if len(data) - off < 24:
            raise ValueError("corrupt phmap archive")
        ver, size, cap = struct.unpack_from("<QQQ", data, off)
        off += 24
        if ver != PHMAP_VERSION:
            raise ValueError(f"bad phmap version marker {ver:#x}")
        if size == 0:
            continue
        nctrl = cap + 17
        if len(data) - off < nctrl + cap * slot_size + 8:
            raise ValueError("corrupt phmap archive")
        ctrl = data[off:off + nctrl]
        off += nctrl
        for i in range(cap):
            if ctrl[i] & 0x80 == 0:  # full slot
                so = off + i * slot_size
                (key,) = struct.unpack_from("<Q", data, so)
                yield key, data[so + 8:so + slot_size]
        off += cap * slot_size + 8  # slots + growth_left
    if off != len(data):
        raise ValueError(f"trailing bytes in phmap dump: {off}/{len(data)}")


def read_index(db_path: str) -> Tuple[int, int]:
    with open(os.path.join(db_path, ".index")) as fh:
        k = int(fh.readline())
        line = fh.readline().strip()
        map_count = int(line) if line else MAP_COUNT
    return k, map_count


def _load_python(paths, hc_path):
    """native.load_db's result from the pure-Python archive parser."""
    keys, vals, tombstones, nbytes = [], [], [], 0
    for path in paths:
        with open(path, "rb") as fh:
            data = fh.read()
        nbytes += len(data)
        for key, vb in parse_phmap(data, SLOT_U8):
            if vb[8] == 255:  # the record lives in the hc map
                tombstones.append(key)
            else:
                keys.append(key)
                vals.append(vb[:9])
    hc_vals = []
    if hc_path:
        with open(hc_path, "rb") as fh:
            data = fh.read()
        nbytes += len(data)
        for key, vb in parse_phmap(data, SLOT_U32):
            keys.append(key)
            hc_vals.append(struct.unpack_from("<9I", vb))
    hc_vals = np.array(hc_vals, np.uint32).reshape(-1, 9)
    vals8 = np.frombuffer(b"".join(vals), np.uint8).reshape(-1, 9)
    vals8 = np.concatenate([vals8, np.zeros(hc_vals.shape, np.uint8)])
    return (keys_from_u64(np.array(keys, np.uint64)), vals8, hc_vals,
            keys_from_u64(np.array(tombstones, np.uint64)), nbytes)


def read_kreeq(db_path: str, device) -> KmerTable:
    """Load a `.kreeq` DB into a KmerTable probed on `device` (u8 +
    high-copy merged).  The rows are sorted by key on the device, or,
    above max_device_rows(device) rows, on the host, and the table then
    stays there (KmerTable.host_form).

    Spans: kq.db.parse (the index, and every map file read and parsed
    by native.load_db: keys biased, u8 counters, tombstones dropped;
    counters db.maps, db.bytes), kq.db.assemble (the tombstones checked
    against the hc map's keys; counters db.tombstones, db.rows), kq.db.upload (the keys' and the u8
    counters' copies, the sort, the gather and the widening, the hc
    map's counters placed; or the host form's widening, sort and
    pinning)."""
    from . import native_enabled
    from ..native import load_db

    with log.span("kq.db.parse"):
        k, map_count = read_index(db_path)
        present = set(os.listdir(db_path))  # one call, not a stat a file
        paths = [os.path.join(db_path, f".map.{m}.bin")
                 for m in range(map_count) if f".map.{m}.bin" in present]
        hc_path = (os.path.join(db_path, ".map.hc.bin")
                   if ".map.hc.bin" in present else None)
        loaded = load_db(paths, hc_path) if native_enabled() else None
        if loaded is None:
            loaded = _load_python(paths, hc_path)
        keys, vals8, hc_vals, tombstones, nbytes = loaded
        log.count("db.maps", len(paths) + (hc_path is not None))
        log.count("db.bytes", nbytes)
    with log.span("kq.db.assemble"):
        n, n8 = keys.shape[0], keys.shape[0] - hc_vals.shape[0]
        missing = np.setdiff1d(tombstones, keys[n8:])
        if missing.size:
            raise ValueError(
                f"int32 map missing 255 value from int8 map: key "
                f"{keys_to_u64(missing[:1])[0]}")
        log.count("db.tombstones", tombstones.shape[0])
        log.count("db.rows", n)
    with log.span("kq.db.upload"):
        # keys are unique, so any sort order of them is the table's order
        if n > max_device_rows(device):
            vals = vals8.astype(np.uint32)
            vals[n8:] = hc_vals
            keys, order = torch.sort(torch.from_numpy(keys))
            vals = vals[order.numpy()]
            return KmerTable.host_form(k, keys.numpy(), vals[:, 8],
                                       vals[:, 0:4], vals[:, 4:8], device)
        # the u8 counters cross (9 B a row), are gathered by the sort
        # order and widened there; the hc rows' exact counters then go
        # to their places
        keys = torch.from_numpy(keys).to(device)
        skeys, order = torch.sort(keys)
        hc_at = torch.searchsorted(skeys, keys[n8:])
        del keys
        rows = torch.from_numpy(vals8).to(device)[order]
        del order
        cov, fw, bw = (rows[:, c].to(torch.int64).contiguous()
                       for c in (8, slice(0, 4), slice(4, 8)))
        del rows
        if n > n8:
            hc = torch.from_numpy(hc_vals.view(np.int32)).to(device)
            hc = hc.to(torch.int64) & 0xFFFFFFFF
            cov[hc_at] = hc[:, 8]
            fw[hc_at] = hc[:, 0:4]
            bw[hc_at] = hc[:, 4:8]
        return KmerTable(k, skeys, cov, fw, bw)


_MIX_MULT = 0xde5fb9d2630458e9  # phmap_mix<8> multiplier


def phmap_mix(keys: np.ndarray) -> np.ndarray:
    """phmap's hash post-mix: hi+lo of the 128-bit product of
    std::hash(key) (identity for u64 on libstdc++) with the phmap_mix
    multiplier."""
    k = np.asarray(keys, np.uint64)
    a = k >> np.uint64(32)
    b = k & np.uint64(0xFFFFFFFF)
    mc = np.uint64(_MIX_MULT >> 32)
    md = np.uint64(_MIX_MULT & 0xFFFFFFFF)
    bd = b * md
    mid1 = a * md + (bd >> np.uint64(32))
    mid2 = b * mc + (mid1 & np.uint64(0xFFFFFFFF))
    hi = a * mc + (mid1 >> np.uint64(32)) + (mid2 >> np.uint64(32))
    lo = (mid2 << np.uint64(32)) | (bd & np.uint64(0xFFFFFFFF))
    return hi + lo  # u64 wraparound


def phmap_subidx(h: np.ndarray) -> np.ndarray:
    """Submap index for 256 submaps: ((h>>8)^(h>>16)^(h>>24)) & 0xFF."""
    h = np.asarray(h, np.uint64)
    return ((h >> np.uint64(8)) ^ (h >> np.uint64(16))
            ^ (h >> np.uint64(24))) & np.uint64(0xFF)


def _place_python(hs: np.ndarray, cap: int) -> np.ndarray:
    """find_first_non_full replay (fallback; native kn_phmap_place
    preferred): group-of-16 triangular probing over a 2^n-1 table."""
    ctrl = np.full(cap + 1, 0x80, np.uint8)
    ctrl[cap] = 0xFF  # sentinel
    pos = np.empty(len(hs), np.uint32)
    for idx, h in enumerate(hs):
        h = int(h)
        offset = (h >> 7) & cap
        index = 0
        found = -1
        while found < 0:
            for j in range(16):
                p = (offset + j) & cap
                if ctrl[p] == 0x80:
                    found = p
                    break
            index += 16
            offset = (offset + index) & cap
        ctrl[found] = h & 0x7F
        pos[idx] = found
    return pos


def _write_phmap(path: str, keys: np.ndarray, recs: np.ndarray,
                 slot_size: int) -> None:
    """Write a phmap binary archive with true SwissTable placement.

    phmap_load restores ctrl/slots raw, so find() in the loading
    process probes from H1 = mix(key)>>7; records are therefore placed
    by replaying find_first_non_full.  keys: u64[n]; recs: u8[n,9] or
    u32[n,9].
    """
    from ..native import phmap_place

    h_all = phmap_mix(keys)
    sub_of = phmap_subidx(h_all).astype(np.int32)
    order = np.argsort(sub_of, kind="stable")
    keys = keys[order]
    recs = recs[order]
    h_all = h_all[order]
    bounds = np.searchsorted(sub_of[order], np.arange(SUBMAP_COUNT + 1))

    rec_dtype = "u1" if slot_size == SLOT_U8 else "<u4"
    pad = slot_size - 8 - recs.shape[1] * recs.dtype.itemsize
    slot_t = np.dtype([("key", "<u8"), ("rec", rec_dtype, 9),
                       ("pad", "u1", pad)])

    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", SUBMAP_COUNT))
        for s in range(SUBMAP_COUNT):
            lo, hi = int(bounds[s]), int(bounds[s + 1])
            size = hi - lo
            if size == 0:
                fh.write(struct.pack("<QQQ", PHMAP_VERSION, 0, 0))
                continue
            cap = 1
            while cap - cap // 8 < size:  # CapacityToGrowth(cap) >= size
                cap = cap * 2 + 1
            fh.write(struct.pack("<QQQ", PHMAP_VERSION, size, cap))
            hs = h_all[lo:hi]
            pos = phmap_place(hs, cap)
            if pos is None:
                pos = _place_python(hs, cap)
            pos64 = pos.astype(np.int64)
            ctrl = np.full(cap + 17, 0x80, np.uint8)
            ctrl[cap] = 0xFF  # sentinel
            ctrl[cap + 16] = 0  # last byte never group-read; phmap leaves 0
            h2 = (hs & np.uint64(0x7F)).astype(np.uint8)
            ctrl[pos64] = h2
            # SetCtrl clone mirror: ((i-15)&cap) + (15&cap)
            clone = ((pos64 - 15) & cap) + (15 & cap)
            ctrl[clone] = h2
            slots = np.zeros(cap, slot_t)
            slots["key"][pos64] = keys[lo:hi]
            slots["rec"][pos64] = recs[lo:hi]
            fh.write(ctrl.tobytes())
            fh.write(slots.tobytes())
            fh.write(struct.pack("<Q", cap - cap // 8 - size))


def write_kreeq(db_path: str, table: KmerTable,
                map_count: int = MAP_COUNT) -> None:
    """Write a KmerTable as a `.kreeq` DB directory."""
    os.makedirs(db_path, exist_ok=True)
    with open(os.path.join(db_path, ".index"), "w") as fh:
        fh.write(f"{table.k}\n{map_count}\n")

    keys, cov, fw, bw = table.to_numpy()
    overflow = (cov >= 255) | (fw >= 255).any(axis=1) | (bw >= 255).any(
        axis=1)

    # u8 records: exact where all counters fit; tombstones (cov=255,
    # counters clipped) where the full record lives in the hc map
    recs8 = np.concatenate(
        [np.minimum(fw, 254), np.minimum(bw, 254), cov[:, None]],
        axis=1).astype(np.uint8)
    recs8[overflow, 8] = 255

    # one stable sort by partition instead of a mask per partition:
    # each partition keeps its rows in key order, as the masks would
    part = (keys % np.uint64(map_count)).astype(np.int64)
    order = np.argsort(part, kind="stable")
    bounds = np.searchsorted(part[order], np.arange(map_count + 1))
    for m in range(map_count):
        sel = order[bounds[m]:bounds[m + 1]]
        _write_phmap(os.path.join(db_path, f".map.{m}.bin"), keys[sel],
                     recs8[sel], SLOT_U8)

    hc = np.nonzero(overflow)[0]
    recs32 = np.concatenate([fw[hc], bw[hc], cov[hc, None]],
                            axis=1).astype(np.uint32)
    _write_phmap(os.path.join(db_path, ".map.hc.bin"), keys[hc], recs32,
                 SLOT_U32)
