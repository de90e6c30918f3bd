"""Segmented write-ahead log.

Host-side durability layer mirroring the reference WAL semantics
(/root/reference/internal/wal/wal.go, record.go:53-60):
- records = (type, tag, entity, txid, body) with a checksum, appended to
  fixed-max-size segment files; LSN = global byte offset (record.go:37-39)
- record types insert/update/delete/commit/abort/checkpoint (record.go:12-22)
- reader with entity filter + seek; GC drops whole segments below a
  checkpoint watermark (wal.go:375)
- damage policies on recovery: fail | skip | truncate | ignore
  (wal.go:33-40; ignore delivers checksum-damaged-but-parseable records,
  reader.go:271-279)

The engine keeps ALL device-side state reconstructible from (sealed
segments + WAL): the journal is recovered from the WAL on open, never
flushed itself (reference makes the same write-amplification choice,
internal/pack/table/insert.go:26-43).
"""

from __future__ import annotations

import enum
import os
import struct
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

__all__ = ["RecordType", "Record", "Wal", "WalError", "RecoveryMode"]

_HDR = struct.Struct("<BBIQI I")   # type, tag, entity, txid, body_len, crc
_SEG_NAME = "wal_{:08x}.seg"
_DEFAULT_SEG_BYTES = 16 << 20


class RecordType(enum.IntEnum):
    INVALID = 0
    INSERT = 1
    UPDATE = 2
    DELETE = 3
    COMMIT = 4
    ABORT = 5
    CHECKPOINT = 6


class RecoveryMode(enum.IntEnum):
    FAIL = 0
    SKIP = 1
    TRUNCATE = 2
    IGNORE = 3


class WalError(Exception):
    pass


@dataclass
class Record:
    type: RecordType
    entity: int = 0            # table/catalog object id
    txid: int = 0
    data: bytes = b""
    tag: int = 0
    lsn: int = -1              # filled on write/read

    def encode(self) -> bytes:
        crc = zlib.crc32(self.data)
        hdr = _HDR.pack(self.type, self.tag, self.entity, self.txid,
                        len(self.data), crc)
        return hdr + self.data


def _resync(fh, start: int):
    """Scan forward from `start` for the next plausible record boundary:
    a header whose type is legal and whose body crc32 verifies. The crc
    check makes a false positive on arbitrary damage bytes vanishingly
    unlikely; segments are bounded (16 MiB default) so the one-shot tail
    read is cheap. Returns the absolute offset or None."""
    fh.seek(start)
    buf = fh.read()
    hs = _HDR.size
    for i in range(len(buf) - hs + 1):
        rt = buf[i]
        if rt == 0 or rt > 6:
            continue
        _, _, _, _, blen, crc = _HDR.unpack_from(buf, i)
        if blen > len(buf) - i - hs:
            continue
        if zlib.crc32(buf[i + hs:i + hs + blen]) == crc:
            return start + i
    return None


class SyncFuture:
    """Resolves when the WAL has fsynced past a target LSN (reference
    pkg/util/future.go used by the delayed-sync commit path)."""

    def __init__(self, wal: "Wal", lsn: int):
        self._wal = wal
        self._lsn = lsn

    def done(self) -> bool:
        return self._wal.synced_lsn >= self._lsn

    def wait(self, timeout: float | None = None) -> bool:
        import time as _t
        deadline = None if timeout is None else _t.monotonic() + timeout
        while not self.done():
            self._wal._flush_event.wait(0.005)
            self._wal._flush_event.clear()
            if deadline is not None and _t.monotonic() > deadline:
                return self.done()
        return True


class Wal:
    """Append-only segmented log. Single writer; readers independent.

    sync modes (reference wal.go delayed-sync thread, tx.go:345-371
    commit modes): 'sync' fsyncs on write_and_sync; 'delay' batches
    fsyncs on a background thread (group commit — write() returns a
    SyncFuture via write_delayed); 'nosync' leaves flushing to the OS."""

    def __init__(self, path: str | Path, max_segment: int = _DEFAULT_SEG_BYTES,
                 sync: str = "sync", flush_interval: float = 0.01):
        import threading
        self.dir = Path(path)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.max_segment = max_segment
        self.sync_mode = sync
        self.synced_lsn = 0
        self._flush_event = threading.Event()
        # RLock: write_delayed/sync take it around write(); write() itself
        # locks so a user commit and merge workers never interleave records
        self._wlock = threading.RLock()
        self._stop_flusher = False
        self._segments = self._discover()
        if not self._segments:
            self._segments = [0]
            self._open_segment(0, truncate=True)
        else:
            self._open_segment(self._segments[-1])
        self._flusher = None
        if sync == "delay":
            self._flusher = threading.Thread(
                target=self._flush_loop, args=(flush_interval,), daemon=True)
            self._flusher.start()

    def _flush_loop(self, interval: float) -> None:
        import time as _t
        while not self._stop_flusher:
            _t.sleep(interval)
            try:
                with self._wlock:
                    if self._fh is None:
                        return
                    target = self.tail_lsn
                    self._fh.flush()
                    os.fsync(self._fh.fileno())
                self.synced_lsn = target
                self._flush_event.set()
            except Exception:
                pass

    def write_delayed(self, rec: Record) -> "SyncFuture":
        """Append and return a future resolving at the next group fsync."""
        with self._wlock:
            lsn = self.write(rec)
            end = self.tail_lsn
        return SyncFuture(self, end)

    # ------------------------------------------------------------- write --

    def write(self, rec: Record) -> int:
        buf = rec.encode()
        with self._wlock:
            if self._fh.tell() + len(buf) > self.max_segment:
                self._rotate()
            rec.lsn = self._seg_base + self._fh.tell()
            self._fh.write(buf)
            return rec.lsn

    def write_and_sync(self, rec: Record) -> int:
        with self._wlock:
            lsn = self.write(rec)
            self.sync()
        return lsn

    def sync(self) -> None:
        with self._wlock:
            target = self.tail_lsn
            self._fh.flush()
            os.fsync(self._fh.fileno())
        self.synced_lsn = max(self.synced_lsn, target)
        self._flush_event.set()

    @property
    def tail_lsn(self) -> int:
        return self._seg_base + self._fh.tell()

    def close(self) -> None:
        self._stop_flusher = True
        if self._flusher is not None:
            self._flusher.join(timeout=1.0)
        if getattr(self, "_fh", None):
            self._fh.flush()
            self._fh.close()
            self._fh = None

    # -------------------------------------------------------------- read --

    def records(self, from_lsn: int = 0, entity: int | None = None,
                mode: RecoveryMode = RecoveryMode.FAIL) -> Iterator[Record]:
        self._fh.flush()
        for base in self._segments:
            seg_path = self.dir / _SEG_NAME.format(base)
            size = seg_path.stat().st_size
            if base + size <= from_lsn:
                continue
            with open(seg_path, "rb") as fh:
                off = 0
                if from_lsn > base:
                    off = from_lsn - base
                    fh.seek(off)
                while True:
                    pos = fh.tell()
                    hdr = fh.read(_HDR.size)
                    if not hdr:
                        break
                    if len(hdr) < _HDR.size:
                        self._damaged(seg_path, pos, mode, "short header")
                        break
                    rt, tag, ent, txid, blen, crc = _HDR.unpack(hdr)
                    body = fh.read(blen)
                    if len(body) < blen or zlib.crc32(body) != crc or \
                            rt == 0 or rt > 6:
                        if mode == RecoveryMode.IGNORE and \
                                len(body) == blen and 1 <= rt <= 6:
                            # reference ignore mode (reader.go:271-279):
                            # a structurally-plausible record with a bad
                            # checksum is DELIVERED anyway and reading
                            # continues; only structural damage (short
                            # body/header, illegal type) stops the
                            # segment (wal.go:640 tryRecover -> nil)
                            if entity is None or ent == entity:
                                yield Record(RecordType(rt), ent, txid,
                                             body, tag, lsn=base + pos)
                            continue
                        if mode == RecoveryMode.SKIP:
                            # true record-level repair (reference
                            # wal.go:33-40 skip mode): resync to the next
                            # crc-valid record instead of abandoning the
                            # rest of the segment
                            nxt = _resync(fh, pos + 1)
                            if nxt is None:
                                break
                            fh.seek(nxt)
                            continue
                        self._damaged(seg_path, pos, mode, "bad record")
                        break
                    if entity is not None and ent != entity:
                        continue
                    yield Record(RecordType(rt), ent, txid, body, tag,
                                 lsn=base + pos)

    def _damaged(self, seg_path: Path, pos: int, mode: RecoveryMode,
                 why: str) -> None:
        if mode == RecoveryMode.FAIL:
            raise WalError(f"{seg_path.name}@{pos}: {why}")
        if mode == RecoveryMode.TRUNCATE:
            active = seg_path == self.dir / _SEG_NAME.format(self._seg_base)
            with self._wlock:
                if active and self._fh is not None:
                    # the append handle was positioned at the PRE-truncate
                    # EOF; leaving it stale skews every subsequent LSN
                    # (write() assigns base + tell()) and a later
                    # from_lsn seek then lands mid-record and truncates
                    # GOOD tail records — acked-data loss (found by the
                    # DST tear scenario, seed 57)
                    self._fh.close()
                    with open(seg_path, "r+b") as fh:
                        fh.truncate(pos)
                    self._fh = open(seg_path, "ab")
                else:
                    with open(seg_path, "r+b") as fh:
                        fh.truncate(pos)
        # SKIP/IGNORE: stop reading this segment silently

    # ---------------------------------------------------------------- gc --

    def gc(self, watermark_lsn: int) -> int:
        """Drop whole segments entirely below the watermark. Returns the
        number of segments removed."""
        removed = 0
        while len(self._segments) > 1:
            base, nxt = self._segments[0], self._segments[1]
            if nxt <= watermark_lsn:
                (self.dir / _SEG_NAME.format(base)).unlink(missing_ok=True)
                self._segments.pop(0)
                removed += 1
            else:
                break
        return removed

    # ------------------------------------------------------------ intern --

    def _discover(self) -> list[int]:
        segs = []
        for p in sorted(self.dir.glob("wal_*.seg")):
            segs.append(int(p.stem.split("_")[1], 16))
        return segs

    def _open_segment(self, base: int, truncate: bool = False) -> None:
        path = self.dir / _SEG_NAME.format(base)
        self._fh = open(path, "wb" if truncate else "ab")
        self._seg_base = base

    def _rotate(self) -> None:
        end = self._seg_base + self._fh.tell()
        self._fh.flush()
        os.fsync(self._fh.fileno())
        self._fh.close()
        self._segments.append(end)
        self._open_segment(end, truncate=True)
