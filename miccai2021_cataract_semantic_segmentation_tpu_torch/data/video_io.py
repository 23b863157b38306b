"""Video container I/O of the port: the counterpart of the JAX package's
cv2 capture and writer calls (its data/dataset.py and train/video.py).

`open_reader(path)` sniffs the container from the file's first bytes, not
from its name. An uncompressed 24-bit AVI (BI_RGB, the file `AviWriter`
writes) is decoded here with numpy: each frame's offset comes from the
OpenDML index (`indx` and its `ix00` chunks) or from `idx1`, and a read is
one `os.pread`, so readers on several threads share one handle. Any other
file goes to cv2 where cv2 imports (its capture behind a lock, the frame
count probed as the JAX package probes it, unless the caller passes the
count it has probed already); without cv2 it raises IOError naming the
file, the container and the fourcc. A reader never returns a blank frame:
a frame it cannot read raises.

`open_writer(path, fps, (w, h))` writes XVID through cv2 where cv2 imports,
as the JAX package does, else the port's own AVI: frames stored top-down
as BGR rows padded to 4 bytes (biHeight < 0; cv2's FFmpeg capture reads a
bottom-up DIB through a negative row stride and corrupts its heap). An AVI
1.0 RIFF holds about 1 GB (`RIFF_LIMIT`), 690 raw 540x960 frames, so a
longer video goes on in OpenDML `AVIX` segments, each with its `ix00`
index, listed by an `indx` super-index written into the space the header
reserves (256 segments). Writers take RGB frames and record the codec they
used (`writer.codec`; `WRITERS` counts the writers opened by codec and
`READERS` the readers by decoder), so that a run can say which path it
took.
"""
from __future__ import annotations

import os
import pathlib
import struct
import threading

import numpy as np

try:
    import cv2
except ImportError:      # without cv2 the port's own AVI serves
    cv2 = None

RIFF_LIMIT = 1 << 30             # bytes of one RIFF segment (AVI 1.0's reach)
SUPER_ENTRIES = 256              # segments the reserved `indx` space lists
_SUPER_BYTES = 24 + 16 * SUPER_ENTRIES
_KEYFRAME = 0x10

# writers and readers opened since import, by codec
WRITERS = {"xvid": 0, "avi_raw": 0}
READERS = {"avi_raw": 0, "cv2": 0}


def sniff(head: bytes) -> str:
    """The container named by a file's first 12 bytes."""
    if head[:4] == b"RIFF" and head[8:12] == b"AVI ":
        return "avi"
    if head[4:8] == b"ftyp":
        return "mp4"
    if head[:4] == b"\x1a\x45\xdf\xa3":
        return "matroska"
    return "unknown"


def _fourcc(raw: bytes) -> str:
    return raw.decode("latin-1") if any(raw) else "0"


class _Unsupported(Exception):
    """An AVI whose video stream the port does not decode itself."""

    def __init__(self, fourcc: str):
        super().__init__(fourcc)
        self.fourcc = fourcc


class AviReader:
    """Frames of an uncompressed 24-bit AVI (BI_RGB), read with `os.pread`.

    `frame_count` counts the indexed frames whose bytes lie in the file (a
    truncated file loses its tail, as a probe would), `shape` is (h, w) and
    `read(i)` returns frame i as RGB uint8 (h, w, 3)."""

    codec = "avi_raw"

    def __init__(self, path):
        self.path = str(path)
        self._fd = os.open(self.path, os.O_RDONLY)
        try:
            self._parse()
        except BaseException:
            os.close(self._fd)
            raise

    def _read(self, offset: int, n: int) -> bytes:
        data = os.pread(self._fd, n, offset)
        if len(data) != n:
            raise IOError(f"{self.path}: truncated at byte {offset + len(data)}")
        return data

    def _chunks(self, start: int, end: int):
        """(fourcc, data offset, size[, list type]) of the chunks in [start, end)."""
        pos = start
        while pos + 8 <= end:
            fcc, size = struct.unpack("<4sI", self._read(pos, 8))
            if fcc in (b"LIST", b"RIFF"):
                yield fcc, pos + 12, size - 4, self._read(pos + 8, 4)
            else:
                yield fcc, pos + 8, size, None
            pos += 8 + size + (size & 1)

    def _parse(self) -> None:
        file_size = os.fstat(self._fd).st_size
        head = self._read(0, 12)
        if sniff(head) != "avi":
            raise _Unsupported("?")
        riff_end = min(8 + struct.unpack("<I", head[4:8])[0], file_size)
        strh = strf = indx = None
        movi = idx1 = None
        for fcc, off, size, kind in self._chunks(12, riff_end):
            if fcc == b"LIST" and kind == b"hdrl":
                for f2, o2, s2, k2 in self._chunks(off, off + size):
                    if f2 == b"LIST" and k2 == b"strl" and strh is None:
                        for f3, o3, s3, _ in self._chunks(o2, o2 + s2):
                            if f3 == b"strh":
                                strh = self._read(o3, min(s3, 56))
                            elif f3 == b"strf":
                                strf = self._read(o3, min(s3, 40))
                            elif f3 == b"indx":
                                indx = (o3, s3)
            elif fcc == b"LIST" and kind == b"movi":
                movi = off - 4               # the 'movi' fourcc idx1 counts from
            elif fcc == b"idx1":
                idx1 = (off, size)
        if strh is None or strf is None or strh[:4] != b"vids":
            raise _Unsupported("?")
        _, w, h, _, bits, compression = struct.unpack("<IiiHHI", strf[:20])
        handler = strh[4:8]
        if bits != 24 or compression != 0:
            raise _Unsupported(_fourcc(struct.pack("<I", compression))
                               if compression else f"{_fourcc(handler)} ({bits} bit)")
        self.shape = (abs(h), w)
        self._top_down = h < 0
        self._stride = (w * 3 + 3) & ~3
        self._frame_bytes = self._stride * abs(h)
        offsets = self._super_index(indx) if indx is not None else \
            self._old_index(idx1, movi) if idx1 is not None else self._walk(movi, riff_end)
        self._offsets = np.asarray(
            [o for o, n in offsets if n == self._frame_bytes
             and o + n <= file_size], np.int64)
        self.frame_count = len(self._offsets)

    def _super_index(self, indx) -> list:
        off, size = indx
        per, _, kind, n_used, _ = struct.unpack("<HBBI4s", self._read(off, 12))
        if per != 4 or kind != 0:
            raise IOError(f"{self.path}: unsupported OpenDML super-index")
        out = []
        for k in range(n_used):
            q_off, _, _ = struct.unpack("<QII", self._read(off + 24 + 16 * k, 16))
            fcc, _ = struct.unpack("<4sI", self._read(q_off, 8))
            per2, _, kind2, n2, _, base = struct.unpack("<HBBI4sQ", self._read(q_off + 8, 20))
            if per2 != 2 or kind2 != 1:
                raise IOError(f"{self.path}: unsupported OpenDML index {fcc!r}")
            ent = np.frombuffer(self._read(q_off + 32, 8 * n2), "<u4").reshape(n2, 2)
            out.extend((base + int(o), int(s & 0x7FFFFFFF)) for o, s in ent)
        return out

    def _old_index(self, idx1, movi) -> list:
        """(data offset, size) of the frames `idx1` lists; its offsets count
        from the 'movi' fourcc."""
        if movi is None:
            return []
        off, size = idx1
        ent = np.frombuffer(self._read(off, size - size % 16), np.uint8).reshape(-1, 16)
        ids = ent[:, :4].tobytes()
        vals = ent[:, 4:].copy().view("<u4").reshape(-1, 3)
        return [(movi + int(vals[k, 1]) + 8, int(vals[k, 2])) for k in range(len(ent))
                if ids[4 * k:4 * k + 4] in (b"00db", b"00dc")]

    def _walk(self, movi, riff_end) -> list:
        if movi is None:
            return []
        list_size = struct.unpack("<I", self._read(movi - 4, 4))[0]
        return [(off, size) for fcc, off, size, _ in
                self._chunks(movi + 4, min(movi + list_size, riff_end))
                if fcc in (b"00db", b"00dc")]

    def read(self, i: int) -> np.ndarray:
        if not 0 <= i < self.frame_count:
            raise IOError(f"frame {i} of {self.path} is out of its "
                          f"{self.frame_count} frames")
        h, w = self.shape
        raw = np.frombuffer(self._read(int(self._offsets[i]), self._frame_bytes),
                            np.uint8).reshape(h, self._stride)[:, :3 * w]
        rgb = raw.reshape(h, w, 3)[..., ::-1]
        if not self._top_down:
            rgb = rgb[::-1]
        return np.ascontiguousarray(rgb)

    def close(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1

    def __del__(self):
        try:
            self.close()
        except Exception:        # noqa: BLE001 - interpreter shutdown
            pass


def probed_frame_count(cap) -> int:
    """Decodable frame count of an open cv2 capture: container metadata can
    over-report the count, so the advertised tail is walked back until a
    frame decodes (the JAX package's data/dataset.py)."""
    c = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    while c > 0:
        cap.set(cv2.CAP_PROP_POS_FRAMES, c - 1)
        if cap.read()[0]:
            break
        c -= 1
    return c


class Cv2Reader:
    """A cv2 capture with AviReader's interface: seek and read under one
    lock (a capture is stateful), BGR -> RGB. The frame count is probed
    (a seek to the tail and decodes) unless `frame_count` gives it."""

    codec = "cv2"

    def __init__(self, path, frame_count: int | None = None):
        self.path = str(path)
        self._cap = cv2.VideoCapture(self.path)
        if not self._cap.isOpened():
            raise IOError(f"cv2 cannot open {self.path}")
        self.frame_count = probed_frame_count(self._cap) if frame_count is None \
            else int(frame_count)
        self.shape = (int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
                      int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH)))
        self._lock = threading.Lock()

    def read(self, i: int) -> np.ndarray:
        with self._lock:
            if int(self._cap.get(cv2.CAP_PROP_POS_FRAMES)) != i:
                self._cap.set(cv2.CAP_PROP_POS_FRAMES, i)
            ok, frame = self._cap.read()
        if not ok:
            raise IOError(f"failed to read frame {i} of {self.path}")
        return np.ascontiguousarray(frame[..., ::-1])

    def close(self) -> None:
        self._cap.release()


def open_reader(path, frame_count: int | None = None):
    """A reader of the video at `path` (see the module's docstring).
    `frame_count`, the decodable count a caller has probed already, spares
    a cv2 capture its tail probe; the port's AVI counts its frames from its
    index, which reads no frame, and ignores it."""
    path = str(path)
    with open(path, "rb") as f:
        head = f.read(12)
    container, fourcc = sniff(head), "?"
    if container == "avi":
        try:
            reader = AviReader(path)
            READERS["avi_raw"] += 1
            return reader
        except _Unsupported as exc:
            fourcc = exc.fourcc
    if cv2 is not None:
        reader = Cv2Reader(path, frame_count)
        READERS["cv2"] += 1
        return reader
    raise IOError(f"cannot decode {path}: container {container}, fourcc {fourcc}; "
                  "the port decodes uncompressed 24-bit AVI itself and other "
                  "files only through cv2, which is not installed")


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _chunk_header(fcc: bytes, size: int) -> bytes:
    return fcc + struct.pack("<I", size)


class AviWriter:
    """Uncompressed 24-bit AVI, top-down BGR rows padded to 4 bytes;
    `write(rgb)` takes an (h, w, 3) uint8 RGB frame. Past `riff_limit`
    bytes a segment closes and an OpenDML `AVIX` segment starts."""

    codec = "avi_raw"

    def __init__(self, path, fps: float, size_wh: tuple[int, int],
                 riff_limit: int = RIFF_LIMIT):
        self.path = str(path)
        self.w, self.h = (int(v) for v in size_wh)
        self.fps = float(fps)
        self.riff_limit = int(riff_limit)
        self._stride = (self.w * 3 + 3) & ~3
        self._frame_bytes = self._stride * self.h
        self._f = open(self.path, "wb")
        self.frames = 0
        self._segments: list[tuple[int, int, int]] = []   # (ix00 offset, size, frames)
        self._first_frames = 0
        self._begin_first()

    # The first RIFF: header, then the 'movi' list; `_patch` rewrites the
    # counts and sizes at close.
    def _headers(self) -> bytes:
        rate_us = int(round(1e6 / self.fps))
        fps_num, fps_den = (int(round(self.fps * 1000)), 1000)
        avih = struct.pack("<14I", rate_us, int(self._frame_bytes * self.fps), 0,
                           _KEYFRAME, self._first_frames, 0, 1, self._frame_bytes,
                           self.w, self.h, 0, 0, 0, 0)
        strh = b"vids" + b"\0\0\0\0" + struct.pack(
            "<IHHIIIIIIIIhhhh", 0, 0, 0, 0, fps_den, fps_num, 0, self.frames,
            self._frame_bytes, 0xFFFFFFFF, 0, 0, 0, self.w, self.h)
        strf = struct.pack("<IiiHHIIiiII", 40, self.w, -self.h, 1, 24, 0,
                           self._frame_bytes, 0, 0, 0, 0)
        if len(self._segments) > 1:
            sup = struct.pack("<HBBI4s12x", 4, 0, 0, len(self._segments), b"00db")
            sup += b"".join(struct.pack("<QII", o, s, n) for o, s, n in self._segments)
            index = _chunk_header(b"indx", _SUPER_BYTES) + sup.ljust(_SUPER_BYTES, b"\0")
        else:
            index = _chunk_header(b"JUNK", _SUPER_BYTES) + bytes(_SUPER_BYTES)
        strl = b"strl" + _chunk_header(b"strh", 56) + strh + \
            _chunk_header(b"strf", 40) + strf + index
        hdrl = b"hdrl" + _chunk_header(b"avih", 56) + avih + \
            _chunk_header(b"LIST", len(strl)) + strl
        return _chunk_header(b"LIST", len(hdrl)) + hdrl

    def _begin_first(self) -> None:
        self._f.write(b"RIFF\0\0\0\0AVI ")
        self._f.write(self._headers())
        self._begin_movi(riff_start=0)

    def _begin_movi(self, riff_start: int) -> None:
        self._riff_start = riff_start
        self._movi = self._f.tell()                     # the 'LIST' of movi
        self._f.write(b"LIST\0\0\0\0movi")
        self._entries: list[tuple[int, int]] = []       # (data offset, size)

    def _segment_bytes(self, n_frames: int) -> int:
        """Bytes of the current RIFF once it holds `n_frames` frames and
        its indexes."""
        first = not self._segments
        body = self._movi - self._riff_start + 12 + n_frames * (8 + self._frame_bytes)
        ix00 = 8 + 24 + 8 * n_frames
        idx1 = 8 + 16 * n_frames if first else 0
        return body + ix00 + idx1

    def write(self, rgb: np.ndarray) -> None:
        rgb = np.asarray(rgb)
        if rgb.shape != (self.h, self.w, 3) or rgb.dtype != np.uint8:
            raise ValueError(f"{self.path}: a frame of {(self.h, self.w, 3)} uint8 "
                             f"expected, got {rgb.shape} {rgb.dtype}")
        if self._segment_bytes(len(self._entries) + 1) > self.riff_limit:
            if not self._entries:
                raise IOError(f"{self.path}: one frame outgrows the RIFF limit "
                              f"of {self.riff_limit} bytes")
            self._close_segment(last=False)
            if len(self._segments) >= SUPER_ENTRIES:
                raise IOError(f"{self.path}: {SUPER_ENTRIES} RIFF segments of "
                              f"{self.riff_limit} bytes are full")
            start = self._f.tell()
            self._f.write(b"RIFF\0\0\0\0AVIX")
            self._begin_movi(riff_start=start)
        rows = np.zeros((self.h, self._stride), np.uint8)
        rows[:, :3 * self.w] = rgb[..., ::-1].reshape(self.h, 3 * self.w)
        self._f.write(_chunk_header(b"00db", self._frame_bytes))
        self._entries.append((self._f.tell(), self._frame_bytes))
        self._f.write(rows.tobytes())
        self.frames += 1

    def _close_segment(self, last: bool) -> None:
        """The segment's `ix00` at the end of its movi (not in a file of
        one segment, which stays AVI 1.0), `idx1` after the first movi,
        and the sizes of the movi list and the RIFF."""
        base = self._movi
        ix_off = self._f.tell()
        n = len(self._entries)
        ix = struct.pack("<HBBI4sQI", 2, 0, 1, n, b"00db", base, 0)
        ix += np.asarray([(o - base, s) for o, s in self._entries],
                         "<u4").reshape(-1, 2).tobytes()
        if not (last and not self._segments):
            self._f.write(_chunk_header(b"ix00", len(ix)) + ix)
        movi_end = self._f.tell()
        if not self._segments:
            self._first_frames = n
            idx = np.zeros(n, dtype=[("id", "S4"), ("flags", "<u4"),
                                     ("off", "<u4"), ("size", "<u4")])
            idx["id"] = b"00db"
            idx["flags"] = _KEYFRAME
            idx["off"] = [o - 8 - (base + 8) for o, _ in self._entries]
            idx["size"] = [s for _, s in self._entries]
            self._f.write(_chunk_header(b"idx1", 16 * n) + idx.tobytes())
        end = self._f.tell()
        self._segments.append((ix_off, 8 + len(ix), n))
        self._f.seek(self._movi + 4)
        self._f.write(struct.pack("<I", movi_end - self._movi - 8))
        self._f.seek(self._riff_start + 4)
        self._f.write(struct.pack("<I", end - self._riff_start - 8))
        self._f.seek(end)

    def release(self) -> None:
        if self._f is None:
            return
        self._close_segment(last=True)
        end = self._f.tell()
        self._f.seek(12)
        self._f.write(self._headers())           # the counts and the index
        self._f.seek(end)
        self._f.close()
        self._f = None


class Cv2XvidWriter:
    """XVID through cv2.VideoWriter, as the JAX package's train/video.py
    writes; `write(rgb)` converts to BGR."""

    codec = "xvid"

    def __init__(self, path, fps: float, size_wh: tuple[int, int]):
        self.path = str(path)
        self._w = cv2.VideoWriter(self.path, cv2.VideoWriter_fourcc(*"XVID"), fps,
                                  tuple(size_wh))
        if not self._w.isOpened():
            raise IOError(f"cv2 cannot open an XVID writer on {self.path}")
        self.frames = 0

    def write(self, rgb: np.ndarray) -> None:
        self._w.write(cv2.cvtColor(np.ascontiguousarray(rgb), cv2.COLOR_RGB2BGR))
        self.frames += 1

    def release(self) -> None:
        self._w.release()


def open_writer(path, fps: float, size_wh: tuple[int, int]):
    """XVID through cv2 where cv2 imports, else the port's own AVI."""
    pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
    if cv2 is not None:
        writer = Cv2XvidWriter(path, fps, size_wh)
        WRITERS["xvid"] += 1
    else:
        writer = AviWriter(path, fps, size_wh)
        WRITERS["avi_raw"] += 1
    return writer
