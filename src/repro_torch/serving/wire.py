"""Binary wire protocol for the evaluation hot path — stdlib + numpy only.

The paper's deployed-kernel economics die on a JSON wire: ``tolist()``-ing
a 10⁵–10⁶-point coordinate block and re-parsing it client-side costs far
more than the launch that computed it.  This module frames numpy arrays as
raw little-endian bytes with a small JSON metadata header, so the server
serializes with ``ndarray.tobytes()`` and the client rehydrates with
``np.frombuffer`` — zero text, zero per-element work, exact dtypes.  Its code
is the JAX package's codec unchanged (it is framework-free), so the two
packages frame equal payloads into identical bytes.

Frame layout (one response, or one streamed sweep cell)::

    offset 0   MAGIC            4 bytes  b"RPWF"
    offset 4   version          u32 LE   (currently 1)
    offset 8   header length    u32 LE
    offset 12  header           JSON, utf-8
    then, per segment:
               payload length   u32 LE
               payload          raw little-endian array bytes

The header is ``{"payload": <JSON structure>, "segments": [{"dtype":
"int32", "shape": [8, 4096]}, ...]}`` where every array in the original
payload is replaced by ``{"__nd__": i}`` — an index into ``segments``.
Decoding walks the structure back, attaching ``np.frombuffer`` views onto
the frame buffer.  Anything JSON-serializable passes through unchanged, so
the same codec frames a single result, a ``{"results": [...]}`` batch, and
each cell of a sweep stream.

Streams are length-prefixed: each cell is ``u32 LE frame length`` + frame,
and the stream end is connection close (the same close-delimited framing
the NDJSON sweeps use, so pull-driven backpressure carries over).

Negotiation: a client asks for binary with ``Accept:
application/x-repro-binary`` (or ``?format=binary``); servers that predate
this module ignore both and answer JSON, which clients detect from the
response Content-Type — fallback needs no version handshake.

Malformed frames (bad magic, truncated header or segment, unknown
version) raise :class:`WireFormatError`, a ``ValueError`` subclass so the
frontends' shared ``map_error`` turns it into a structured 400 — never a
500, never a hung keep-alive connection.
"""
from __future__ import annotations

import json
import struct
import threading
from collections import OrderedDict
from typing import Callable

import numpy as np

MAGIC = b"RPWF"
VERSION = 1

#: one binary frame (single result or {"results": [...]} batch)
CONTENT_TYPE = "application/x-repro-binary"
#: length-prefixed frame stream (the sweep surface); close-delimited
STREAM_CONTENT_TYPE = "application/x-repro-binary-stream"

_U32 = struct.Struct("<I")
_MAX_HEADER_BYTES = 1 << 20      # a metadata header past 1 MiB is corrupt
_MAX_SEGMENT_BYTES = 1 << 31     # and so is a >2 GiB single segment


class WireFormatError(ValueError):
    """A frame that cannot be decoded: wrong magic, unknown version,
    truncated header/segment, or a header that is not valid metadata.
    Subclasses ``ValueError`` so ``serving.http.map_error`` answers a
    structured 400 for wire-supplied garbage instead of a 500."""


# -- encode ------------------------------------------------------------------

def _strip_arrays(obj, segments: list[np.ndarray]):
    """Replace every ndarray in a JSON-ish structure with an ``{"__nd__":
    i}`` placeholder, collecting the arrays in order."""
    if isinstance(obj, np.ndarray):
        segments.append(obj)
        return {"__nd__": len(segments) - 1}
    if isinstance(obj, dict):
        return {k: _strip_arrays(v, segments) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_strip_arrays(v, segments) for v in obj]
    if isinstance(obj, np.generic):  # numpy scalar leaked into metadata
        return obj.item()
    return obj


def _le(arr: np.ndarray) -> np.ndarray:
    """The array in little-endian memory order (no-op on LE hosts)."""
    if arr.dtype.byteorder == ">":
        return arr.astype(arr.dtype.newbyteorder("<"))
    return arr


def encode_frame(payload) -> bytes:
    """One binary frame for a JSON-ish payload whose arrays are numpy.

    Arrays serialize as raw little-endian bytes (C order); everything else
    rides in the JSON metadata header.  ``decode_frame`` is the exact
    inverse, dtype and shape included."""
    segments: list[np.ndarray] = []
    stripped = _strip_arrays(payload, segments)
    header = {
        "payload": stripped,
        "segments": [{"dtype": _le(a).dtype.name, "shape": list(a.shape)}
                     for a in segments],
    }
    head = json.dumps(header, default=str).encode()
    parts = [MAGIC, _U32.pack(VERSION), _U32.pack(len(head)), head]
    for arr in segments:
        raw = np.ascontiguousarray(_le(arr)).tobytes()
        parts.append(_U32.pack(len(raw)))
        parts.append(raw)
    return b"".join(parts)


# -- decode ------------------------------------------------------------------

def _restore_arrays(obj, arrays: list[np.ndarray], used: list[bool]):
    if isinstance(obj, dict):
        if set(obj) == {"__nd__"}:
            idx = obj["__nd__"]
            if not isinstance(idx, int) or not 0 <= idx < len(arrays):
                raise WireFormatError(
                    f"frame header references segment {idx!r} of "
                    f"{len(arrays)}")
            used[idx] = True
            return arrays[idx]
        return {k: _restore_arrays(v, arrays, used) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_restore_arrays(v, arrays, used) for v in obj]
    return obj


def decode_frame(buf: bytes | bytearray | memoryview):
    """Decode one frame back to its payload.  Array segments come back as
    ``np.frombuffer`` views over ``buf`` (zero-copy) with the dtype and
    shape the header declares.  Raises :class:`WireFormatError` on any
    malformed, truncated, or version-unknown frame."""
    view = memoryview(buf)
    if len(view) < 12:
        raise WireFormatError(
            f"binary frame truncated: {len(view)} bytes < 12-byte preamble")
    if bytes(view[:4]) != MAGIC:
        raise WireFormatError(
            f"bad frame magic {bytes(view[:4])!r} (expected {MAGIC!r}) — "
            "not a repro binary frame")
    version = _U32.unpack_from(view, 4)[0]
    if version != VERSION:
        raise WireFormatError(
            f"unknown wire version {version} (this build speaks "
            f"{VERSION})")
    head_len = _U32.unpack_from(view, 8)[0]
    if head_len > _MAX_HEADER_BYTES:
        raise WireFormatError(f"frame header length {head_len} exceeds "
                              f"{_MAX_HEADER_BYTES} bytes")
    if 12 + head_len > len(view):
        raise WireFormatError(
            f"frame truncated inside header: need {12 + head_len} bytes, "
            f"have {len(view)}")
    try:
        header = json.loads(bytes(view[12:12 + head_len]))
    except ValueError as e:
        raise WireFormatError(f"frame header is not valid JSON: {e}") from e
    if not isinstance(header, dict) or "payload" not in header \
            or not isinstance(header.get("segments"), list):
        raise WireFormatError(
            "frame header must be an object with 'payload' and 'segments'")
    offset = 12 + head_len
    arrays: list[np.ndarray] = []
    for i, seg in enumerate(header["segments"]):
        if not isinstance(seg, dict):
            raise WireFormatError(f"segment {i} metadata is not an object")
        try:
            dtype = np.dtype(seg["dtype"])
            shape = tuple(int(s) for s in seg["shape"])
        except (KeyError, TypeError, ValueError) as e:
            raise WireFormatError(
                f"segment {i} carries bad dtype/shape metadata: {e}") from e
        if offset + 4 > len(view):
            raise WireFormatError(
                f"frame truncated before segment {i} length prefix")
        nbytes = _U32.unpack_from(view, offset)[0]
        offset += 4
        if nbytes > _MAX_SEGMENT_BYTES or offset + nbytes > len(view):
            raise WireFormatError(
                f"frame truncated inside segment {i}: declared {nbytes} "
                f"bytes, {len(view) - offset} remain")
        expect = dtype.itemsize * int(np.prod(shape, dtype=np.int64)) \
            if shape else dtype.itemsize
        if nbytes != expect:
            raise WireFormatError(
                f"segment {i} is {nbytes} bytes but dtype={dtype.name} "
                f"shape={list(shape)} needs {expect}")
        arr = np.frombuffer(view, dtype=dtype.newbyteorder("<"),
                            count=expect // dtype.itemsize,
                            offset=offset).reshape(shape)
        if arr.dtype.byteorder == ">":  # pragma: no cover — BE hosts only
            arr = arr.astype(dtype)
        arrays.append(arr)
        offset += nbytes
    if offset != len(view):
        raise WireFormatError(
            f"{len(view) - offset} trailing bytes after the last segment")
    used = [False] * len(arrays)
    payload = _restore_arrays(header["payload"], arrays, used)
    if not all(used):
        raise WireFormatError(
            "frame carries segments its payload never references")
    return payload


def decode_request(raw: bytes) -> dict:
    """A binary-framed *request* body: the decoded payload must be a JSON
    object (the same contract the JSON request path enforces)."""
    body = decode_frame(raw)
    if not isinstance(body, dict):
        raise WireFormatError("binary request body must frame a JSON object")
    return body


# -- streaming ---------------------------------------------------------------

def stream_chunk(frame: bytes) -> bytes:
    """One cell of a binary sweep stream: u32 LE length prefix + frame."""
    return _U32.pack(len(frame)) + frame


def read_exact(read: Callable[[int], bytes], n: int) -> bytes:
    """Drain exactly ``n`` bytes from a sized-read callable (``http.client``
    responses may return short reads); b"" on clean EOF at a boundary,
    :class:`WireFormatError` on EOF mid-chunk."""
    chunks: list[bytes] = []
    got = 0
    while got < n:
        piece = read(n - got)
        if not piece:
            if not chunks:
                return b""
            raise WireFormatError(
                f"binary stream truncated: expected {n} bytes, got {got}")
        chunks.append(piece)
        got += len(piece)
    return b"".join(chunks)


def iter_stream(read: Callable[[int], bytes]):
    """Decode a length-prefixed frame stream until clean EOF, yielding one
    payload per frame.  A truncated prefix or frame raises
    :class:`WireFormatError` — close-delimited streams end exactly on a
    frame boundary or they are broken."""
    while True:
        prefix = read_exact(read, 4)
        if prefix == b"":
            return
        (length,) = _U32.unpack(prefix)
        frame = read_exact(read, length)
        if frame == b"" and length:
            raise WireFormatError(
                "binary stream truncated: frame body missing after prefix")
        yield decode_frame(frame)


# -- negotiation -------------------------------------------------------------

def wants_binary(accept: str | None, path: str = "",
                 content_type: str | None = None) -> bool:
    """Did the request ask for a binary response?  Any of: an ``Accept``
    header naming the binary media type, ``?format=binary`` in the URL, or
    a binary-framed request body (a client speaking binary understands
    binary).  Absent all three the answer stays JSON — old clients never
    see a byte they can't parse."""
    if accept and CONTENT_TYPE in accept:
        return True
    if content_type and content_type.startswith(CONTENT_TYPE):
        return True
    if "?" in path:
        from urllib.parse import parse_qs, urlsplit

        if parse_qs(urlsplit(path).query).get("format", [""])[0] == "binary":
            return True
    return False


def is_binary(content_type: str | None) -> bool:
    """Is a *response* Content-Type one of the binary framings?  The
    client's fallback test: an old server ignores the Accept header and
    answers JSON, which this returns False for."""
    return bool(content_type) and content_type.startswith(CONTENT_TYPE)


# -- response-bytes LRU ------------------------------------------------------

class WireCache:
    """LRU of encoded evaluate responses, keyed by the batch's resolved
    executable identity (per member: fingerprint × tier × λ-range/extent ×
    block × interpret) plus the wire format — the evaluate-plane mirror of
    the async frontend's derive blob cache.

    Entries are generation-stamped with the compile cache's eviction
    counter: once the compile cache rotates, cached blobs whose provenance
    says ``executable: hit`` may be stale, so they stop serving.  Entries
    also remember which artifact content addresses they depend on, so a
    ``DELETE /v1/artifact/<key>`` drops exactly the blobs that embedded
    that artifact's coordinates.  Thread-safe: the threaded frontend hits
    it from many handler threads, the async one from loop + workers."""

    def __init__(self, entries: int = 256):
        self.entries = entries
        self.hits = 0
        self.misses = 0
        self._mu = threading.Lock()
        # cell -> (generation, artifact_keys, blob)
        self._cache: "OrderedDict[tuple, tuple[int, tuple, bytes]]" = \
            OrderedDict()

    def get(self, cell: tuple, generation: int = 0) -> bytes | None:
        with self._mu:
            hit = self._cache.get(cell)
            if hit is None or hit[0] != generation:
                if hit is not None:  # stale generation: drop eagerly
                    self._cache.pop(cell, None)
                self.misses += 1
                return None
            self._cache.move_to_end(cell)
            self.hits += 1
            return hit[2]

    def put(self, cell: tuple, blob: bytes, generation: int = 0,
            artifact_keys: tuple = ()) -> None:
        with self._mu:
            self._cache[cell] = (generation, artifact_keys, blob)
            self._cache.move_to_end(cell)
            while len(self._cache) > self.entries:
                self._cache.popitem(last=False)

    def invalidate_artifact(self, key: str) -> None:
        with self._mu:
            stale = [cell for cell, (_, keys, _) in self._cache.items()
                     if key in keys]
            for cell in stale:
                self._cache.pop(cell, None)

    def clear(self) -> None:
        with self._mu:
            self._cache.clear()

    def stats_dict(self) -> dict:
        with self._mu:
            return {"entries": len(self._cache), "capacity": self.entries,
                    "hits": self.hits, "misses": self.misses}
