"""Disaggregated prefill/decode serving and live stream migration: engine
roles, KV-page transfer and the two fleet wire formats.

Prefill is compute-bound and bursty, decode is memory-bound and steady, so
fleets run them on SEPARATE engine pools and hand the prompt's KV cache
across. Everything here composes existing pieces:

- a **prefill role** is an ordinary chunked ``CausalLMEngine`` +
  ``ContinuousBatcher`` with a prefix cache: running a prompt to its first
  token publishes the prompt's whole page chain into the role's
  ``KVBlockPool``;
- **export** pins that chain (``pool.match``) and gathers its pages off the
  pool (``engine.export_prefix_pages`` — copies, so the pin drops right
  after the gather);
- **transfer** is either in-process device to device (the gathered device
  tensors flow straight into the decode engine's import, moved with
  ``.to()`` when the roles sit on different cards) or the serialized wire
  format below over the stdlib HTTP plumbing (``POST /v1/kv_transfer``,
  octet-stream);
- the **decode role** adopts via ``ContinuousBatcher.adopt_chain``:
  pool-index the tokens, write the received pages into the new blocks
  BETWEEN decode steps on the loop thread — the decode cell is never
  touched, so disaggregation adds no per-token dispatch;
- admission then re-prefills only the uncached tail, which is exactly a
  prefix-cache hit — parity with colocated serving is inherited from the
  prefix cache's bit-exactness.

An interconnect-aware :class:`TransferBudget` sits in the admission path:
a bytes-in-flight cap queues (bounded, timed) or sheds transfers, sheds
surfacing as 429 ``Backpressure`` with the budget digest in ``/statusz``.
Role planning lives in ``parallel.mesh.plan_disagg_mesh``.

Wire format (version 1)::

    magic  b"KVPG"                      4 bytes
    version                             u16 big-endian
    header_len                          u32 big-endian
    header JSON (utf-8), keys:
        page_meta   {num_layers, block_tokens, heads, head_dim, dtype}
        n_blocks    pages carried (chain order, lane i = block i)
        token_ids   the FULL prompt ids (the decode pool re-derives its
                    own block keys from them)
        layout      axis-order tag ("lbthd" = layer,block,token,head,dim)
        crc32       zlib.crc32 of the k+v payload bytes
    k pages                             n_blocks contiguous C-order blocks
    v pages                             same shape, immediately after

Truncation, a bad magic, a version from the future, a geometry mismatch,
or a payload CRC mismatch all raise :class:`WireError` — the receiver
refuses rather than adopting garbage KV.

Wire format (version 2, live stream migration)::

    magic  b"KVPG"                      4 bytes
    version = 2                         u16 big-endian
    header_len                          u32 big-endian
    header JSON (utf-8), keys:
        stream      the StreamState dict (request_id, input_ids, tokens,
                    seed, temperature, eos_id, max_new_tokens, length)
        page_meta   {num_layers, cache_len, heads, head_dim, dtype} of
                    the SOURCE slot cache ({} when page-less)
        n_tokens    KV positions carried (== stream.length; 0 = page-less
                    replay — the receiver re-prefills from the tokens)
        layout      axis-order tag ("lthd" = layer,token,head,dim)
        crc32       zlib.crc32 of canonical-stream-JSON + k+v payload —
                    the CRC covers state AND pages, so a tampered token
                    list refuses exactly like a corrupt page byte
    k positions                         n_tokens contiguous C-order rows
    v positions                         same shape, immediately after

Version 1 buffers fed to :func:`deserialize_stream` (and v2 buffers fed to
:func:`deserialize_chain`) refuse on the version field — the two formats
share a magic but never a parser. The receiving side re-pads the carried
positions to its own ``cache_len`` (refusing streams longer than its
cache) and resumes decoding mid-generation via
``ContinuousBatcher.adopt_stream``.

Quantized engines (``kv_dtype="int8"``) speak the same two formats one
version up: **chain version 3** and **stream version 4** carry each page
side as its int8 ``q`` payload immediately followed by that side's
per-position float32 scales (``qk · sk · qv · sv``), and the CRC covers
the scale bytes too. Version and header dtype must agree (v1/v2 ⇒ dtype ≠
int8, v3/v4 ⇒ dtype == int8) or the parser refuses the buffer as
internally inconsistent. Cross-dtype adoption fails closed in both
directions on the ``page_meta`` dtype comparison.

Port of the JAX package's ``serve/disagg.py``: the four versions are the
same bytes, so a JAX replica and a PyTorch one exchange chains and streams
in both directions. Pages travel as torch tensors (CPU or CUDA, moved to
the host once to serialize); bfloat16 payloads are read and written from
torch's raw bytes, so no numpy extension dtype is needed. The parsers
return host torch tensors.
"""

from __future__ import annotations

import json
import logging
import struct
import threading
import time
import zlib

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.obs.flightrec import NULL_RECORDER
from distributed_tensorflow_tpu_torch.serve.batcher import Backpressure

__all__ = [
    "WireError",
    "WIRE_VERSION",
    "WIRE_VERSION_STREAM",
    "WIRE_VERSION_QUANT",
    "WIRE_VERSION_STREAM_QUANT",
    "serialize_chain",
    "deserialize_chain",
    "serialize_stream",
    "deserialize_stream",
    "TransferBudget",
    "DisaggServingPair",
    "make_kv_receiver",
    "post_kv_transfer",
    "StreamReceiver",
    "make_stream_receiver",
    "migrate_streams",
    "post_stream_migrate",
]

logger = logging.getLogger(__name__)

WIRE_MAGIC = b"KVPG"
WIRE_VERSION = 1
WIRE_VERSION_STREAM = 2
WIRE_VERSION_QUANT = 3  # int8 chain: q pages + f32 per-position scales
WIRE_VERSION_STREAM_QUANT = 4  # int8 stream: same payload rule as v3
_PREFIX = struct.Struct(">4sHI")  # magic, version, header_len
_LAYOUT = "lbthd"
_STREAM_LAYOUT = "lthd"


class WireError(ValueError):
    """A KV-page wire buffer the receiver must refuse (truncated, wrong
    magic/version, geometry mismatch, corrupt payload)."""


# ------------------------------------------------------------ host tensors


def _host(x) -> torch.Tensor:
    """A page leaf as a contiguous host tensor: torch tensors (CPU or CUDA)
    move to the host once; numpy arrays are taken as they are, a numpy
    ``bfloat16`` array (an extension dtype) through its raw 16-bit words."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu").contiguous()
    a = np.ascontiguousarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy() if not a.flags.writeable else a)


def _dtype_name(t: torch.Tensor) -> str:
    """numpy's name for a tensor's dtype (``float32``, ``bfloat16``,
    ``int8``): the header's dtype string on both sides of the wire."""
    return str(t.dtype).removeprefix("torch.")


def _bytes(t: torch.Tensor) -> bytes:
    """A contiguous host tensor's C-order bytes (bfloat16 included)."""
    if t.dim() == 0:
        t = t.reshape(1)
    return t.view(torch.uint8).numpy().tobytes()


def _wire_dtype(name) -> tuple[torch.dtype, int]:
    """``(torch dtype, itemsize)`` for a header dtype name. ``bfloat16`` is
    mapped here; every other name goes through ``np.dtype``, whose refusal
    of a name it does not know is the JAX parser's."""
    if name == "bfloat16":
        return torch.bfloat16, 2
    dt = np.dtype(name)
    return torch.from_numpy(np.empty(0, dt)).dtype, int(dt.itemsize)


def _frombuffer(payload: bytearray, offset: int, shape, dtype) -> torch.Tensor:
    """``shape`` of ``dtype`` read from ``payload`` at byte ``offset``
    (a view of the received bytes, no copy)."""
    count = int(np.prod(shape))
    if count == 0:
        return torch.empty(tuple(shape), dtype=dtype)
    return torch.frombuffer(payload, dtype=dtype, count=count,
                            offset=offset).reshape(tuple(shape))


# ------------------------------------------------------------- wire format


def serialize_chain(token_ids, pages_k, pages_v, page_meta: dict) -> bytes:
    """Serialize a KV-page chain for the cross-process transport.

    ``pages_*`` are ``[num_layers, n, block_tokens, heads, head_dim]``
    tensors (or numpy arrays) holding the chain's pages in order (NO pad
    lanes — the caller slices its export stage down to the real chain
    length); ``page_meta`` is the source engine's :meth:`page_meta` digest.
    The token ids ride in the header so the receiving pool can index the
    chain under its own trie without a side channel.

    Quantized pools pass each side as its ``{"q", "s"}`` tree (int8 pages
    + float32 ``[num_layers, n, block_tokens]`` scales); the buffer then
    travels as version :data:`WIRE_VERSION_QUANT` with the scales appended
    to their side's payload and covered by the CRC.
    """
    if isinstance(pages_k, dict) != isinstance(pages_v, dict):
        raise ValueError(
            "k/v pages must both be plain arrays or both {'q','s'} trees"
        )
    quantized = isinstance(pages_k, dict)
    if quantized:
        pk = _host(pages_k["q"])
        pv = _host(pages_v["q"])
        sk = _host(pages_k["s"]).to(torch.float32)
        sv = _host(pages_v["s"]).to(torch.float32)
        if pk.dtype != torch.int8:
            raise ValueError(
                f"quantized pages must be int8, got {_dtype_name(pk)}"
            )
        if sk.shape != pk.shape[:3] or sv.shape != pv.shape[:3]:
            raise ValueError(
                f"scale shapes {tuple(sk.shape)}/{tuple(sv.shape)} do not "
                f"cover [l,b,t] of pages {tuple(pk.shape)}"
            )
    else:
        pk = _host(pages_k)
        pv = _host(pages_v)
        if pk.dtype == torch.int8:
            raise ValueError(
                "int8 pages need their {'q','s'} scale tree — a bare "
                "int8 array cannot be dequantized on the far side"
            )
    if pk.shape != pv.shape:
        raise ValueError(
            f"k/v page shapes differ: {tuple(pk.shape)} vs {tuple(pv.shape)}"
        )
    if pk.dim() != 5:
        raise ValueError(f"pages must be 5-D [l,b,t,h,d], got {tuple(pk.shape)}")
    if len(token_ids) // max(int(pk.shape[2]), 1) != pk.shape[1]:
        raise ValueError(
            f"{len(token_ids)} token keys do not cover exactly the "
            f"{pk.shape[1]} pages carried (block_tokens={pk.shape[2]})"
        )
    if quantized:
        payload = _bytes(pk) + _bytes(sk) + _bytes(pv) + _bytes(sv)
        version = WIRE_VERSION_QUANT
    else:
        payload = _bytes(pk) + _bytes(pv)
        version = WIRE_VERSION
    header = {
        "page_meta": {
            "num_layers": int(pk.shape[0]),
            "block_tokens": int(pk.shape[2]),
            "heads": int(pk.shape[3]),
            "head_dim": int(pk.shape[4]),
            "dtype": _dtype_name(pk),
        },
        "n_blocks": int(pk.shape[1]),
        "token_ids": [int(t) for t in token_ids],
        "layout": _LAYOUT,
        "crc32": zlib.crc32(payload) & 0xFFFFFFFF,
    }
    expect = {k: v for k, v in page_meta.items() if k != "max_chain"}
    got = dict(header["page_meta"])
    if expect != got:
        raise ValueError(
            f"pages {got} disagree with the engine's page_meta {expect}"
        )
    hbytes = json.dumps(header, separators=(",", ":")).encode("utf-8")
    return _PREFIX.pack(WIRE_MAGIC, version, len(hbytes)) + hbytes + payload


def _parse_prefix(buf, versions: tuple[int, int], label: str, kind: str):
    """The checks both parsers run first: prefix length, magic, version
    (``label`` and ``kind`` name the format in the refusal), header
    length, header JSON. Returns ``(version, hlen, header)``."""
    if len(buf) < _PREFIX.size:
        raise WireError(
            f"buffer of {len(buf)} bytes is shorter than the "
            f"{_PREFIX.size}-byte wire prefix"
        )
    magic, version, hlen = _PREFIX.unpack_from(buf)
    if magic != WIRE_MAGIC:
        raise WireError(f"bad magic {magic!r} (expected {WIRE_MAGIC!r})")
    if version not in versions:
        raise WireError(
            f"{label} version {version} unsupported (speaker of {kind} "
            f"versions {versions[0]} and {versions[1]}); refusing rather "
            "than guessing the layout"
        )
    if len(buf) < _PREFIX.size + hlen:
        raise WireError(
            f"truncated header: need {hlen} bytes, have "
            f"{len(buf) - _PREFIX.size}"
        )
    try:
        header = json.loads(bytes(buf[_PREFIX.size:_PREFIX.size + hlen]))
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise WireError(f"corrupt header JSON: {e}") from e
    return version, hlen, header


def deserialize_chain(buf: bytes):
    """Parse + verify a wire buffer: returns ``(token_ids, pages_k,
    pages_v, header)`` with host tensor page stages (``{"q", "s"}`` trees
    for a quantized v3 buffer). Every malformation raises
    :class:`WireError` BEFORE any page bytes are trusted."""
    version, hlen, header = _parse_prefix(
        buf, (WIRE_VERSION, WIRE_VERSION_QUANT), "wire", "chain")
    try:
        meta = header["page_meta"]
        shape = (
            int(meta["num_layers"]), int(header["n_blocks"]),
            int(meta["block_tokens"]), int(meta["heads"]),
            int(meta["head_dim"]),
        )
        dtype, itemsize = _wire_dtype(meta["dtype"])
        token_ids = [int(t) for t in header["token_ids"]]
        layout = header["layout"]
        crc = int(header["crc32"])
    except (KeyError, TypeError, ValueError) as e:
        raise WireError(f"header missing/invalid field: {e}") from e
    if layout != _LAYOUT:
        raise WireError(
            f"page layout {layout!r} unsupported (expected {_LAYOUT!r})"
        )
    if len(token_ids) // max(int(meta["block_tokens"]), 1) != shape[1]:
        raise WireError(
            f"{len(token_ids)} token keys cover "
            f"{len(token_ids) // max(int(meta['block_tokens']), 1)} blocks "
            f"but the buffer carries {shape[1]} pages — a receiving pool "
            "would index blocks whose pages never arrived"
        )
    quantized = version == WIRE_VERSION_QUANT
    name = _dtype_name(torch.empty(0, dtype=dtype))
    if quantized != (dtype == torch.int8):
        raise WireError(
            f"wire version {version} carrying {name} pages is "
            f"internally inconsistent — int8 travels as version "
            f"{WIRE_VERSION_QUANT} with scale payloads, everything else "
            f"as version {WIRE_VERSION}"
        )
    if quantized:
        qbytes = int(np.prod(shape))
        sbytes = int(np.prod(shape[:3])) * 4
        nbytes = qbytes + sbytes
    else:
        nbytes = int(np.prod(shape)) * itemsize
    start = _PREFIX.size + hlen
    if len(buf) - start != 2 * nbytes:
        raise WireError(
            f"payload of {len(buf) - start} bytes != 2 x {nbytes} "
            f"for {shape} {name} pages"
        )
    payload = bytearray(memoryview(buf)[start:])
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise WireError("payload CRC mismatch: pages corrupted in flight")
    if quantized:
        def side(off):
            return {
                "q": _frombuffer(payload, off, shape, torch.int8),
                "s": _frombuffer(payload, off + qbytes, shape[:3],
                                 torch.float32),
            }

        pages_k, pages_v = side(0), side(nbytes)
    else:
        pages_k = _frombuffer(payload, 0, shape, dtype)
        pages_v = _frombuffer(payload, nbytes, shape, dtype)
    return token_ids, pages_k, pages_v, header


# ------------------------------------------------- wire format v2 (streams)


def _canonical_state(state: dict) -> bytes:
    """The CRC-covered byte form of a stream-state dict: minimal JSON
    with sorted keys, so serializer and receiver derive identical bytes
    from identical state regardless of dict insertion order."""
    return json.dumps(state, separators=(",", ":"), sort_keys=True).encode(
        "utf-8"
    )


def serialize_stream(state, pages_k=None, pages_v=None,
                     page_meta: dict | None = None) -> bytes:
    """Serialize a live decode stream for the cross-process transport.

    ``state`` is a :class:`~.batcher.StreamState` (or its dict form);
    ``pages_*`` are the slot-export stages ``[num_layers, T, heads,
    head_dim]`` — sliced here to the state's ``length`` positions (the
    only ones a resumed slot will ever attend over) — and ``page_meta`` is
    the source engine's :meth:`stream_page_meta` digest. Both pages
    ``None`` ships a page-less stream (``n_tokens=0``): the receiver
    re-prefills from the state's tokens, which is bit-identical by the
    (seed, absolute position) sampling contract, just slower.

    Quantized slot caches pass each stage as its ``{"q", "s"}`` tree (int8
    positions + float32 ``[num_layers, T]`` scales); the buffer then
    travels as version :data:`WIRE_VERSION_STREAM_QUANT` with the scales
    in the CRC-covered payload.
    """
    sd = state.to_dict() if hasattr(state, "to_dict") else dict(state)
    sbytes = _canonical_state(sd)
    if (pages_k is None) != (pages_v is None):
        raise ValueError("pages_k and pages_v must both be given or both None")
    version = WIRE_VERSION_STREAM
    if pages_k is None:
        n, meta, payload = 0, {}, b""
    else:
        if page_meta is None:
            raise ValueError(
                "a page-carrying stream needs the source engine's "
                "stream_page_meta"
            )
        n = int(sd.get("length", 0))
        if n <= 0:
            raise ValueError(
                f"a page-carrying stream needs state length >= 1, got {n}"
            )
        if isinstance(pages_k, dict) != isinstance(pages_v, dict):
            raise ValueError(
                "k/v stages must both be plain arrays or both "
                "{'q','s'} trees"
            )
        quantized = isinstance(pages_k, dict)
        # Only the settled positions leave the device: slice first, then
        # one host copy each (serialization runs off the decode loop; the
        # export already copied the slot out of the cache).
        if quantized:
            pk = _host(pages_k["q"][:, :n])
            pv = _host(pages_v["q"][:, :n])
            sk = _host(pages_k["s"][:, :n]).to(torch.float32)
            sv = _host(pages_v["s"][:, :n]).to(torch.float32)
            if pk.dtype != torch.int8:
                raise ValueError(
                    f"quantized stages must be int8, got {_dtype_name(pk)}"
                )
            if sk.shape != pk.shape[:2] or sv.shape != pv.shape[:2]:
                raise ValueError(
                    f"scale shapes {tuple(sk.shape)}/{tuple(sv.shape)} do "
                    f"not cover [l,t] of stages {tuple(pk.shape)}"
                )
            version = WIRE_VERSION_STREAM_QUANT
        else:
            pk = _host(pages_k[:, :n])
            pv = _host(pages_v[:, :n])
            if pk.dtype == torch.int8:
                raise ValueError(
                    "int8 stages need their {'q','s'} scale tree — a "
                    "bare int8 array cannot be dequantized on the far "
                    "side"
                )
        if pk.shape != pv.shape:
            raise ValueError(
                f"k/v stage shapes differ: {tuple(pk.shape)} vs "
                f"{tuple(pv.shape)}"
            )
        if pk.dim() != 4:
            raise ValueError(
                f"stream pages must be 4-D [l,t,h,d], got {tuple(pk.shape)}"
            )
        meta = {
            "num_layers": int(pk.shape[0]),
            "cache_len": int(page_meta["cache_len"]),
            "heads": int(pk.shape[2]),
            "head_dim": int(pk.shape[3]),
            "dtype": _dtype_name(pk),
        }
        if meta != dict(page_meta):
            raise ValueError(
                f"pages {meta} disagree with the engine's "
                f"stream_page_meta {dict(page_meta)}"
            )
        if quantized:
            payload = _bytes(pk) + _bytes(sk) + _bytes(pv) + _bytes(sv)
        else:
            payload = _bytes(pk) + _bytes(pv)
    header = {
        "stream": sd,
        "page_meta": meta,
        "n_tokens": n,
        "layout": _STREAM_LAYOUT,
        "crc32": zlib.crc32(payload, zlib.crc32(sbytes)) & 0xFFFFFFFF,
    }
    hbytes = json.dumps(header, separators=(",", ":")).encode("utf-8")
    return (
        _PREFIX.pack(WIRE_MAGIC, version, len(hbytes))
        + hbytes + payload
    )


def deserialize_stream(buf: bytes):
    """Parse + verify a stream wire buffer: returns ``(state_dict,
    pages_k, pages_v, header)`` — pages ``None`` for a page-less stream,
    ``{"q", "s"}`` trees for a quantized v4 buffer. Every malformation
    raises :class:`WireError` BEFORE any byte of state or pages is trusted
    (fail-closed: refuse, never guess)."""
    version, hlen, header = _parse_prefix(
        buf, (WIRE_VERSION_STREAM, WIRE_VERSION_STREAM_QUANT), "stream wire",
        "stream")
    try:
        sd = dict(header["stream"])
        n = int(header["n_tokens"])
        layout = header["layout"]
        crc = int(header["crc32"])
        length = int(sd["length"])
        [int(t) for t in sd["input_ids"]]
        [int(t) for t in sd["tokens"]]
    except (KeyError, TypeError, ValueError) as e:
        raise WireError(f"header missing/invalid field: {e}") from e
    if layout != _STREAM_LAYOUT:
        raise WireError(
            f"stream page layout {layout!r} unsupported "
            f"(expected {_STREAM_LAYOUT!r})"
        )
    quantized = version == WIRE_VERSION_STREAM_QUANT
    start = _PREFIX.size + hlen
    n_payload = len(buf) - start
    if n == 0:
        if quantized:
            raise WireError(
                "a quantized stream buffer (v4) must carry pages — "
                "page-less streams travel as version "
                f"{WIRE_VERSION_STREAM}"
            )
        if n_payload:
            raise WireError(
                f"page-less stream carries {n_payload} stray payload bytes"
            )
        pk = pv = None
    else:
        if n != length:
            raise WireError(
                f"header carries {n} KV positions but the stream state's "
                f"length is {length} — a resumed slot would attend over "
                "positions that never arrived"
            )
        try:
            meta = header["page_meta"]
            shape = (
                int(meta["num_layers"]), n,
                int(meta["heads"]), int(meta["head_dim"]),
            )
            dtype, itemsize = _wire_dtype(meta["dtype"])
        except (KeyError, TypeError, ValueError) as e:
            raise WireError(f"header missing/invalid field: {e}") from e
        name = _dtype_name(torch.empty(0, dtype=dtype))
        if quantized != (dtype == torch.int8):
            raise WireError(
                f"stream wire version {version} carrying {name} "
                f"pages is internally inconsistent — int8 travels as "
                f"version {WIRE_VERSION_STREAM_QUANT} with scale "
                f"payloads, everything else as version "
                f"{WIRE_VERSION_STREAM}"
            )
        if quantized:
            qbytes = int(np.prod(shape))
            nbytes = qbytes + int(np.prod(shape[:2])) * 4
        else:
            nbytes = int(np.prod(shape)) * itemsize
        if n_payload != 2 * nbytes:
            raise WireError(
                f"payload of {n_payload} bytes != 2 x {nbytes} "
                f"for {shape} {name} stream pages"
            )
    payload = bytearray(memoryview(buf)[start:])
    if zlib.crc32(payload, zlib.crc32(_canonical_state(sd))) & 0xFFFFFFFF != crc:
        raise WireError(
            "stream CRC mismatch: state or pages corrupted in flight"
        )
    if n and quantized:
        def side(off):
            return {
                "q": _frombuffer(payload, off, shape, torch.int8),
                "s": _frombuffer(payload, off + qbytes, shape[:2],
                                 torch.float32),
            }

        pk, pv = side(0), side(nbytes)
    elif n:
        pk = _frombuffer(payload, 0, shape, dtype)
        pv = _frombuffer(payload, nbytes, shape, dtype)
    return sd, pk, pv, header


# --------------------------------------------------------- transfer budget


class TransferBudget:
    """Interconnect-aware bytes-in-flight cap for KV-page transfers.

    The admission-path guard: a transfer :meth:`acquire`\\ s its byte count
    before moving anything. Over the cap it WAITS (bounded queue, bounded
    time — interconnects recover in milliseconds, admission shouldn't shed
    on a blip); a full waiter queue or a timeout SHEDS as
    :class:`~.batcher.Backpressure` (the server maps it to 429 +
    Retry-After, same as queue sheds). ``digest()`` feeds ``/statusz``.
    """

    def __init__(self, cap_bytes: int, *, max_queued: int = 8,
                 timeout_s: float = 2.0):
        if cap_bytes < 1:
            raise ValueError(f"cap_bytes must be >= 1, got {cap_bytes}")
        self.cap_bytes = int(cap_bytes)
        self.max_queued = int(max_queued)
        self.timeout_s = float(timeout_s)
        self._cv = threading.Condition()
        self._in_flight = 0
        self._queued = 0
        self._granted = 0
        self._shed = 0

    def acquire(self, nbytes: int) -> None:
        """Reserve ``nbytes`` of transfer headroom or raise
        ``Backpressure``. A single transfer larger than the whole cap can
        never fit and sheds immediately."""
        nbytes = int(nbytes)
        if nbytes <= 0:
            return
        deadline = time.monotonic() + self.timeout_s
        with self._cv:
            if nbytes > self.cap_bytes or self._queued >= self.max_queued:
                self._shed += 1
                raise Backpressure(self.timeout_s)
            self._queued += 1
            try:
                while self._in_flight + nbytes > self.cap_bytes:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._cv.wait(remaining):
                        self._shed += 1
                        raise Backpressure(self.timeout_s)
            finally:
                self._queued -= 1
            self._in_flight += nbytes
            self._granted += 1

    def release(self, nbytes: int) -> None:
        nbytes = int(nbytes)
        if nbytes <= 0:
            return
        with self._cv:
            self._in_flight = max(self._in_flight - nbytes, 0)
            self._cv.notify_all()

    def digest(self) -> dict:
        """The ``/statusz`` ``kv_transfer`` section."""
        with self._cv:
            return {
                "cap_bytes": self.cap_bytes,
                "in_flight_bytes": self._in_flight,
                "queued": self._queued,
                "granted_total": self._granted,
                "shed_total": self._shed,
            }


# --------------------------------------------------------- role orchestration


class DisaggServingPair:
    """One prefill role + one decode role behind a single submit surface.

    Both roles are ordinary engine+batcher stacks (on the devices a
    :func:`~distributed_tensorflow_tpu_torch.parallel.mesh.plan_disagg_mesh`
    planned, or stub engines in tests); the pair owns only the hand-off:
    run the prompt on the prefill role to its first token, move the
    published page chain under the transfer budget, adopt it on the decode
    role, then submit the UNCHANGED request there — the decode role's
    admission re-prefills just the uncached tail, so the stream is
    bit-identical to a colocated engine's by the prefix-cache parity
    contract.

    ``transport="d2d"`` hands the gathered device pages straight to the
    decode engine's import (same process; the import moves them to the
    decode role's card when the roles sit on different ones);
    ``transport="wire"`` round-trips the serialized format — in-process it
    is the loopback rehearsal of the cross-process path, cross-process the
    caller POSTs the buffer via :func:`post_kv_transfer` instead of
    constructing a pair.

    Engines without page export (stub engines) degrade to pool-only
    adoption: the chain is indexed on the decode pool with no pages, which
    is exact for stubs whose prefill is a pure function of the full
    prompt. ``timeout_s`` bounds each wait on a role's future.
    """

    def __init__(
        self,
        *,
        prefill_batcher,
        decode_batcher,
        prefill_engine=None,
        decode_engine=None,
        budget: TransferBudget | None = None,
        transport: str = "d2d",
        metrics=None,
        recorder=None,
        timeout_s: float | None = 120.0,
    ):
        if transport not in ("d2d", "wire"):
            raise ValueError(
                f"transport must be 'd2d' or 'wire', got {transport!r}"
            )
        self.prefill = prefill_batcher
        self.decode = decode_batcher
        self._pre_engine = prefill_engine
        self._dec_engine = decode_engine
        self.budget = budget
        self.transport = transport
        self.metrics = metrics
        self.recorder = recorder if recorder is not None else NULL_RECORDER
        self.timeout_s = timeout_s
        self._pre_pool = getattr(
            prefill_engine, "prefix_cache", None
        ) or getattr(prefill_batcher, "_pool", None)
        if self._pre_pool is None:
            raise ValueError(
                "prefill role needs a prefix cache (its pool IS the "
                "publication surface a transfer exports from)"
            )
        if prefill_engine is not None and decode_engine is not None and (
            callable(getattr(prefill_engine, "export_prefix_pages", None))
        ):
            pm = prefill_engine.page_meta()
            dm = decode_engine.page_meta()
            if pm != dm:
                raise ValueError(
                    f"role page geometries differ: prefill {pm} vs "
                    f"decode {dm} — chains cannot transfer"
                )

    # ------------------------------------------------------------ transfer

    def transfer(self, token_ids, request_id: str = "") -> int:
        """Move ``token_ids``'s published chain from the prefill pool to
        the decode role; returns the number of blocks the decode side
        newly adopted (0 = nothing published or already cached). Budget
        sheds raise ``Backpressure`` (recorded as ``kv_transfer_reject``);
        transfer itself records start/done events plus the role-labelled
        byte/latency families."""
        pool = self._pre_pool
        m = pool.match(token_ids)
        try:
            if not m.blocks:
                return 0
            # The decode pool must never index a block whose pages were
            # not carried: trim the token keys to EXACTLY the matched
            # chain's coverage, so its insert allocates n_blocks blocks
            # and not one more (the uncovered tail re-prefills there).
            token_ids = [
                int(t)
                for t in token_ids[: len(m.blocks) * pool.block_tokens]
            ]
            nbytes = len(m.blocks) * pool.bytes_per_block
            if self.budget is not None:
                try:
                    self.budget.acquire(nbytes)
                except Backpressure:
                    self.recorder.record(
                        "kv_transfer_reject", request_id,
                        cause="budget", bytes=nbytes,
                    )
                    raise
            try:
                t0 = time.monotonic()
                self.recorder.record(
                    "kv_transfer_start", request_id,
                    blocks=len(m.blocks), bytes=nbytes,
                    transport=self.transport,
                )
                adopted = self._move(token_ids, m.blocks)
                dt = time.monotonic() - t0
            finally:
                if self.budget is not None:
                    self.budget.release(nbytes)
            if self.metrics is not None:
                self.metrics.kv_transfer_bytes.inc("prefill", nbytes)
                self.metrics.kv_transfer_bytes.inc("decode", nbytes)
                self.metrics.kv_transfer_seconds.observe("prefill", dt)
                self.metrics.kv_transfer_seconds.observe("decode", dt)
            self.recorder.record(
                "kv_transfer_done", request_id,
                blocks=len(m.blocks), adopted=adopted, bytes=nbytes,
                ms=round(dt * 1e3, 3),
            )
            return adopted
        finally:
            pool.release(m)  # idempotent; pin held across the export

    def _move(self, token_ids, blocks) -> int:
        engine = self._pre_engine
        if engine is None or not callable(
            getattr(engine, "export_prefix_pages", None)
        ):
            # Stub / pool-only roles: index the chain, no pages to carry.
            return self.decode.adopt_chain(token_ids).result(self.timeout_s)
        pk, pv = engine.export_prefix_pages(blocks)
        if self.transport == "wire":
            # Loopback rehearsal of the cross-process path: fetch, frame,
            # parse, verify — byte for byte what POST /v1/kv_transfer
            # carries (off the decode loop; serialize moves the real
            # chain lanes to the host once).
            n = len(blocks)
            buf = serialize_chain(
                token_ids,
                _slice_chain(pk, n),
                _slice_chain(pv, n),
                engine.page_meta(),
            )
            ids, wk, wv, _ = deserialize_chain(buf)
            m = self._dec_engine.page_meta()["max_chain"]
            return self.decode.adopt_chain(
                ids, _pad_chain(wk, m), _pad_chain(wv, m)
            ).result(self.timeout_s)
        # d2d: gathered device stages flow straight into the decode
        # engine's import (no host round trip; the import's .to() crosses
        # cards when the roles sit on different ones).
        return self.decode.adopt_chain(token_ids, pk, pv).result(self.timeout_s)

    # ------------------------------------------------------------- serving

    def submit(self, payload: dict, request_id: str | None = None):
        """Disaggregated serve of one request: prefill role to first
        token, chain transfer, decode role for the real stream. Blocks
        through prefill + transfer (callers thread per request); returns
        the decode role's Future — the stream it resolves to is
        bit-identical to a colocated engine's."""
        pre_payload = dict(payload)
        pre_payload["max_new_tokens"] = 1
        self.prefill.submit(pre_payload, request_id=request_id).result(
            self.timeout_s)
        try:
            self.transfer(
                payload["input_ids"],
                request_id=request_id or "",
            )
        except Backpressure:
            # Budget shed: the request still serves, just without the
            # chain — the decode role re-prefills the whole prompt.
            # Degraded latency, never a failed request.
            pass
        return self.decode.submit(payload, request_id=request_id)

    def generate(self, payload: dict, request_id: str | None = None):
        """Blocking convenience: :meth:`submit` + result."""
        return self.submit(payload, request_id=request_id).result(self.timeout_s)

    def close(self, drain: bool = True) -> None:
        self.prefill.close(drain=drain)
        self.decode.close(drain=drain)


def _slice_chain(pages, n: int):
    """First ``n`` chain lanes of a page stage (plain tensor or quantized
    ``{"q", "s"}`` tree — every leaf shares axis 1)."""
    if isinstance(pages, dict):
        return {k: v[:, :n] for k, v in pages.items()}
    return pages[:, :n]


def _pad_lanes(stage, size: int) -> torch.Tensor:
    """``stage`` with zero lanes appended on axis 1 up to ``size``."""
    stage = _host(stage) if not isinstance(stage, torch.Tensor) else stage
    n = stage.shape[1]
    if n == size:
        return stage
    pad = stage.new_zeros((stage.shape[0], size - n, *stage.shape[2:]))
    return torch.cat([stage, pad], dim=1)


def _pad_chain(pages, max_chain: int):
    """Pad a ``[l, n, t, h, d]`` chain stage (or each leaf of a quantized
    ``{"q", "s"}`` tree — scales share the chain axis) to the import
    cell's fixed ``max_chain`` lanes (pad lanes go to the pool's spare
    block)."""
    if isinstance(pages, dict):
        return {k: _pad_chain(v, max_chain) for k, v in pages.items()}
    n = pages.shape[1]
    if n > max_chain:
        raise WireError(
            f"chain of {n} blocks exceeds the importer's max chain "
            f"{max_chain}"
        )
    return _pad_lanes(pages, max_chain)


# ------------------------------------------------------- cross-process wire


def make_kv_receiver(batcher, engine, *, budget: TransferBudget | None = None,
                     metrics=None, recorder=None,
                     timeout_s: float | None = 60.0):
    """The decode-process half of the cross-process transport: a
    ``bytes -> dict`` callable the HTTP server mounts at
    ``POST /v1/kv_transfer``. Verifies the wire buffer, checks geometry
    against the local engine, budget-gates the bytes, and adopts via the
    batcher (loop-thread import, like every adoption; ``timeout_s`` bounds
    the wait for it). Raises ``WireError`` (400) on refusal,
    ``Backpressure`` (429) on shed."""
    recorder = recorder if recorder is not None else NULL_RECORDER

    def receive(body: bytes) -> dict:
        try:
            token_ids, pk, pv, header = deserialize_chain(body)
        except WireError as e:
            recorder.record("kv_transfer_reject", "", cause="wire",
                            error=str(e))
            raise
        meta = engine.page_meta()
        got = dict(header["page_meta"])
        expect = {k: v for k, v in meta.items() if k != "max_chain"}
        if got != expect:
            recorder.record("kv_transfer_reject", "", cause="geometry")
            raise WireError(
                f"page geometry {got} does not match this engine's "
                f"{expect}"
            )
        nbytes = len(body)
        if budget is not None:
            try:
                budget.acquire(nbytes)
            except Backpressure:
                recorder.record("kv_transfer_reject", "", cause="budget",
                                bytes=nbytes)
                raise
        n_blocks = int(header["n_blocks"])
        try:
            t0 = time.monotonic()
            recorder.record("kv_transfer_start", "", blocks=n_blocks,
                            bytes=nbytes, transport="wire")
            adopted = batcher.adopt_chain(
                token_ids,
                _pad_chain(pk, meta["max_chain"]),
                _pad_chain(pv, meta["max_chain"]),
            ).result(timeout_s)
            dt = time.monotonic() - t0
        finally:
            if budget is not None:
                budget.release(nbytes)
        if metrics is not None:
            metrics.kv_transfer_bytes.inc("decode", nbytes)
            metrics.kv_transfer_seconds.observe("decode", dt)
        recorder.record("kv_transfer_done", "", blocks=n_blocks,
                        adopted=adopted, bytes=nbytes,
                        ms=round(dt * 1e3, 3))
        return {"adopted_blocks": adopted, "bytes": nbytes}

    return receive


def _post(host: str, port: int, path: str, buf: bytes, timeout_s: float,
          what: str) -> dict:
    """POST an octet-stream wire buffer; 429 -> ``Backpressure``, 400 ->
    ``WireError``, any other non-200 -> ``RuntimeError``."""
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=timeout_s)
    try:
        conn.request(
            "POST", path, body=buf,
            headers={"Content-Type": "application/octet-stream"},
        )
        resp = conn.getresponse()
        body = resp.read()
        try:
            out = json.loads(body)
        except json.JSONDecodeError:
            out = {"error": body[:200].decode("utf-8", "replace")}
        if resp.status == 429:
            raise Backpressure(
                float(resp.headers.get("Retry-After", 1.0))
            )
        if resp.status == 400:
            raise WireError(out.get("error", f"{what} refused"))
        if resp.status != 200:
            raise RuntimeError(
                f"{what} failed: HTTP {resp.status} {out}"
            )
        return out
    finally:
        conn.close()


def post_kv_transfer(host: str, port: int, buf: bytes, *,
                     timeout_s: float = 10.0) -> dict:
    """Prefill-process half of the cross-process transport: POST a
    serialized chain to a decode server's ``/v1/kv_transfer``. Returns the
    adoption digest; raises ``Backpressure`` on a 429 shed and
    ``WireError`` on a 400 refusal (mirroring the in-process paths)."""
    return _post(host, port, "/v1/kv_transfer", buf, timeout_s, "kv transfer")


# ------------------------------------------------- cross-process migration


def _pad_stream_stage(stage, cache_len: int):
    """Pad a ``[l, n, h, d]`` stream stage (or each leaf of a quantized
    ``{"q", "s"}`` tree — scales share the position axis) to the
    receiver's full ``cache_len`` positions (the slot-import cell writes
    whole slot lanes; pad positions sit beyond ``length`` and are never
    attended; the cache's spare position stays the engine's own)."""
    if isinstance(stage, dict):
        return {k: _pad_stream_stage(v, cache_len) for k, v in stage.items()}
    n = stage.shape[1]
    if n > cache_len:
        raise WireError(
            f"stream carries {n} KV positions but this engine's cache "
            f"holds {cache_len}"
        )
    return _pad_lanes(stage, cache_len)


class StreamReceiver:
    """The survivor half of live stream migration: a ``bytes -> dict``
    callable the HTTP server mounts at ``POST /v1/stream_migrate``, plus the
    pending registry ``POST /v1/stream_wait`` blocks on.

    Verifies the v2 wire buffer, checks slot geometry against the local
    engine, budget-gates the bytes (same :class:`TransferBudget` as KV
    chains — stream payloads and chain payloads share one interconnect),
    and resumes via ``batcher.adopt_stream``. The adoption future — which
    resolves with the COMPLETED generation — is registered under the
    stream's original request id so the migration orchestrator can collect
    the finished result from this replica with ``POST /v1/stream_wait``
    instead of replaying from scratch. Raises ``WireError`` (400) on
    refusal, ``Backpressure`` (429) on shed.
    """

    _RACETRACE_ATTRS = ("_pending",)

    def __init__(self, batcher, engine=None, *,
                 budget: TransferBudget | None = None,
                 metrics=None, recorder=None):
        self.batcher = batcher
        self.engine = engine
        self.budget = budget
        self.metrics = metrics
        self.recorder = recorder if recorder is not None else NULL_RECORDER
        self._lock = threading.Lock()
        self._pending: dict[str, object] = {}  # request_id -> Future

    def _reject(self, cause: str, err: Exception) -> None:
        self.recorder.record(
            "stream_migrate_reject", "", cause=cause, error=str(err)
        )
        if self.metrics is not None:
            self.metrics.stream_migrations.inc("rejected")

    def __call__(self, body: bytes) -> dict:
        from distributed_tensorflow_tpu_torch.serve.batcher import StreamState

        try:
            sd, pk, pv, header = deserialize_stream(body)
        except WireError as e:
            self._reject("wire", e)
            raise
        try:
            state = StreamState.from_dict(sd)
        except (KeyError, TypeError, ValueError) as e:
            self._reject("state", e)
            raise WireError(f"stream state invalid: {e}") from e
        if pk is not None:
            engine = self.engine
            if engine is None or not getattr(engine, "stream_migrate", False):
                e = WireError(
                    "this engine cannot import stream pages (built without "
                    "stream_migrate); retry page-less"
                )
                self._reject("no_import", e)
                raise e
            meta = engine.stream_page_meta()
            got = {
                k: v for k, v in dict(header["page_meta"]).items()
                if k != "cache_len"
            }
            expect = {k: v for k, v in meta.items() if k != "cache_len"}
            if got != expect:
                e = WireError(
                    f"stream page geometry {got} does not match this "
                    f"engine's {expect}"
                )
                self._reject("geometry", e)
                raise e
            try:
                pk = _pad_stream_stage(pk, int(meta["cache_len"]))
                pv = _pad_stream_stage(pv, int(meta["cache_len"]))
            except WireError as e:
                self._reject("geometry", e)
                raise
        nbytes = len(body)
        if self.budget is not None:
            try:
                self.budget.acquire(nbytes)
            except Backpressure as e:
                self._reject("budget", e)
                raise
        # Release as soon as the adoption is enqueued: the wire bytes are
        # landed host-side by then, and holding the budget across a whole
        # resumed generation would starve every later migration.
        try:
            try:
                fut = self.batcher.adopt_stream(state, pk, pv)
            except Backpressure as e:
                self._reject("budget", e)
                raise
            except (ValueError, RuntimeError) as e:
                self._reject("state", e)
                raise WireError(f"stream refused: {e}") from e
        finally:
            if self.budget is not None:
                self.budget.release(nbytes)
        with self._lock:
            self._pending[state.request_id] = fut
        if self.metrics is not None:
            self.metrics.stream_migrations.inc("adopted")
        return {
            "adopted": True,
            "request_id": state.request_id,
            "pages": pk is not None,
            "bytes": nbytes,
            "resume_at": len(state.tokens),
        }

    def wait(self, request_id: str, timeout_s: float | None = None) -> dict:
        """Block for an adopted stream's finished generation (the
        ``/v1/stream_wait`` body). Raises :class:`KeyError` for an id this
        replica never adopted (server maps it to 404 — the caller falls
        back to a resume_tokens replay)."""
        import concurrent.futures

        with self._lock:
            fut = self._pending.get(request_id)
        if fut is None:
            raise KeyError(request_id)
        try:
            out = fut.result(timeout_s)
        except (concurrent.futures.TimeoutError, TimeoutError):
            # Still generating: keep the registration so a later wait (or
            # a retry after the orchestrator's own timeout) can still
            # collect the stream instead of replaying it.
            raise
        except Exception:
            with self._lock:
                self._pending.pop(request_id, None)
            raise
        with self._lock:
            self._pending.pop(request_id, None)
        return out

    def digest(self) -> dict:
        """The ``/statusz`` ``stream_migrate`` section."""
        with self._lock:
            return {"pending_streams": len(self._pending)}


def make_stream_receiver(batcher, engine=None, *,
                         budget: TransferBudget | None = None,
                         metrics=None, recorder=None) -> StreamReceiver:
    """Factory mirroring :func:`make_kv_receiver` for the stream path."""
    return StreamReceiver(
        batcher, engine, budget=budget, metrics=metrics, recorder=recorder
    )


def migrate_streams(batcher, engine, targets, *, metrics=None,
                    recorder=None, fault_injector=None,
                    timeout_s: float = 30.0) -> dict:
    """Victim-side migration orchestration (``POST /migratez``): export
    every live stream, push each to a survivor, and resolve the
    victim-held client futures with a ``status: "migrated"`` digest the
    caller follows up on (``POST /v1/stream_wait`` against the target, or a
    ``resume_tokens`` replay when the target dies too).

    ``targets`` is a list of ``(host, port)`` pairs; streams round-robin
    across them. A push that refuses pages (``WireError`` — e.g. a
    geometry-mismatched survivor, or a corrupted buffer) retries page-less
    to the same target before moving on; a stream no target accepts
    re-adopts LOCALLY so it finishes here rather than dying — migration
    degrades, it never loses a stream. A migrated stream's outcome also
    carries the ``bytes`` of the buffer that landed (a key the JAX
    package's digest lacks). ``fault_injector`` is the serving
    :class:`~distributed_tensorflow_tpu_torch.serve.faultinject.FaultInjector`
    (``wire_corrupt`` flips a byte of the nth outbound buffer — the
    receiver's CRC refusal is the thing under drill).
    """
    recorder = recorder if recorder is not None else NULL_RECORDER
    targets = [(str(h), int(p)) for h, p in targets]
    if not targets:
        raise ValueError("migrate_streams needs at least one target")
    exported = batcher.export_streams(timeout_s)
    meta = (
        engine.stream_page_meta()
        if getattr(engine, "stream_migrate", False) else None
    )
    migrated, readopted = 0, 0
    n_sent = 0
    outcomes = []
    for i, exp in enumerate(exported):
        state = exp.state
        bufs = []
        if exp.pages_k is not None and meta is not None:
            bufs.append(serialize_stream(
                state, exp.pages_k, exp.pages_v, meta
            ))
        bufs.append(serialize_stream(state))  # page-less fallback
        landed = None
        for attempt in range(len(targets)):
            host, port = targets[(i + attempt) % len(targets)]
            for buf in bufs:
                n_sent += 1
                if fault_injector is not None and fault_injector.check_wire(
                    n_sent
                ):
                    # Corrupt the last payload byte (or the header when
                    # page-less): the receiver must refuse on CRC.
                    buf = buf[:-1] + bytes([buf[-1] ^ 0xFF])
                try:
                    out = post_stream_migrate(
                        host, port, buf, timeout_s=timeout_s
                    )
                except WireError:
                    continue  # refused (pages or corruption): next form
                except Exception:  # noqa: BLE001 — shed, dead target, ...
                    break  # this target is out; try the next one
                landed = (host, port, out)
                break
            if landed is not None:
                break
        if landed is not None:
            host, port, out = landed
            migrated += 1
            if metrics is not None:
                metrics.stream_migrations.inc("migrated")
            outcomes.append({
                "request_id": state.request_id,
                "outcome": "migrated",
                "target": f"{host}:{port}",
                "pages": bool(out.get("pages")),
                "bytes": int(out.get("bytes", 0)),
            })
            if exp.future is not None:
                exp.future.set_result({
                    "status": "migrated",
                    "target": f"{host}:{port}",
                    "request_id": state.request_id,
                    "tokens": list(state.tokens),
                    "n_tokens": len(state.tokens),
                    "prompt_len": len(state.input_ids),
                })
        else:
            # No survivor took it: keep the stream alive HERE (the drain
            # waits a little longer for it, but nothing is lost) and let
            # the original future resolve from the re-adopted run.
            readopted += 1
            if metrics is not None:
                metrics.stream_migrations.inc("readopted")
            outcomes.append({
                "request_id": state.request_id,
                "outcome": "readopted",
            })
            fut = batcher.adopt_stream(state, exp.pages_k, exp.pages_v)
            if exp.future is not None:
                _chain_future(fut, exp.future)
    digest = {
        "exported": len(exported),
        "migrated": migrated,
        "readopted": readopted,
        "streams": outcomes,
    }
    recorder.record(
        "stream_export", "", exported=len(exported), migrated=migrated,
        readopted=readopted,
    )
    return digest


def _chain_future(src, dst) -> None:
    """Mirror ``src``'s eventual result/exception onto ``dst``."""

    def _copy(f):
        err = f.exception()
        if err is not None:
            dst.set_exception(err)
        else:
            dst.set_result(f.result())

    src.add_done_callback(_copy)


def post_stream_migrate(host: str, port: int, buf: bytes, *,
                        timeout_s: float = 10.0) -> dict:
    """Victim-process half of live migration: POST a serialized stream to
    a survivor's ``/v1/stream_migrate``. Returns the adoption digest;
    raises ``Backpressure`` on a 429 shed and ``WireError`` on a 400
    refusal (mirroring the in-process paths)."""
    return _post(host, port, "/v1/stream_migrate", buf, timeout_s,
                 "stream migrate")
