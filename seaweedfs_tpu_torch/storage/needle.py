"""Needle: one stored blob and its on-disk serialization.

Byte-compatible with the reference's three versions
(weed/storage/needle/needle.go:25-45, needle_read_write.go:41-133,216-344):

v1: header(16) | data | crc(4) | pad
v2: header(16) | dataSize(4) data flags(1) [nameSize name] [mimeSize mime]
    [lastModified(5)] [ttl(2)] [pairsSize(2) pairs] | crc(4) | pad
v3: v2 body | crc(4) | appendAtNs(8) | pad

header = cookie(4) id(8) size(4); all big-endian; total record padded to 8
(padding is 8, not 0, when already aligned — see types.padding_length).
Size counts the v2 body bytes (dataSize field through pairs); crc covers Data
only, stored masked (crc.masked_value).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from . import types as t
from .crc import crc32c, masked_value
from .ttl import TTL

FLAG_IS_COMPRESSED = 0x01
FLAG_HAS_NAME = 0x02
FLAG_HAS_MIME = 0x04
FLAG_HAS_LAST_MODIFIED_DATE = 0x08
FLAG_HAS_TTL = 0x10
FLAG_HAS_PAIRS = 0x20
FLAG_IS_CHUNK_MANIFEST = 0x80

LAST_MODIFIED_BYTES_LENGTH = 5
TTL_BYTES_LENGTH = 2


class SizeMismatchError(Exception):
    pass


class CrcError(Exception):
    pass


@dataclass
class Needle:
    cookie: int = 0
    id: int = 0
    size: int = 0  # v2 body size, computed on write

    data: bytes = b""
    flags: int = 0
    name: bytes = b""
    mime: bytes = b""
    pairs: bytes = b""  # json-encoded extra headers
    last_modified: int = 0  # unix seconds, 5 bytes stored
    ttl: TTL | None = None

    checksum: int = 0  # masked crc32c of data
    append_at_ns: int = 0

    # -- flags ------------------------------------------------------------
    def is_compressed(self) -> bool:
        return bool(self.flags & FLAG_IS_COMPRESSED)

    def set_is_compressed(self) -> None:
        self.flags |= FLAG_IS_COMPRESSED

    def has_name(self) -> bool:
        return bool(self.flags & FLAG_HAS_NAME)

    def set_name(self, name: bytes) -> None:
        self.name = name[:255]
        if name:
            self.flags |= FLAG_HAS_NAME

    def has_mime(self) -> bool:
        return bool(self.flags & FLAG_HAS_MIME)

    def set_mime(self, mime: bytes) -> None:
        self.mime = mime[:255]
        if mime:
            self.flags |= FLAG_HAS_MIME

    def has_last_modified_date(self) -> bool:
        return bool(self.flags & FLAG_HAS_LAST_MODIFIED_DATE)

    def set_last_modified(self, ts: int) -> None:
        self.last_modified = ts
        self.flags |= FLAG_HAS_LAST_MODIFIED_DATE

    def has_ttl(self) -> bool:
        return bool(self.flags & FLAG_HAS_TTL)

    def set_ttl(self, ttl: TTL) -> None:
        self.ttl = ttl
        if ttl.count:
            self.flags |= FLAG_HAS_TTL

    def has_pairs(self) -> bool:
        return bool(self.flags & FLAG_HAS_PAIRS)

    def set_pairs(self, pairs: bytes) -> None:
        self.pairs = pairs
        if pairs:
            self.flags |= FLAG_HAS_PAIRS

    def is_chunked_manifest(self) -> bool:
        return bool(self.flags & FLAG_IS_CHUNK_MANIFEST)

    def etag(self) -> str:
        return struct.pack(">I", self.checksum).hex()

    # -- serialization ----------------------------------------------------
    def _body_size_v2(self) -> int:
        if not self.data:
            return 0
        size = 4 + len(self.data) + 1
        if self.has_name():
            size += 1 + len(self.name)
        if self.has_mime():
            size += 1 + len(self.mime)
        if self.has_last_modified_date():
            size += LAST_MODIFIED_BYTES_LENGTH
        if self.has_ttl():
            size += TTL_BYTES_LENGTH
        if self.has_pairs():
            size += 2 + len(self.pairs)
        return size

    def to_bytes(self, version: int = t.CURRENT_VERSION) -> bytes:
        """Serialize the full padded record (prepareWriteBuffer,
        needle_read_write.go:41-133). Sets self.size/checksum."""
        self.checksum = masked_value(crc32c(self.data))
        out = bytearray()
        if version == t.VERSION1:
            self.size = len(self.data)
            out += t.cookie_to_bytes(self.cookie)
            out += t.needle_id_to_bytes(self.id)
            out += t.size_to_bytes(self.size)
            out += self.data
            out += struct.pack(">I", self.checksum)
            out += b"\0" * t.padding_length(self.size, version)
            return bytes(out)
        if version not in (t.VERSION2, t.VERSION3):
            raise ValueError(f"unsupported needle version {version}")
        if len(self.name) >= 255:
            self.name = self.name[:255]
        self.size = self._body_size_v2()
        out += t.cookie_to_bytes(self.cookie)
        out += t.needle_id_to_bytes(self.id)
        out += t.size_to_bytes(self.size)
        if self.data:
            out += struct.pack(">I", len(self.data))
            out += self.data
            out.append(self.flags & 0xFF)
            if self.has_name():
                out.append(len(self.name))
                out += self.name
            if self.has_mime():
                out.append(len(self.mime))
                out += self.mime
            if self.has_last_modified_date():
                out += self.last_modified.to_bytes(8, "big")[8 - LAST_MODIFIED_BYTES_LENGTH:]
            if self.has_ttl():
                out += (self.ttl or TTL()).to_bytes()
            if self.has_pairs():
                out += struct.pack(">H", len(self.pairs))
                out += self.pairs
        out += struct.pack(">I", self.checksum)
        if version == t.VERSION3:
            out += struct.pack(">Q", self.append_at_ns)
        out += b"\0" * t.padding_length(self.size, version)
        return bytes(out)

    def parse_header(self, raw: bytes) -> None:
        self.cookie = t.bytes_to_cookie(raw[0:4])
        self.id = t.bytes_to_needle_id(raw[4:12])
        self.size = t.bytes_to_size(raw[12:16])

    def _parse_body_v2(self, body: bytes) -> None:
        """readNeedleDataVersion2 (needle_read_write.go:270-344)."""
        i, n = 0, len(body)
        if i < n:
            data_size = struct.unpack_from(">I", body, i)[0]
            i += 4
            if data_size + i > n:
                raise ValueError("needle body truncated at data")
            self.data = body[i:i + data_size]
            i += data_size
            self.flags = body[i]
            i += 1
        if i < n and self.has_name():
            name_size = body[i]
            i += 1
            self.name = body[i:i + name_size]
            i += name_size
        if i < n and self.has_mime():
            mime_size = body[i]
            i += 1
            self.mime = body[i:i + mime_size]
            i += mime_size
        if i < n and self.has_last_modified_date():
            self.last_modified = int.from_bytes(
                body[i:i + LAST_MODIFIED_BYTES_LENGTH], "big")
            i += LAST_MODIFIED_BYTES_LENGTH
        if i < n and self.has_ttl():
            self.ttl = TTL.from_bytes(body[i:i + TTL_BYTES_LENGTH])
            i += TTL_BYTES_LENGTH
        if i < n and self.has_pairs():
            pairs_size = struct.unpack_from(">H", body, i)[0]
            i += 2
            self.pairs = body[i:i + pairs_size]
            i += pairs_size

    def read_bytes(self, raw: bytes, offset: int, size: int,
                   version: int) -> None:
        """Hydrate from a full record buffer; verifies size + CRC
        (ReadBytes, needle_read_write.go:216-252)."""
        self.parse_header(raw)
        if self.size != size:
            raise SizeMismatchError(
                f"offset {offset}: found size {self.size}, expected {size}")
        body = raw[t.NEEDLE_HEADER_SIZE:t.NEEDLE_HEADER_SIZE + size]
        if version == t.VERSION1:
            self.data = body
        else:
            self._parse_body_v2(body)
        if size > 0:
            stored = struct.unpack_from(">I", raw, t.NEEDLE_HEADER_SIZE + size)[0]
            actual = masked_value(crc32c(self.data))
            if stored != actual:
                raise CrcError("CRC error! data on disk corrupted")
            self.checksum = actual
        if version == t.VERSION3:
            ts_off = t.NEEDLE_HEADER_SIZE + size + t.NEEDLE_CHECKSUM_SIZE
            self.append_at_ns = struct.unpack_from(">Q", raw, ts_off)[0]
