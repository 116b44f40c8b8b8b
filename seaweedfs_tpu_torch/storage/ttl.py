"""Volume/needle TTL: (count, unit) packed in 2 bytes
(weed/storage/needle/volume_ttl.go:8-121).

Readable form: "3m" / "4h" / "5d" / "6w" / "7M" / "8y"; bare digits mean
minutes. Stored: byte0=count, byte1=unit enum.
"""

from __future__ import annotations

from dataclasses import dataclass

EMPTY, MINUTE, HOUR, DAY, WEEK, MONTH, YEAR = range(7)

_UNIT_BY_CHAR = {"m": MINUTE, "h": HOUR, "d": DAY, "w": WEEK, "M": MONTH, "y": YEAR}


@dataclass(frozen=True)
class TTL:
    count: int = 0
    unit: int = EMPTY

    @classmethod
    def parse(cls, s: str) -> "TTL":
        if not s:
            return EMPTY_TTL
        unit_ch = s[-1]
        if unit_ch.isdigit():
            return cls(int(s), MINUTE)
        if unit_ch not in _UNIT_BY_CHAR:
            raise ValueError(f"unknown ttl unit in {s!r}")
        return cls(int(s[:-1] or "0"), _UNIT_BY_CHAR[unit_ch])

    @classmethod
    def from_bytes(cls, b: bytes) -> "TTL":
        if b[0] == 0 and b[1] == 0:
            return EMPTY_TTL
        return cls(b[0], b[1])

    def to_bytes(self) -> bytes:
        return bytes([self.count & 0xFF, self.unit & 0xFF])


EMPTY_TTL = TTL()
