"""FNV-1a 64-bit hashing (reference ``Source/Core/hash.h:7-26``) — used for
dedup keys (texture paths)."""

from __future__ import annotations

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK = 0xFFFFFFFFFFFFFFFF


def fnv_hash_data(data: bytes, basis: int = _FNV_OFFSET) -> int:
    h = basis
    for b in data:
        h ^= b
        h = (h * _FNV_PRIME) & _MASK
    return h


def fnv_hash_str(s: str, basis: int = _FNV_OFFSET) -> int:
    return fnv_hash_data(s.encode("utf-8"), basis)
