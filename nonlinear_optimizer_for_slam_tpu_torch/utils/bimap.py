"""Bidirectional map, the reference's UnorderedBimap re-done (a copy of
the JAX package's ``utils/bimap.py``: pure Python).

The reference uses this for pose-index <-> Pose* bookkeeping in the
pose-graph module (unordered_bimap.h:13-96). Its ``DeleteByValue`` has a
latent bug — it calls ``key_to_value_.at(key)`` with a KEY looked up from
the wrong map, so deleting by value throws or corrupts when key and value
types collide (unordered_bimap.h:63). This implementation keeps the same
operation set with the bug fixed, and adds dict-like conveniences.
"""

from __future__ import annotations

from typing import Dict, Generic, Iterator, Tuple, TypeVar

K = TypeVar("K")
V = TypeVar("V")


class UnorderedBimap(Generic[K, V]):
    def __init__(self):
        self._k2v: Dict[K, V] = {}
        self._v2k: Dict[V, K] = {}

    def insert(self, key: K, value: V) -> bool:
        """Insert a (key, value) pair; rejects duplicate keys OR values
        (matching the reference's either-side uniqueness)."""
        if key in self._k2v or value in self._v2k:
            return False
        self._k2v[key] = value
        self._v2k[value] = key
        return True

    def get_value(self, key: K) -> V:
        return self._k2v[key]

    def get_key(self, value: V) -> K:
        return self._v2k[value]

    def has_key(self, key: K) -> bool:
        return key in self._k2v

    def has_value(self, value: V) -> bool:
        return value in self._v2k

    def delete_by_key(self, key: K) -> bool:
        if key not in self._k2v:
            return False
        value = self._k2v.pop(key)
        del self._v2k[value]
        return True

    def delete_by_value(self, value: V) -> bool:
        """Reference's buggy path (unordered_bimap.h:63), done right."""
        if value not in self._v2k:
            return False
        key = self._v2k.pop(value)
        del self._k2v[key]
        return True

    def __len__(self) -> int:
        return len(self._k2v)

    def __contains__(self, key: K) -> bool:
        return key in self._k2v

    def items(self) -> Iterator[Tuple[K, V]]:
        return iter(self._k2v.items())
