"""Case-insensitive node-name registry.

Contract: spicey/lib/parsing/NodeIndex.ts:1-37.
Ground ``"0"`` is pre-registered with id 0; lookups are case-insensitive but
``rev`` preserves the first-seen spelling (canonical names in results);
``matrix_index_of_node(0) == -1`` (ground is eliminated from the MNA system),
otherwise ``id - 1``.
"""

from __future__ import annotations


class NodeIndex:
    def __init__(self) -> None:
        self._map: dict[str, int] = {"0": 0}
        self.rev: list[str] = ["0"]

    def get_or_create(self, name: object) -> int:
        orig = str(name)
        key = orig.upper()
        if key in self._map:
            return self._map[key]
        idx = len(self.rev)
        self._map[key] = idx
        self.rev.append(orig)
        return idx

    def get(self, name: object) -> int | None:
        return self._map.get(str(name).upper())

    def count(self) -> int:
        return len(self.rev)

    def matrix_index_of_node(self, node_id: int) -> int:
        if node_id == 0:
            return -1
        return node_id - 1
