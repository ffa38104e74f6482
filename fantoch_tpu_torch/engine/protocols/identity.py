"""Value identity for device-protocol objects: two instances of one class
with equal attributes are interchangeable (runner caches key on them)."""

from __future__ import annotations


class DevIdentity:
    def __eq__(self, other) -> bool:
        return type(other) is type(self) and vars(other) == vars(self)

    def __hash__(self) -> int:
        return hash((type(self),) + tuple(sorted(vars(self).items())))
