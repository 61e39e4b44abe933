"""Hierarchical info tree printed after execution.

Mirrors GATB's IProperties report used by the reference Tool framework
(getInfo()->add(level, key, fmt...), printed after execute(); captured
examples: reference test/full_test/gold_find.output)."""

from __future__ import annotations


class Properties:
    def __init__(self):
        self.entries: list[tuple[int, str, str | None]] = []

    def add(self, level: int, key: str, fmt: str | None = None, *args):
        value = None
        if fmt is not None:
            value = (fmt % args) if args else str(fmt)
        self.entries.append((level, key, value))

    def dump(self) -> str:
        lines = []
        for level, key, value in self.entries:
            head = " " * (4 * level) + key
            if value is None:
                lines.append(head.ljust(40))
            else:
                lines.append(head.ljust(41) + "    : " + value)
        return "\n".join(lines) + "\n"
