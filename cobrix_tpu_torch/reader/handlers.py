"""Record handlers: the target-agnostic record assembly seam.

Mirrors the reference's `RecordHandler[T]` abstraction
(reader/extractors/record/RecordHandler.scala:21-25, proven by
cobol-converters' SerializersSpec.scala:26): extraction walks the AST and
delegates the materialization of each group to a handler, so the same
decode produces Spark-Row-like tuples, dicts, JSON — or any user type —
without touching reader internals. Both the scalar extractor
(reader.extractors.extract_record) and the columnar row path
(DecodedBatch.to_rows) accept a handler.

Port copy of ``cobrix_tpu.reader.handlers``, unchanged.
"""
from __future__ import annotations

from typing import List, Sequence

from ..copybook.ast import Group


class RecordHandler:
    """create(values, group) -> record; to_seq(record) -> field values.

    `values` are the group's non-filler child values in declaration order
    (nested groups arrive already created by this handler). Hierarchical
    extraction calls `create_named` instead: its value order differs from
    declaration order (child-segment records are appended after the
    parent's own fields), so the matching names come with the values."""

    def create(self, values: List[object], group: Group) -> object:
        raise NotImplementedError

    def create_named(self, values: List[object], names: List[str],
                     group: Group) -> object:
        return self.create(values, group)

    def to_seq(self, record: object) -> Sequence[object]:
        raise NotImplementedError


class TupleHandler(RecordHandler):
    """The default: groups become tuples (the GenericRow analogue,
    SparkCobolRowType.scala:24)."""

    def create(self, values, group):
        return tuple(values)

    def to_seq(self, record):
        return record


class DictHandler(RecordHandler):
    """Groups become {field_name: value} dicts (the StructHandler of
    SerializersSpec.scala:134-147)."""

    def __init__(self):
        # per-group name lists, cached: the compiled row maker calls
        # create() once per group per row
        self._names: dict = {}

    def _group_names(self, group: Group) -> List[str]:
        names = self._names.get(id(group))
        if names is None:
            names = [ch.name for ch in group.children if not ch.is_filler]
            self._names[id(group)] = names
        return names

    def create(self, values, group):
        return dict(zip(self._group_names(group), values))

    def create_named(self, values, names, group):
        return dict(zip(names, values))

    def to_seq(self, record):
        return list(record.values())


class JsonHandler(DictHandler):
    """Like DictHandler, with a helper to render one extracted record as a
    JSON document (the SerializersSpec JSON-generation shape)."""

    def render(self, values: List[object], root: Group) -> str:
        import json
        from decimal import Decimal

        def default(o):
            if isinstance(o, Decimal):
                return int(o) if o == o.to_integral_value() else float(o)
            if isinstance(o, bytes):
                return o.decode("latin-1")
            return str(o)

        return json.dumps(self.create(values, root), default=default,
                          separators=(",", ":"))


DEFAULT_HANDLER = TupleHandler()
