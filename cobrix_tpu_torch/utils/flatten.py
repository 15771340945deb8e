"""Schema/data flattening utilities.

Port copy of ``cobrix_tpu.utils.flatten``: the equivalent of the
reference's `SparkUtils` DataFrame helpers (spark-cobol
utils/SparkUtils.scala): `flattenSchema` (:60) turns nested structs and
arrays into a flat column list — array fields are projected to their
maximum observed element count, struct fields get underscore-joined
names — and `convertDataframeFieldsToStrings` (:172) casts every leaf
column to string. Both operate on `CobolData` (rows + StructType)
instead of a DataFrame.

Change from the JAX package: the port's `CobolData` holds decoded
parts, not rows, so a transform's rows are one row-backed
``FileResult`` (`_row_data`); rows, dicts, JSON lines and Arrow of the
result are the JAX package's.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from ..reader.schema import ArrayType, Field, STRING, StructType

# schema paths are tuples of struct field indices; "*" marks descent into
# array elements (maxima are aggregated across all elements of all rows)
_Path = Tuple[object, ...]


def _scan_maxima(value, dtype, path: _Path, maxima: Dict[_Path, int]) -> None:
    if isinstance(dtype, ArrayType):
        elems = value if isinstance(value, (list, tuple)) else []
        maxima[path] = max(maxima.get(path, 0), len(elems))
        for v in elems:
            _scan_maxima(v, dtype.element, path + ("*",), maxima)
    elif isinstance(dtype, StructType):
        if value is None:
            value = [None] * len(dtype.fields)
        for i, (f, v) in enumerate(zip(dtype.fields, value)):
            _scan_maxima(v, f.dtype, path + (i,), maxima)


def _build_fields(dtype, path: _Path, prefix: str, name: str,
                  maxima: Dict[_Path, int], out: List[Field]) -> None:
    if isinstance(dtype, StructType):
        for i, f in enumerate(dtype.fields):
            _build_fields(f.dtype, path + (i,), f"{prefix}{name}_", f.name,
                          maxima, out)
    elif isinstance(dtype, ArrayType):
        for k in range(1, maxima.get(path, 0) + 1):
            _build_fields(dtype.element, path + ("*",), prefix,
                          f"{name}_{k}", maxima, out)
    else:
        out.append(Field(f"{prefix}{name}", dtype))


def _build_values(value, dtype, path: _Path, maxima: Dict[_Path, int],
                  out: List[object]) -> None:
    if isinstance(dtype, StructType):
        vals = list(value) if value is not None else [None] * len(dtype.fields)
        for i, (f, v) in enumerate(zip(dtype.fields, vals)):
            _build_values(v, f.dtype, path + (i,), maxima, out)
    elif isinstance(dtype, ArrayType):
        elems = value if isinstance(value, (list, tuple)) else []
        for k in range(maxima.get(path, 0)):
            e = elems[k] if k < len(elems) else None
            _build_values(e, dtype.element, path + ("*",), maxima, out)
    else:
        out.append(value)


def flatten_schema(data) -> "CobolData":
    """Flat projection of nested rows: structs are splatted into
    underscore-joined columns, arrays (at any nesting depth) into
    `name_1..name_N` columns where N is the maximum observed element count
    (reference SparkUtils.flattenSchema, utils/SparkUtils.scala:60, which
    runs a max(size(col)) aggregation for the same purpose)."""
    schema = data.schema
    rows = data.to_rows()

    maxima: Dict[_Path, int] = {}
    for row in rows:
        for i, (f, v) in enumerate(zip(schema.fields, row)):
            _scan_maxima(v, f.dtype, (i,), maxima)

    flat_fields: List[Field] = []
    for i, f in enumerate(schema.fields):
        _build_fields(f.dtype, (i,), "", f.name, maxima, flat_fields)

    flat_rows: List[list] = []
    for row in rows:
        out: List[object] = []
        for i, (f, v) in enumerate(zip(schema.fields, row)):
            _build_values(v, f.dtype, (i,), maxima, out)
        flat_rows.append(out)

    return _row_data(flat_rows, StructType(flat_fields))


def convert_fields_to_strings(data) -> "CobolData":
    """Every leaf value cast to its string form, schema all-string
    (reference SparkUtils.convertDataframeFieldsToStrings,
    utils/SparkUtils.scala:172). Nested structure is preserved."""
    schema = data.schema

    def conv_type(dtype):
        if isinstance(dtype, StructType):
            return StructType([Field(f.name, conv_type(f.dtype), f.nullable)
                               for f in dtype.fields])
        if isinstance(dtype, ArrayType):
            return ArrayType(conv_type(dtype.element), dtype.contains_null)
        return STRING

    def conv_value(value, dtype):
        if value is None:
            return None
        if isinstance(dtype, StructType):
            return tuple(conv_value(v, f.dtype)
                         for f, v in zip(dtype.fields, value))
        if isinstance(dtype, ArrayType):
            return [conv_value(v, dtype.element) for v in value]
        if isinstance(value, bytes):
            return value.hex().upper()
        return str(value)

    new_schema = StructType([Field(f.name, conv_type(f.dtype), f.nullable)
                             for f in schema.fields])
    new_rows = [[conv_value(v, f.dtype)
                 for f, v in zip(schema.fields, row)]
                for row in data.to_rows()]
    return _row_data(new_rows, new_schema)


class _FlatSchema:
    """Minimal CobolOutputSchema stand-in wrapping an already-built
    StructType (the transforms above produce their schema directly)."""

    def __init__(self, schema: StructType):
        self.schema = schema


def _row_data(rows: List[list], schema: StructType) -> "CobolData":
    """A CobolData of `rows` under `schema`: one row-backed part."""
    from ..api import CobolData
    from ..reader.result import FileResult

    return CobolData([], _FlatSchema(schema),
                     [FileResult(n_rows=len(rows), rows=rows)])
