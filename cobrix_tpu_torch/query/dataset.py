"""A ``pyarrow.dataset``-shaped scan surface over mainframe files.

Port copy of ``cobrix_tpu.query.dataset``. ``dataset(path,
copybook=...)`` returns a :class:`CobolDataset` that duck-types the
pyarrow Dataset API — ``schema``, ``scanner(columns=, filter=)``,
``to_table``, ``to_batches``, ``head``, ``count_rows``,
``get_fragments`` — with one file per :class:`CobolFragment`. The
scanner accepts filters in any of three forms:

* a ``query.Expr`` (or its string grammar / wire JSON),
* a **pyarrow compute expression** (``pc.field("A") == "x"``) — lowered
  into the query AST through its canonical string form, so the same
  pushdown pipeline (plan pruning, pre-decode drops, late
  materialization) runs under engines that speak pyarrow expressions,
* nothing.

A pyarrow expression outside the supported subset falls back to a
post-hoc in-memory filter (correct, unpruned) rather than failing.

Changes from the JAX package: reads go through the port's
``read_cobol`` on `device` (None: the CUDA device; ``"cpu"``: the plain
versions) in place of a `backend`; the schema probe hands the code page
and the policies to ``parse_options`` by name, as ``read_cobol`` does.
``_aggregate_from_stats`` answers
nothing (None) until the stats store is ported (ROADMAP A8), so every
aggregate and count decodes. ``parse_specs`` (the JAX package's
``stats.aggregate``) and ``leaf_columns`` (its ``stats.collect``) are
copied here until ``stats/`` is ported.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from .expr import Expr, normalize_filter, parse_filter


def _lower_filter(filter_):
    """(wire string | None, posthoc pyarrow expression | None)."""
    if filter_ is None:
        return None, None
    if isinstance(filter_, (Expr, str)):
        return normalize_filter(filter_), None
    # a pyarrow compute expression: its repr is a parseable spelling of
    # the supported subset; anything else falls back to post-hoc
    try:
        return normalize_filter(parse_filter(str(filter_))), None
    except (ValueError, TypeError):
        return None, filter_


class CobolScanner:
    """One materialization plan over a dataset (or one fragment)."""

    def __init__(self, ds: "CobolDataset", files: List[str],
                 columns: Optional[Sequence[str]],
                 filter_=None, batch_size: int = 131072):
        self.dataset = ds
        self.files = files
        self.columns = list(columns) if columns is not None else None
        if self.columns is not None:
            known = set(ds.schema.names)
            bad = [c for c in self.columns if c not in known]
            if bad:
                raise KeyError(
                    f"column(s) {bad} not in the dataset schema")
        self.batch_size = int(batch_size)
        self._wire, self._posthoc = _lower_filter(filter_)
        if self._wire is not None:
            from .expr import from_wire

            expr = from_wire(self._wire)
            if any(f in ds.generated_columns for f in expr.fields()):
                # predicates on generated columns (Record_Id, File_Id,
                # Seg_Id*) have no copybook field to push down against;
                # honor the documented contract and filter post-hoc
                self._wire = None
                self._posthoc = expr.to_pyarrow()

    @property
    def projected_schema(self):
        schema = self.dataset.schema
        if self.columns is None:
            return schema
        import pyarrow as pa

        return pa.schema([schema.field(c) for c in self.columns])

    def _read_table(self, files: List[str]):
        from ..api import read_cobol

        options = dict(self.dataset.options)
        if self.columns is not None:
            options["select"] = ",".join(
                c for c in self.columns
                if c not in self.dataset.generated_columns)
        if self._wire is not None:
            options["filter"] = self._wire
        data = read_cobol(files if len(files) > 1 else files[0],
                          copybook_contents=self.dataset.copybook_contents,
                          device=self.dataset.device, **options)
        table = data.to_arrow()
        if self._posthoc is not None:
            import pyarrow.dataset as pads

            table = pads.dataset(table).to_table(filter=self._posthoc)
        if self.columns is not None:
            table = table.select(self.columns)
        return table

    def to_table(self):
        return self._read_table(self.files)

    def to_batches(self):
        # ONE read over every file, like to_table: per-file reads would
        # restart File_Id/Record_Id bases at 0 for each file and the
        # two materialization paths would disagree on record identity
        table = self._read_table(self.files)
        yield from table.to_batches(max_chunksize=self.batch_size)

    def to_reader(self):
        import pyarrow as pa

        return pa.RecordBatchReader.from_batches(
            self.projected_schema, self.to_batches())

    def count_rows(self) -> int:
        return self.to_table().num_rows

    def head(self, num_rows: int):
        return self.to_table().slice(0, num_rows)


class CobolFragment:
    """One input file of the dataset (the pyarrow Fragment analogue);
    its scanner runs the same pushdown pipeline over just that file."""

    def __init__(self, ds: "CobolDataset", path: str):
        self.dataset = ds
        self.path = path

    @property
    def physical_schema(self):
        return self.dataset.schema

    def scanner(self, columns: Optional[Sequence[str]] = None,
                filter=None, batch_size: int = 131072,
                **_ignored) -> CobolScanner:
        return CobolScanner(self.dataset, [self.path], columns, filter,
                            batch_size)

    def to_table(self, columns: Optional[Sequence[str]] = None,
                 filter=None):
        return self.scanner(columns, filter).to_table()

    def count_rows(self, filter=None) -> int:
        return self.scanner(self.dataset._narrowest_columns(filter),
                            filter).count_rows()

    def __repr__(self) -> str:
        return f"<CobolFragment {self.path!r}>"


class CobolDataset:
    """Duck-typed ``pyarrow.dataset.Dataset`` over mainframe files."""

    def __init__(self, files: List[str], copybook_contents,
                 device, options: dict, schema,
                 generated_columns: frozenset):
        self.files = files
        self.copybook_contents = copybook_contents
        self.device = device
        self.options = dict(options)
        self.schema = schema
        self.generated_columns = generated_columns

    def scanner(self, columns: Optional[Sequence[str]] = None,
                filter=None, batch_size: int = 131072,
                **_ignored) -> CobolScanner:
        """The pyarrow Scanner analogue. `columns` projects (and prunes
        the decode plan); `filter` pushes down (see module docs)."""
        return CobolScanner(self, self.files, columns, filter,
                            batch_size)

    def get_fragments(self, filter=None) -> List[CobolFragment]:
        return [CobolFragment(self, f) for f in self.files]

    def to_table(self, columns: Optional[Sequence[str]] = None,
                 filter=None):
        return self.scanner(columns, filter).to_table()

    def to_batches(self, columns: Optional[Sequence[str]] = None,
                   filter=None, batch_size: int = 131072):
        return self.scanner(columns, filter, batch_size).to_batches()

    def head(self, num_rows: int,
             columns: Optional[Sequence[str]] = None, filter=None):
        return self.scanner(columns, filter).head(num_rows)

    def _narrowest_columns(self, filter_) -> Optional[List[str]]:
        """A minimal projection for count_rows: the filter's own
        fields when there is a filter, else the first schema column —
        row counts never pay a full-width decode."""
        wire, posthoc = _lower_filter(filter_)
        if posthoc is not None:
            return None  # post-hoc filters need whatever they need
        if wire is not None:
            from .expr import from_wire

            names = [n for n in from_wire(wire).fields()
                     if n in set(self.schema.names)]
            if names:
                return names
        return [self.schema.names[0]] if self.schema.names else None

    def count_rows(self, filter=None) -> int:
        if filter is None:
            fast = self._aggregate_from_stats([("count", None)])
            if fast is not None:
                return fast["count"]
        return self.scanner(self._narrowest_columns(filter),
                            filter).count_rows()

    def aggregate(self, aggs: Sequence[str], filter=None) -> dict:
        """Evaluate simple aggregates over the dataset.

        `aggs` is a list of specs: ``"count"``, ``"min:FIELD"``,
        ``"max:FIELD"``, ``"sum:FIELD"``. Returns ``{spec: value}``
        (``None`` = SQL NULL over no values; nulls are ignored by
        min/max/sum, counted by count).

        The JAX package answers from persisted statistics with
        ``use_stats=true``; the port has no stats store yet, so it
        always decodes (`_aggregate_by_decode`).
        """
        specs = parse_specs(aggs)
        if filter is None:
            fast = self._aggregate_from_stats(specs)
            if fast is not None:
                return fast
        return self._aggregate_by_decode(specs, filter)

    def _aggregate_from_stats(self, specs) -> Optional[dict]:
        """Stats-only answer, or None (then the caller decodes). The
        port has no stats store yet (ROADMAP A8; its `use_stats` option
        is refused), so this is always None."""
        return None

    def _aggregate_by_decode(self, specs, filter_) -> dict:
        """The ground-truth path: decode, then pyarrow compute. The
        semantics here DEFINE what the stats path must reproduce."""
        import pyarrow.compute as pc

        wanted = sorted({field for _, field in specs if field})
        known = set(self.schema.names)
        cols = (wanted if wanted and all(f in known for f in wanted)
                else None)  # nested leaves need the full-width decode
        table = self.to_table(columns=cols, filter=filter_)
        leaves = leaf_columns(table)
        out: dict = {}
        for fn, field in specs:
            if fn == "count":
                out["count"] = table.num_rows
                continue
            if field not in leaves:
                raise KeyError(
                    f"aggregate field {field!r} is not a primitive "
                    "column of the decoded output")
            _kind, col = leaves[field]
            if fn == "sum":
                out[f"sum:{field}"] = pc.sum(col).as_py()
            else:
                mm = pc.min_max(col).as_py()
                out[f"{fn}:{field}"] = mm[fn]
        return out

    def __repr__(self) -> str:
        return (f"<CobolDataset files={len(self.files)} "
                f"columns={len(self.schema.names)}>")


# the arguments of read_cobol that the port's parse_options takes by name
_NAMED_READ_ARGS = ("ebcdic_code_page", "schema_retention_policy",
                    "string_trimming_policy", "floating_point_format")


def dataset(path, copybook: Optional[str] = None,
            copybook_contents=None, device=None,
            **options) -> CobolDataset:
    """Open mainframe file(s) as a pyarrow-dataset-shaped object.

    `path`/`copybook`/`device`/`options` follow ``read_cobol``; the returned
    dataset's schema is derived up front from the copybook + options
    (no data is read until a scanner materializes)."""
    from ..api import (list_input_files, load_copybook_contents,
                       parse_options)
    from ..plan.cache import copybook_for_params
    from ..reader.arrow_out import arrow_schema
    from ..reader.schema import output_schema_for

    contents = load_copybook_contents(copybook, copybook_contents)
    files = list_input_files(path)
    if not files:
        raise FileNotFoundError(f"No input files found for path {path}")
    # schema derivation must see the caller's options, but select/filter
    # belong to each SCANNER, not the dataset identity
    probe_options = {k: v for k, v in options.items()
                     if k not in ("select", "filter")}
    # read_cobol takes the code page and the three policies as named
    # arguments, which the port's parse_options takes apart
    named = {k: str(probe_options[k]) for k in _NAMED_READ_ARGS
             if k in probe_options}
    params = parse_options({k: v for k, v in probe_options.items()
                            if k not in named}, **named)
    copybook_obj = copybook_for_params(contents, params)
    output_schema = output_schema_for(copybook_obj, params,
                                      params.needs_var_len_reader)
    schema = arrow_schema(output_schema.schema)
    generated = frozenset(
        n for n in schema.names
        if n in ("File_Id", "Record_Id", "Record_Byte_Length")
        or n.startswith("Seg_Id")
        or (params.input_file_name_column
            and n == params.input_file_name_column)
        or (params.corrupt_record_column
            and n == params.corrupt_record_column))
    return CobolDataset(files, contents, device, probe_options, schema,
                        generated)


# -- copies of the JAX package's stats helpers (until stats/ is ported) -----

_GENERATED = ("Record_Id", "File_Id", "Record_Byte_Length")


def parse_specs(aggs: Sequence[str]) -> List[Tuple[str, Optional[str]]]:
    """``["count", "min:FIELD", ...]`` -> ``[(fn, field|None), ...]``
    (validated; the one spelling both the stats and decode paths
    share)."""
    out: List[Tuple[str, Optional[str]]] = []
    for spec in aggs:
        fn, sep, field = str(spec).partition(":")
        fn = fn.strip().lower()
        field = field.strip()
        if fn == "count" and not field:
            out.append(("count", None))
            continue
        if fn in ("min", "max", "sum") and sep and field:
            out.append((fn, field))
            continue
        raise ValueError(
            f"unsupported aggregate spec {spec!r} (use 'count', "
            f"'min:FIELD', 'max:FIELD', or 'sum:FIELD')")
    if not out:
        raise ValueError("aggregate() needs at least one spec")
    return out


def _kind_of(arrow_type) -> Optional[str]:
    import pyarrow as pa

    if pa.types.is_boolean(arrow_type):
        return "bool"
    if pa.types.is_integer(arrow_type):
        return "int"
    if pa.types.is_floating(arrow_type):
        return "float"
    if pa.types.is_decimal(arrow_type):
        return "decimal"
    if (pa.types.is_string(arrow_type)
            or pa.types.is_large_string(arrow_type)):
        return "string"
    return None  # binary / nested / anything else: not profiled


def leaf_columns(table) -> Dict[str, Tuple[str, object]]:
    """{leaf name -> (kind, column)} for every profilable column of an
    assembled table: structs flattened, lists and generated columns
    dropped, DUPLICATE leaf names dropped entirely (a filter name that
    is ambiguous in the copybook must not consult either column's zone
    map)."""
    import pyarrow as pa

    while any(pa.types.is_struct(f.type) for f in table.schema):
        table = table.flatten()
    out: Dict[str, Tuple[str, object]] = {}
    dupes = set()
    for name, col in zip(table.column_names, table.columns):
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _GENERATED or leaf.startswith("Seg_Id"):
            continue
        kind = _kind_of(col.type)
        if kind is None:
            continue
        if leaf in dupes or leaf in out:
            out.pop(leaf, None)
            dupes.add(leaf)
            continue
        out[leaf] = (kind, col)
    return out

