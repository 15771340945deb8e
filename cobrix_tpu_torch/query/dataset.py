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
With ``use_stats=true`` ``aggregate`` and ``count_rows`` answer from
persisted profiles (``stats.aggregate``), as in the JAX package; the
stats package is imported only inside those calls.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

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

        With ``use_stats=true``, no filter, and a warm profile for
        EVERY input file, the answer comes from persisted statistics
        without decoding a byte (stats/aggregate.py) — and is exact by
        construction: anything short of proof (missing profile,
        NaN-tainted chunk, float sum, unknown field) silently falls
        back to the decode path below, never an approximate answer.
        """
        from ..stats.aggregate import parse_specs

        specs = parse_specs(aggs)
        if filter is None:
            fast = self._aggregate_from_stats(specs)
            if fast is not None:
                return fast
        return self._aggregate_by_decode(specs, filter)

    def _aggregate_from_stats(self, specs) -> Optional[dict]:
        """Stats-only answer, or None (then the caller decodes)."""
        params = _parse_dataset_options(self.options)
        if not params.use_stats:
            return None
        from ..plan.cache import copybook_for_params
        from ..stats.aggregate import (aggregates_from_profiles,
                                       load_all_profiles)

        profiles = load_all_profiles(self.files, self.copybook_contents,
                                     params)
        if profiles is None:
            return None
        copybook = copybook_for_params(self.copybook_contents, params)
        return aggregates_from_profiles(profiles, copybook, specs)

    def _aggregate_by_decode(self, specs, filter_) -> dict:
        """The ground-truth path: decode, then pyarrow compute. The
        semantics here DEFINE what the stats path must reproduce."""
        import pyarrow.compute as pc

        from ..stats.collect import leaf_columns

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


def _parse_dataset_options(options):
    """A dataset's options as ReaderParameters: read_cobol takes the
    code page and the three policies as named arguments, which the
    port's parse_options takes apart."""
    from ..api import parse_options

    named = {k: str(options[k]) for k in _NAMED_READ_ARGS
             if k in options}
    return parse_options({k: v for k, v in options.items()
                          if k not in named}, **named)


def dataset(path, copybook: Optional[str] = None,
            copybook_contents=None, device=None,
            **options) -> CobolDataset:
    """Open mainframe file(s) as a pyarrow-dataset-shaped object.

    `path`/`copybook`/`device`/`options` follow ``read_cobol``; the returned
    dataset's schema is derived up front from the copybook + options
    (no data is read until a scanner materializes)."""
    from ..api import list_input_files, load_copybook_contents
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
    params = _parse_dataset_options(probe_options)
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
