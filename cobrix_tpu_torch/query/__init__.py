"""Query pushdown: typed filter expressions and projection, pushed
through plan compilation and the device read.

Port of ``cobrix_tpu.query``, with its exports:

* ``col/lit`` + operator overloads, ``parse_filter`` — build a filter
  expression (``expr.Expr``), pass it (or its string form) as the
  ``filter=`` option of ``read_cobol``;
* ``dataset()`` — a ``pyarrow.dataset``-shaped scan surface whose
  scanner lowers pyarrow compute expressions into the same pushdown
  pipeline.

Pushdown depths:

1. **plan pruning** — the FieldPlan compiles only the selected fields;
2. **pre-decode record drop** — segment-id conjuncts evaluate against
   the records' raw segment ids; the other predicates run as a narrow
   stage-1 decode of ONLY the filter columns on the card, and dropped
   records never reach the full decode;
3. **late materialization** — filter-only columns decode for the
   predicate but are never assembled into the output table.
"""
from .expr import (  # noqa: F401
    And,
    Comparison,
    Expr,
    Field,
    IsIn,
    Literal,
    Not,
    Or,
    SegmentIs,
    col,
    lit,
    normalize_filter,
    parse_filter,
    segment_is,
)
from .dataset import CobolDataset, CobolFragment, CobolScanner, dataset  # noqa: F401
