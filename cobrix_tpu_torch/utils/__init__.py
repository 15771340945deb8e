"""Utility helpers: schema/data flattening and file scanning
(equivalents of the reference's SparkUtils / FileUtils)."""
from .flatten import convert_fields_to_strings, flatten_schema
from .file_utils import (
    find_non_divisible_files,
    get_number_of_files,
    list_input_files,
    total_size,
)

__all__ = [
    "convert_fields_to_strings",
    "flatten_schema",
    "find_non_divisible_files",
    "get_number_of_files",
    "list_input_files",
    "total_size",
]
