"""Typed data readers (the port's copy of
``transmogrifai_tpu/readers/__init__.py``).

Reference: readers/src/main/scala/com/salesforce/op/readers/ — the
`DataReaders` factory plus `DataReader[T]`, `CSVProductReader`,
`CSVAutoReader` (schema inference), `AggregateDataReader` (event rows ->
one row per key via monoid aggregation with a time cutoff),
`ConditionalDataReader` (per-key target time from a predicate), and
`JoinedDataReader` (key joins across readers).

TPU-first design: readers are host-side record producers; a reader's
`generate_dataset(raw_features)` applies each raw feature's extract fn
(and, for aggregate readers, its monoid) to produce the columnar
`Dataset` whose numeric blocks get shipped to the device. There is no
Spark: records are plain dicts/objects in memory or streamed from CSV.
"""
from .core import (AggregateDataReader, ConditionalDataReader,
                   CSVAutoReader, CSVProductReader, DataReader, DataReaders,
                   JoinedDataReader, infer_csv_schema)
from .formats import (AvroReader, ParquetAutoReader, ParquetProductReader,
                      infer_avro_schema, infer_parquet_schema, read_avro,
                      write_avro)

__all__ = [
    "DataReader", "DataReaders", "CSVProductReader", "CSVAutoReader",
    "AggregateDataReader", "ConditionalDataReader", "JoinedDataReader",
    "infer_csv_schema", "ParquetProductReader", "ParquetAutoReader",
    "AvroReader", "infer_parquet_schema", "infer_avro_schema",
    "read_avro", "write_avro",
]
