"""Host IO: streaming chunked ingest with device prefetch (the port's
copy of ``transmogrifai_tpu/io``)."""
from .stream import (StreamCancelled, csv_chunks, csv_chunks_native,
                     double_buffer, fit_streaming, host_prefetch,
                     prefetch_to_device)

__all__ = ["StreamCancelled", "csv_chunks", "csv_chunks_native",
           "double_buffer", "fit_streaming", "host_prefetch",
           "prefetch_to_device"]
