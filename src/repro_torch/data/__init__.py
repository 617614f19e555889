"""Synthetic datasets, feature-packet streams and raw header traces (numpy,
seeded by an explicit generator)."""

from .packets import (RAW_HEADER_BYTES, RAW_KEY_BYTES, PacketGenConfig,
                      RawHeaderBatch, anomaly_dataset, encode_raw_headers,
                      flow_features, packet_stream, parse_raw_headers,
                      qos_dataset, raw_trace, validate_raw_rows)

__all__ = ["PacketGenConfig", "packet_stream", "flow_features",
           "anomaly_dataset", "qos_dataset", "RAW_HEADER_BYTES",
           "RAW_KEY_BYTES", "RawHeaderBatch", "encode_raw_headers",
           "parse_raw_headers", "validate_raw_rows", "raw_trace"]
