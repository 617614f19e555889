"""Synthetic datasets, feature-packet streams and raw header traces (numpy,
seeded by an explicit generator), and the synthetic LM token stream."""

from . import packets, tokens
from .packets import (RAW_HEADER_BYTES, RAW_KEY_BYTES, PacketGenConfig,
                      RawHeaderBatch, anomaly_dataset, encode_raw_headers,
                      flow_features, packet_stream, parse_raw_headers,
                      qos_dataset, raw_trace, validate_raw_rows)
from .tokens import TokenStream, TokenStreamConfig

__all__ = ["packets", "tokens", "TokenStream", "TokenStreamConfig",
           "PacketGenConfig", "packet_stream", "flow_features",
           "anomaly_dataset", "qos_dataset", "RAW_HEADER_BYTES",
           "RAW_KEY_BYTES", "RawHeaderBatch", "encode_raw_headers",
           "parse_raw_headers", "validate_raw_rows", "raw_trace"]
