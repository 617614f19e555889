"""Synthetic datasets (numpy, seeded by an explicit generator)."""

from .packets import anomaly_dataset, flow_features, qos_dataset

__all__ = ["flow_features", "anomaly_dataset", "qos_dataset"]
