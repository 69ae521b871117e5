"""Labelled training data (the reference's ``repro.data``, DAG part)."""

from .dags import LabeledDagDataset

__all__ = ["LabeledDagDataset"]
