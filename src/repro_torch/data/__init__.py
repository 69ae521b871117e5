"""Training data (the reference's ``repro.data``): labelled DAGs and the
synthetic LM token stream."""

from .dags import LabeledDagDataset
from .tokens import TokenStream, make_batch_iterator

__all__ = ["LabeledDagDataset", "TokenStream", "make_batch_iterator"]
