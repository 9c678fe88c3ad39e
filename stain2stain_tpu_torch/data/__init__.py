"""Data pipeline of the port (counterparts of ``stain2stain_tpu/data``):
host decode → device-side normalization and paired augmentation."""

from .base import DataLoader, DataModule, Dataset, default_collate
from .class_conditional import ClassConditionalAnyToAnyDataModule, PairedAnyToAnyDataset
from .paired_data_module import PairedDataModule, PairedDataset

__all__ = [
    "Dataset",
    "DataLoader",
    "DataModule",
    "default_collate",
    "PairedDataset",
    "PairedDataModule",
    "PairedAnyToAnyDataset",
    "ClassConditionalAnyToAnyDataModule",
]
