"""Data pipeline of the port (counterparts of ``stain2stain_tpu/data``):
host decode → device-side normalization and paired augmentation."""

from .base import ConcatDataset, DataLoader, DataModule, Dataset, default_collate
from .class_conditional import ClassConditionalAnyToAnyDataModule, PairedAnyToAnyDataset
from .paired_data_mask import PairedHEIHCDataModule, PairedHEIHCDataset, load_mask_binary
from .paired_data_module import PairedDataModule, PairedDataset
from .paired_pos_neg import NegativePairedDataset, PairedPosNegDataModule

__all__ = [
    "Dataset",
    "ConcatDataset",
    "DataLoader",
    "DataModule",
    "default_collate",
    "PairedDataset",
    "PairedDataModule",
    "PairedHEIHCDataset",
    "PairedHEIHCDataModule",
    "load_mask_binary",
    "NegativePairedDataset",
    "PairedPosNegDataModule",
    "PairedAnyToAnyDataset",
    "ClassConditionalAnyToAnyDataModule",
]
