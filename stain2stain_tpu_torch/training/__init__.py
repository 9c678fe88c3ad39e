"""Training harness of the port (counterpart of ``stain2stain_tpu/training``):
Trainer, callbacks, loggers, optimizers, train state and checkpoints."""

from .callbacks import (
    Callback,
    EarlyStopping,
    ImageLogger,
    LearningRateMonitor,
    ModelCheckpoint,
    ModelSummary,
    ProgressBar,
    RichModelSummary,
    RichProgressBar,
)
from .loggers import (
    AimLogger,
    CometLogger,
    CSVLogger,
    FileLogger,
    Logger,
    MLFlowLogger,
    NeptuneLogger,
    TensorBoardLogger,
    WandbLogger,
)
from .optim import SGD, Adam, AdamW, ReduceLROnPlateau
from .state import CheckpointIO, TrainState
from .trainer import Trainer

__all__ = [
    "Trainer",
    "TrainState",
    "CheckpointIO",
    "Callback",
    "ModelCheckpoint",
    "EarlyStopping",
    "ModelSummary",
    "RichModelSummary",
    "ProgressBar",
    "RichProgressBar",
    "LearningRateMonitor",
    "ImageLogger",
    "Logger",
    "CSVLogger",
    "FileLogger",
    "TensorBoardLogger",
    "WandbLogger",
    "MLFlowLogger",
    "NeptuneLogger",
    "CometLogger",
    "AimLogger",
    "Adam",
    "AdamW",
    "SGD",
    "ReduceLROnPlateau",
]
