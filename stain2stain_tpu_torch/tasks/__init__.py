"""Task modules of the port (counterparts of ``stain2stain_tpu/tasks``)."""

from .base import FlowMatchingTask, TaskModule
from .class_conditional_flow_matching import ClassConditionalFlowMatchingModule
from .conditional_flow_matching import ConditionalFlowMatchingModule
from .conditional_flow_matching_aux_fraction import AuxFractionFlowMatchingModule
from .conditional_flow_matching_conditional_mask import MaskConditionedFlowMatchingModule
from .conditional_flow_matching_masked import MaskedFlowMatchingModule
from .conditional_flow_matching_roi_loss import ROICharbonnierFlowMatchingModule
from .conditional_flow_matching_toggle_mask import ToggleMaskFlowMatchingModule
from .mnist import MNISTLitModule
from .multitask import MultitaskFlowMatchingModule, MultitaskNet, SharedBackboneTask
from .multitask_multiclass import MultitaskMulticlassFlowMatchingModule

__all__ = [
    "TaskModule",
    "FlowMatchingTask",
    "ConditionalFlowMatchingModule",
    "ClassConditionalFlowMatchingModule",
    "MaskedFlowMatchingModule",
    "ROICharbonnierFlowMatchingModule",
    "MaskConditionedFlowMatchingModule",
    "ToggleMaskFlowMatchingModule",
    "AuxFractionFlowMatchingModule",
    "SharedBackboneTask",
    "MultitaskNet",
    "MultitaskFlowMatchingModule",
    "MultitaskMulticlassFlowMatchingModule",
    "MNISTLitModule",
]
