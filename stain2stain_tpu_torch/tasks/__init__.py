"""Task modules of the port (counterparts of ``stain2stain_tpu/tasks``)."""

from .base import FlowMatchingTask
from .class_conditional_flow_matching import ClassConditionalFlowMatchingModule
from .conditional_flow_matching import ConditionalFlowMatchingModule

__all__ = ["FlowMatchingTask", "ConditionalFlowMatchingModule", "ClassConditionalFlowMatchingModule"]
