"""Tensor ops of the port (counterparts of ``stain2stain_tpu/ops``)."""
