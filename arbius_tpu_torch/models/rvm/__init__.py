"""Robust Video Matting family: the published RVM recurrent matting
network (templates/data/robust_video_matting.json), in PyTorch,
single-device and bf16 only, and its checkpoint converter
(convert.py)."""
from arbius_tpu_torch.models.rvm.convert import convert_rvm, rvm_key_for
from arbius_tpu_torch.models.rvm.model import (
    MOBILENETV3_LARGE_ROWS,
    ConvGRU,
    MattingStep,
    RVMConfig,
)
from arbius_tpu_torch.models.rvm.pipeline import (
    OUTPUT_TYPES,
    RVMPipeline,
    RVMPipelineConfig,
)

__all__ = ["ConvGRU", "MOBILENETV3_LARGE_ROWS", "MattingStep",
           "OUTPUT_TYPES", "RVMConfig", "RVMPipeline", "RVMPipelineConfig",
           "convert_rvm", "rvm_key_for"]
