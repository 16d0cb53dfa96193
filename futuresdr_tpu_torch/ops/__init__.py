"""The compute plane: stages, transfers and the hand-written CUDA kernels."""

from .stages import (Pipeline, Stage, fft_stage, fir_fft_stage, fir_stage,
                     mag2_stage)

__all__ = ["Pipeline", "Stage", "fir_stage", "fft_stage", "fir_fft_stage",
           "mag2_stage"]
