"""The compute plane: stages, transfers and the hand-written CUDA kernels."""

from .stages import (Pipeline, Stage, decimate_stage, fft_stage, fir_fft_stage,
                     fir_stage, mag2_stage, quad_demod_stage, resample_stage,
                     rotator_stage, xlating_fir_stage)

__all__ = ["Pipeline", "Stage", "fir_stage", "fft_stage", "fir_fft_stage",
           "mag2_stage", "resample_stage", "rotator_stage", "quad_demod_stage",
           "xlating_fir_stage", "decimate_stage"]
