"""The compute plane: stages, transfers and the hand-written CUDA kernels."""

from .stages import (DagPipeline, FanoutPipeline, MergeStage, Pipeline, Stage,
                     add_merge_stage, agc_stage, apply_merge_stage, apply_stage,
                     channelizer_stage, concat_merge_stage, interleave_merge_stage,
                     decimate_stage, fft_stage, fftshift_stage, fir_fft_stage,
                     fir_stage, log10_stage, lora_demod_stage, mag2_stage,
                     moving_avg_stage, quad_demod_stage, resample_stage,
                     rotator_stage, xlating_fir_stage)

__all__ = ["Pipeline", "Stage", "FanoutPipeline", "DagPipeline", "MergeStage",
           "apply_merge_stage", "add_merge_stage", "interleave_merge_stage",
           "concat_merge_stage", "fir_stage", "fft_stage", "fir_fft_stage",
           "mag2_stage", "resample_stage", "rotator_stage", "quad_demod_stage",
           "xlating_fir_stage", "decimate_stage", "fftshift_stage", "log10_stage",
           "apply_stage", "channelizer_stage", "moving_avg_stage", "agc_stage",
           "lora_demod_stage"]
