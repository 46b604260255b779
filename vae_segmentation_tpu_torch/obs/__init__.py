"""Observability (counterpart of vae_segmentation_tpu/obs/): the
TensorBoard ``Saver`` and its panels, the step-rate meter and the
profiler trace, the analysis figures."""
